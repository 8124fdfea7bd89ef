"""Training GraphGPS on one's own assay data: the program's ``Trainer`` with
the preset ``graphgps_medium`` (GPS-medium) on the bundled training
split, featurised by the program at set-up with its bond types and
random-walk encoding, whole epochs of ``Trainer.train_epoch`` then
``Trainer.evaluate`` on the validation split, as ``drivers/
train_graphormer.py`` runs Graphormer's, with no checkpoint writes.

Set-up builds the training state from the seeded weights
(``harness/weights_gps.py``, the batch norms' running statistics
included) and runs epoch 0 through ``train_epoch`` itself, under spies
that read the first steps' losses, the first gradient as the optimizer
took it and the parameters' change over the first step (those of
``drivers/train.py``, where a parameter that takes no gradient, the last
layer's edge norm, reads zero).  The window runs epochs 1, 2, ... back to
back and ends with the first epoch (with its validation) that ends
``--seconds`` or more after its start; ``train_mol_per_s`` is the
training molecules of its epochs over it.

After the window the reference (``reference/gps.py``, f32 with TF32 off)
featurises the same SMILES itself and runs the first steps on the
trainer's batches and dropout masks of epoch 0, each step's batch whole
(its batch norms couple the batch's molecules), and :func:`numbers`
compares the two: ``check.train_numbers`` over the parameters whose
reference gradient is at least a hundredth of the median parameter's, and
the first gradient's elements over them (``grad_l2_gap``).
:func:`reference_steps` also gives the calibration's controls
(``calibrate_gps.py``).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ...reference import gps as ref
from ...reference import model as ref_model
from ..check import (
    _norms,
    dropout_seed,
    epoch_rows,
    fit_scaler,
    load_csv,
    train_numbers,
)
from ..runner import Check, Outcome
from ..traffic import seed_for
from ..weights_gps import is_buffer, make_weights
from .common import free_device

# a parameter whose reference gradient is under this share of the median
# parameter's is left out of the comparison, and one whose reference's
# first step is under this share of a whole step out of the change's
# (numbers)
CANCELLED = 1e-2
PARTIAL_STEP = 0.5
# the program's config fields -> the configuration's model group
WIDTHS = {"n_layers": "num_hidden_layers", "hidden_dim": "hidden_size",
          "ffn_dim": "ffn_hidden_size", "n_heads": "num_attention_heads",
          "attention_dropout": "attention_dropout",
          "graph_dropout": "dropout"}


def _check_preset(cfg, conf) -> None:
    """The preset is the configuration the reference runs."""
    model, train = conf["model"], conf["train"]
    pairs = [(getattr(cfg, k), model[v]) for k, v in WIDTHS.items()] + [
        (getattr(cfg, k), train[k]) for k in (
            "batch_size", "eval_batch_size", "lr", "lr_schedule",
            "warmup_steps", "lr_final_ratio", "epochs", "weight_decay")]
    if any(a != b for a, b in pairs) or cfg.model != "gps" or (
            cfg.compute_dtype != "bfloat16" and conf["numerics"] == "bf16"):
        raise ValueError(f"preset {cfg.name!r} is not the configuration "
                         f"{conf['preset']!r}")


def _first_steps(trainer, state, w, steps: int):
    """``drivers/train.py::_first_steps``'s spies for a model with
    parameters that take no gradient: install them; return the function
    that removes them and gives the first ``steps`` losses, each
    parameter's first gradient (``grads``, zero where it took none) and
    the norms of it and of its change over the first step (``w``: the
    weights before it)."""
    rec = {"losses": []}
    model, opt = state.model, state.optimizer
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    b1 = opt.param_groups[0]["betas"][0]
    orig_step, orig_train_step = opt.step, trainer.train_step

    def norms(ts):
        return torch.stack([torch.linalg.vector_norm(t.double()) for t in ts])

    def opt_step(*a, **kw):
        out = orig_step(*a, **kw)
        if "grad" not in rec:
            rec["grads"] = {n: (opt.state[p]["exp_avg"] / (1.0 - b1)).float()
                            if opt.state[p] else torch.zeros_like(p)
                            for n, p in zip(names, params)}
            rec["grad"] = norms(rec["grads"].values())
            rec["change"] = norms([p.detach().float() - w[n]
                                   for n, p in zip(names, params)])
        return out

    def train_step(*a, **kw):
        out = orig_train_step(*a, **kw)
        if len(rec["losses"]) < steps:
            rec["losses"].append(out["loss"])
        return out

    opt.step = opt_step
    trainer.train_step = train_step

    def remove():
        del opt.step
        del trainer.train_step
        return {"losses": [float(x) for x in rec["losses"]],
                "grads": rec["grads"],
                "grad": dict(zip(names, rec["grad"].tolist())),
                "change": dict(zip(names, rec["change"].tolist()))}

    return remove


def numbers(got: Dict, want: Dict, leaves: bool = False) -> Dict:
    """``check.train_numbers`` of ``got`` against ``want`` over the
    parameters whose reference gradient is at least :data:`CANCELLED` of
    the median parameter's, and its ``change_gap`` and
    ``change_gap_median`` over those of them that the reference's first
    step moved by at least :data:`PARTIAL_STEP` of a whole step
    (``want["step"]``); with ``leaves``, ``cancelled`` and
    ``partial_step`` list the parameters left out of each.  Beside them
    ``grad_l2_gap``: :func:`_l2_gap` of the first gradient's elements over
    the compared parameters.  It is a sum of squares over 19M elements,
    where the loss and a leaf's norm are sums in which the rounding errors
    of the rows or of the elements cancel, so it alone parts the program
    from the e4m3 control on every seed (PERF.md).

    In GraphGPS those are the gradients the architecture cancels, whose
    values are the residue of a sum that cancels: the A and B biases of
    each GatedGCN, added to every atom just before ``BN_x``, which removes
    any per-feature shift (B's up to the ``1e-6`` of the gates'
    denominator and the atoms without a bond), the key projection's bias,
    which the softmax ignores, and the last layer's edge norm, which
    reaches no output.  On the chip they read up to 6.6e-3 of the median,
    every other parameter 2.3e-2 or more (PERF.md).  In bf16 such a
    residue is rounding of a row's gradient times ~``2^-9 sqrt(rows)``,
    far above the f32 value, and Adam's first step turns it into a whole
    step of ``lr`` where the reference's stays under Adam's ``eps``: it
    compares nothing but rounding (``check.py`` leaves out the leaves
    under a thousandth of the median for the change alike).

    A whole first step moves each element by ``lr``, ``lr sqrt(n)`` for a
    parameter of ``n``.  One that the reference moves by less than half
    that has its elements' gradients at Adam's ``eps`` (1e-8), where the
    step follows the gradient's size: GatedGCN's B biases of the last
    layers, where an ion's atoms keep a gradient a little above the
    cancelled ones', read 0.23 to 0.33 of a step in the reference and a
    whole one in the program; or its values at 1.0, where a step of 6e-9
    is under half the f32 spacing and rounds away on both sides (every
    batch norm's scale).  Their change compares rounding too."""
    keys = list(want["raw"])
    med = float(np.median([want["raw"][k] for k in keys]))
    grad = [k for k in keys if want["raw"][k] >= CANCELLED * med]
    step = want["step"]
    change = [k for k in grad
              if want["change"][k] >= PARTIAL_STEP * step[k]]

    def part(d, keep):
        return {**d, **{name: {k: d[name][k] for k in keep}
                        for name in ("grad", "raw", "change") if name in d}}

    out = train_numbers(part(got, grad), part(want, grad), leaves)
    moved = train_numbers(part(got, change), part(want, change), leaves)
    for name in ("change_gap", "change_gap_median") + (
            ("change_leaf",) if leaves else ()):
        out[name] = moved[name]
    out["grad_l2_gap"] = _l2_gap([got["grads"][k] for k in grad],
                                 [want["grads"][k] for k in grad])
    if leaves:
        out["cancelled"] = sorted(set(keys) - set(grad))
        out["partial_step"] = sorted(set(grad) - set(change))
    return out


def _l2_gap(got, want) -> float:
    """``|got - want| / |want|``, the 2-norms over every element of the
    tensors ``got`` and ``want`` (in pairs)."""
    num = den = 0.0
    for a, b in zip(got, want):
        a, b = a.double(), b.double().to(a.device)
        num += float((a - b).square().sum())
        den += float(b.square().sum())
    return (num / den) ** 0.5 if den > 0 else float("inf")


def _counts():
    """The program's attention and gated message counters, or {} where it
    keeps none (a program without GraphGPS)."""
    try:
        from mgat_graphsage_torch.ops import biased_attention, gated_message
    except ImportError:
        return {}
    return {"attention": biased_attention.counts(),
            "gated_message": gated_message.counts()}


def run(ctx) -> Outcome:
    from mgat_graphsage_torch.data import MolecularDataset
    from mgat_graphsage_torch.models import build_model
    from mgat_graphsage_torch.train import Trainer, get_config
    from mgat_graphsage_torch.train.optim import make_optimizer
    from mgat_graphsage_torch.train.trainer import TrainState

    tr, conf = ctx.traffic, ctx.config
    cfg = get_config(conf["preset"], seed=ctx.seed)
    _check_preset(cfg, conf)
    n_nodes, n_edges = conf["budget"]
    steps = int(tr["check_steps"])
    smiles, y = load_csv(tr["train_csv"])
    vsmiles, vy = load_csv(tr["val_csv"])
    if tr.get("rows"):      # a smaller run of the same mix (tests)
        (smiles, y), (vsmiles, vy) = ((a[:n], b[:n]) for (a, b), n in zip(
            ((smiles, y), (vsmiles, vy)), tr["rows"]))
    with ctx.phase("featurize"):
        kw = dict(fingerprint=None, featurizer=cfg.featurizer,
                  max_nodes=n_nodes, max_edges=n_edges, structure="edges",
                  verbose=False)
        train_ds = MolecularDataset(smiles, y, fit_scaler=cfg.scale_targets,
                                    **kw)
        val_ds = MolecularDataset(vsmiles, vy, scaler=train_ds.scaler, **kw)
    with ctx.phase("weights"):
        w = make_weights(conf["model"], seed_for(ctx.seed, "weights"),
                         ctx.device)
    with ctx.phase("model"):
        with torch.device("meta"):
            model = build_model(cfg)
        model.to_empty(device=ctx.device)
        model.load_state_dict(w)
    with ctx.phase("optimizer"):
        state = TrainState(step=0, model=model,
                           optimizer=make_optimizer(cfg, model))
    with ctx.phase("trainer"):
        trainer = Trainer(cfg, train_ds, val_ds, device=str(ctx.device))
    with ctx.phase("first_epoch"):
        remove = _first_steps(trainer, state, w, steps)
        state, _ = trainer.train_epoch(state, 0)
        got = remove()
        del w
    with ctx.phase("warmup"):
        trainer.evaluate(state)

    n_steps = -(-len(train_ds) // cfg.batch_size)
    n_eval = -(-len(val_ds) // cfg.eval_batch_size)
    epochs = 0
    starts = []
    before = _counts()
    t0 = ctx.window_started()
    while True:
        starts.append(time.perf_counter())
        with ctx.tracer.span("train_epoch"):
            state, _ = trainer.train_epoch(state, epochs + 1)
        with ctx.tracer.span("evaluate"):
            trainer.evaluate(state)
        epochs += 1
        t = time.perf_counter()
        if ctx.tracer.active and ctx.tracer.due():
            ctx.tracer.stop()
        if t - t0 >= ctx.seconds:
            break
    window = t - t0
    ctx.tracer.stop()
    after = _counts()
    peak = ctx.memory_peak()
    del trainer, state, model
    free_device(ctx)
    # the per-layer readers' counts: the untraced part of the window
    own = sum(ctx.tracer.untraced(s) for s in starts)
    counters = {"window_s": t - (ctx.tracer.t_resume or t0), "epochs": own,
                "train_rows": own * n_steps * cfg.batch_size,
                "eval_rows": own * n_eval * cfg.eval_batch_size}
    # the window's attention calls by path and gated message calls, edges
    # and edge slots (the whole window, traced part included)
    for kind in after:
        counters[kind] = {k: after[kind][k] - before[kind][k]
                          for k in after[kind]}

    want = reference_steps(ctx, smiles, y, steps)
    nums = numbers(got, want, leaves=True)
    checks = [Check(k, nums[k], ctx.limit(k)) for k in ctx.limits]
    ctx.log("numbers", nums)
    ctx.log("losses program " + " ".join(f"{v:.7g}" for v in got["losses"])
            + " | reference " + " ".join(f"{v:.7g}" for v in want["losses"]))
    counters["numbers"] = nums
    return Outcome(
        metrics={"train_mol_per_s": epochs * len(train_ds) / window},
        attempted=epochs, failed=0, checks=checks, memory_peak_bytes=peak,
        counters=counters)


def reference_steps(ctx, smiles, targets, steps: int,
                    round_to: Optional[str] = None,
                    fault: Optional[str] = None) -> Dict:
    """The reference's first ``steps`` training steps from the seeded
    weights, on the trainer's batches and dropout masks of epoch 0: the
    ``losses``, the first gradient (``grads``, as Adam took it), and the
    norms of each
    parameter's first gradient (``grad``, ``raw``) and of its change over
    the first step (``change``), as ``check.reference_train`` gives them, and of a whole
    first step of Adam (``step``: ``lr sqrt(n)`` for ``n`` elements).
    ``round_to="fp8"`` rounds every operand of every product to e4m3 (the
    control); ``fault="half"`` leaves out half of each batch."""
    conf, train = ctx.config, ctx.config["train"]
    m = conf["model"]
    n_nodes, n_edges = conf["budget"]
    heads, p, p_attn = m["num_attention_heads"], m["dropout"], \
        m["attention_dropout"]
    q = ref_model._round_e4m3 if round_to == "fp8" else None
    kept, mols = ref.parse_kept(smiles, n_nodes, n_edges)
    y = np.asarray(targets, np.float32)[kept]
    mean, scale = fit_scaler(y)
    yn = ((y - mean) / scale).astype(np.float32)
    b = train["batch_size"]
    rows, smask = epoch_rows(len(y), b, ctx.seed)
    dev = ctx.device
    weights = make_weights(m, seed_for(ctx.seed, "weights"), dev)
    master = {k: v for k, v in weights.items() if not is_buffer(k)}
    p0 = {k: v.clone() for k, v in master.items()}
    adam = ref.Adam(master, train["weight_decay"])
    gen = torch.Generator(device=dev).manual_seed(dropout_seed(ctx.seed, 0))
    total = train["epochs"] * rows.shape[0]
    out = {"losses": []}
    for step in range(steps):
        masks = ref.draw_masks(gen, b, n_nodes, n_edges, m["hidden_size"],
                               heads, m["ffn_hidden_size"],
                               m["num_hidden_layers"], p, p_attn, dev)
        sel, sm = rows[step], smask[step].copy()
        if fault == "half":
            sm[len(sm) // 2:] = 0.0
        real = [r for r in range(b) if sm[r] > 0]
        g = ref.collate([mols[sel[r]] for r in real], real, n_nodes,
                        n_edges, dev)
        target = torch.from_numpy(yn[sel[real]]).to(dev)
        with ref.ieee_flags():
            loss, grads = ref.train_step({**weights, **master}, g, target,
                                         heads, masks, p, p_attn, q)
        del masks, g
        lr = ref_model.lr_at(step + 1, train["lr"], train["lr_schedule"],
                             train["warmup_steps"], train["lr_final_ratio"],
                             total)
        seen = adam.step(grads, lr)
        out["losses"].append(loss.item())
        if step == 0:
            out["grads"] = seen
            out["grad"] = _norms(seen)
            out["raw"] = _norms(grads)
            out["change"] = _norms({k: master[k] - p0[k] for k in master})
            out["step"] = {k: lr * v.numel() ** 0.5
                           for k, v in master.items()}
    return out
