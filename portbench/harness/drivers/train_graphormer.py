"""Training a graph transformer on one's own assay data: the program's
``Trainer`` with the preset ``graphormer_base`` (Graphormer-Base) on the
bundled training split, featurised by the program at set-up with its
structure (shortest-path distances and path bond types), whole epochs of
``Trainer.train_epoch`` then ``Trainer.evaluate`` on the validation
split, as ``drivers/train.py`` runs the hybrid's, with no checkpoint
writes.

Set-up builds the training state from the seeded weights
(``harness/weights_graphormer.py``) and runs epoch 0 through
``train_epoch`` itself, under ``drivers/train.py``'s spies, which read
the first steps' losses, the first gradient as the optimizer took it and
the parameters' change over the first step.  The window runs epochs 1,
2, ... back to back and ends with the first epoch (with its validation)
that ends ``--seconds`` or more after its start; ``train_mol_per_s`` is
the training molecules of its epochs over it.

After the window the reference (``reference/graphormer.py``, f32 with
TF32 off) featurises the same SMILES itself and runs the first steps on
the trainer's batches and dropout masks of epoch 0, in blocks of
``reference_block`` rows with the gradients summed, and the checks of
``check.train_checks`` compare the two.  :func:`reference_steps` also
gives the calibration's controls (``calibrate_graphormer.py``).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ...reference import graphormer as ref
from ...reference import model as ref_model
from ..check import (
    _norms,
    dropout_seed,
    epoch_rows,
    fit_scaler,
    load_csv,
    train_checks,
    train_numbers,
)
from ..runner import Outcome
from ..traffic import seed_for
from ..weights_graphormer import make_weights
from .common import free_device
from .train import _first_steps

# the program's config fields -> the configuration's model group
WIDTHS = {"n_layers": "num_hidden_layers", "hidden_dim": "hidden_size",
          "ffn_dim": "ffn_hidden_size", "n_heads": "num_attention_heads",
          "attention_dropout": "attention_dropout",
          "graph_dropout": "act_dropout"}


def _check_preset(cfg, conf) -> None:
    """The preset is the configuration the reference runs."""
    model, train = conf["model"], conf["train"]
    pairs = [(getattr(cfg, k), model[v]) for k, v in WIDTHS.items()] + [
        (getattr(cfg, k), train[k]) for k in (
            "batch_size", "eval_batch_size", "lr", "lr_schedule",
            "warmup_steps", "lr_final_ratio", "epochs", "weight_decay")]
    if any(a != b for a, b in pairs) or (
            cfg.compute_dtype != "bfloat16" and conf["numerics"] == "bf16"):
        raise ValueError(f"preset {cfg.name!r} is not the configuration "
                         f"{conf['preset']!r}")


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
                  max_nodes=n_nodes, max_edges=n_edges, structure=True,
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
    peak = ctx.memory_peak()
    del trainer, state, model
    free_device(ctx)
    # the per-layer readers' counts: the untraced part of the window
    own = sum(ctx.tracer.untraced(s) for s in starts)
    counters = {"window_s": t - (ctx.tracer.t_resume or t0), "epochs": own,
                "train_rows": own * n_steps * cfg.batch_size,
                "eval_rows": own * n_eval * cfg.eval_batch_size}

    want = reference_steps(ctx, smiles, y, steps)
    checks = train_checks(ctx, got, want)
    numbers = train_numbers(got, want, leaves=True)
    ctx.log("numbers", numbers)
    ctx.log("losses program " + " ".join(f"{v:.7g}" for v in got["losses"])
            + " | reference " + " ".join(f"{v:.7g}" for v in want["losses"]))
    counters["numbers"] = numbers
    return Outcome(
        metrics={"train_mol_per_s": epochs * len(train_ds) / window},
        attempted=epochs, failed=0, checks=checks, memory_peak_bytes=peak,
        counters=counters)


def reference_steps(ctx, smiles, targets, steps: int,
                    round_to: Optional[str] = None,
                    fault: Optional[str] = None) -> Dict:
    """The reference's first ``steps`` training steps from the seeded
    weights, on the trainer's batches and dropout masks of epoch 0: the
    ``losses``, and the norms of each leaf's first gradient (``grad``,
    ``raw``) and of its change over the first step (``change``), as
    ``check.reference_train`` gives them.  ``round_to="fp8"`` rounds every
    operand of every product to e4m3 (the control); ``fault="half"``
    leaves out half of each batch."""
    conf, train, tr = ctx.config, ctx.config["train"], ctx.traffic
    m = conf["model"]
    n_nodes, n_edges = conf["budget"]
    heads, hops = m["num_attention_heads"], m["multi_hop_max_dist"]
    p_attn, p_ffn = m["attention_dropout"], m["act_dropout"]
    q = ref_model._round_e4m3 if round_to == "fp8" else None
    kept, mols = ref.parse_kept(smiles, n_nodes, n_edges)
    y = np.asarray(targets, np.float32)[kept]
    mean, scale = fit_scaler(y)
    yn = ((y - mean) / scale).astype(np.float32)
    b = train["batch_size"]
    rows, smask = epoch_rows(len(y), b, ctx.seed)
    dev = ctx.device
    master = make_weights(m, seed_for(ctx.seed, "weights"), dev)
    p0 = {k: v.clone() for k, v in master.items()}
    adam = ref.Adam(master, train["weight_decay"])
    gen = torch.Generator(device=dev).manual_seed(dropout_seed(ctx.seed, 0))
    block = int(tr.get("reference_block", b))
    total = train["epochs"] * rows.shape[0]
    out = {"losses": []}
    for step in range(steps):
        masks = ref.draw_masks(gen, b, n_nodes, heads, m["ffn_hidden_size"],
                               m["num_hidden_layers"], p_attn, p_ffn, dev)
        sel, sm = rows[step], smask[step].copy()
        if fault == "half":
            sm[len(sm) // 2:] = 0.0
        smd = torch.from_numpy(sm).to(dev)
        count = torch.clamp_min(smd.sum(), 1.0)
        loss = torch.zeros((), device=dev)
        grads = {k: torch.zeros_like(v) for k, v in master.items()}
        for lo in range(0, b, block):
            hi = min(lo + block, b)
            a = ref.arrays([mols[i] for i in sel[lo:hi]], n_nodes, hops)
            inputs = dict(zip(("nodes", "node_mask", "degree", "spd",
                               "path_types"),
                              (torch.from_numpy(x).to(dev) for x in a)))
            inputs["node_mask"] = inputs["node_mask"] * smd[lo:hi, None]
            leaves = {k: v.detach().clone().requires_grad_(True)
                      for k, v in master.items()}
            with ref.ieee_flags():
                pred = ref.forward(
                    leaves, inputs["nodes"], inputs["node_mask"],
                    inputs["degree"], inputs["spd"], inputs["path_types"],
                    heads, [(ka[lo:hi], kf[lo:hi]) for ka, kf in masks],
                    p_attn, p_ffn, q)
                target = torch.from_numpy(yn[sel[lo:hi]]).to(dev)
                part = (((pred - target) ** 2) * smd[lo:hi]).sum() / count
                g = torch.autograd.grad(part, list(leaves.values()))
            loss = loss + part.detach()
            for k, gk in zip(leaves, g):
                grads[k] += gk
            del leaves, pred, g
        del masks
        lr = ref_model.lr_at(step + 1, train["lr"], train["lr_schedule"],
                             train["warmup_steps"], train["lr_final_ratio"],
                             total)
        seen = adam.step(grads, lr)
        out["losses"].append(loss.item())
        if step == 0:
            out["grad"] = _norms(seen)
            out["raw"] = _norms(grads)
            out["change"] = _norms({k: master[k] - p0[k] for k in master})
    return out
