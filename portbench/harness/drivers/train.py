"""Training on one's own assay data: the program's ``Trainer`` on the
bundled training split (featurised by the program at set-up), whole
epochs of ``Trainer.train_epoch`` then ``Trainer.evaluate`` on the
validation split, as ``Trainer.fit`` runs each epoch, with no checkpoint
writes.

Set-up builds the training state from the seeded weights and runs epoch 0
through ``train_epoch`` itself, the window's own call and feed; spies on
``train_step`` and on the optimizer's ``step`` record the first steps'
losses, the first gradient as the optimizer took it (from its first
moment after one step) and the parameters' change over that step, and are removed before the window.  The window runs epochs 1, 2,
... back to back from its start and ends with the first epoch (with its
validation) that ends ``--seconds`` or more after it.
``train_mol_per_s`` is the training molecules of its epochs over it.
"""

from __future__ import annotations

import time

import torch

from ..check import load_csv, reference_train, train_checks, train_numbers
from ..runner import Outcome
from ..traffic import seed_for
from ..weights import make_weights
from .common import free_device


def _first_steps(trainer, state, w, steps: int):
    """Install the spies; return the function that removes them and gives
    what they read: the first ``steps`` losses, and each leaf's norm of
    the first gradient and of the change over the first step (``w``: the
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
            rec["grad"] = norms([opt.state[p]["exp_avg"] for p in params]) \
                / (1.0 - b1)
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
                "grad": dict(zip(names, rec["grad"].tolist())),
                "change": dict(zip(names, rec["change"].tolist()))}

    return remove


def run(ctx) -> Outcome:
    from mgat_graphsage_torch.data import MolecularDataset
    from mgat_graphsage_torch.models import build_model
    from mgat_graphsage_torch.train import Trainer, get_config
    from mgat_graphsage_torch.train.optim import make_optimizer
    from mgat_graphsage_torch.train.trainer import TrainState

    tr, conf = ctx.traffic, ctx.config
    cfg = get_config(conf["preset"], seed=ctx.seed)
    steps = int(tr["check_steps"])
    smiles, y = load_csv(tr["train_csv"])
    vsmiles, vy = load_csv(tr["val_csv"])
    if tr.get("rows"):      # a smaller run of the same mix (tests)
        (smiles, y), (vsmiles, vy) = ((a[:n], b[:n]) for (a, b), n in zip(
            ((smiles, y), (vsmiles, vy)), tr["rows"]))
    with ctx.phase("featurize"):
        train_ds = MolecularDataset(smiles, y, fit_scaler=cfg.scale_targets,
                                    fingerprint=cfg.fingerprint,
                                    featurizer=cfg.featurizer, verbose=False)
        val_ds = MolecularDataset(vsmiles, vy, scaler=train_ds.scaler,
                                  fingerprint=cfg.fingerprint,
                                  featurizer=cfg.featurizer,
                                  max_nodes=train_ds.max_nodes,
                                  max_edges=train_ds.max_edges,
                                  verbose=False)
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
    epochs = traced_epochs = 0
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
        if ctx.tracer.active:
            traced_epochs += 1
            if ctx.tracer.due():
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
    bt, be = cfg.batch_size, cfg.eval_batch_size
    counters = {"window_s": t - (ctx.tracer.t_resume or t0), "epochs": own,
                "train_rows": own * n_steps * bt,
                "eval_rows": own * n_eval * be}

    want = reference_train(ctx, smiles, y, steps)
    checks = train_checks(ctx, got, want)
    numbers = train_numbers(got, want, leaves=True)
    ctx.log("numbers", numbers)
    ctx.log("losses program " + " ".join(f"{v:.7g}" for v in got["losses"])
            + " | reference " + " ".join(f"{v:.7g}" for v in want["losses"]))
    counters["numbers"] = numbers
    return Outcome(
        metrics={"train_mol_per_s": epochs * len(train_ds) / window},
        attempted=epochs, failed=0, checks=checks, memory_peak_bytes=peak,
        counters=counters,
        traced={"forward": {bt: traced_epochs * n_steps,
                            be: traced_epochs * n_eval}
                if bt != be else {bt: traced_epochs * (n_steps + n_eval)},
                "backward": {bt: traced_epochs * n_steps}})
