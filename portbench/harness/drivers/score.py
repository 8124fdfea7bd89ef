"""Library scoring: a closed loop of ``Predictor`` calls, each on a chunk
of a seeded pool of SMILES (reshuffled at each pass), as a screening
pipeline scores a compound library.

``score_mol_per_s`` is every SMILES of every call of the window (NaN rows
included) over the window: the window runs whole calls back to back from
its start and ends with the first call that ends ``--seconds`` or more
after it, so no call is cut and no time left out.
"""

from __future__ import annotations

import time

import numpy as np

from ..check import prediction_checks, reference_predictions
from ..runner import Outcome
from ..traffic import library_pool, score_chunks, seed_for
from .common import free_device, serving_checkpoint


def run(ctx) -> Outcome:
    from mgat_graphsage_torch.eval.predict import Predictor

    tr = ctx.traffic
    bs = int(tr["batch_size"])
    path, scaler = serving_checkpoint(ctx)
    with ctx.phase("load"):
        pred = Predictor(path, device=str(ctx.device))
    with ctx.phase("pool"):
        pool = library_pool(tr, ctx.seed, ctx.config["budget"][0])
        chunks = score_chunks(pool, int(tr["chunk"]), ctx.seed)
    with ctx.phase("warmup"):
        for _ in range(int(tr["warmup_calls"])):
            pred(next(chunks), batch_size=bs)

    smiles, answers, calls = [], [], []
    traced_batches = 0
    t0 = ctx.window_started()
    while True:
        chunk = next(chunks)
        t_call = time.perf_counter()
        with ctx.tracer.span("predict_call"):
            out = pred(chunk, batch_size=bs)
        t = time.perf_counter()
        lt = pred.last_timings
        ctx.tracer.split_last("predict_call", [
            ("featurize", lt["featurize_s"]), ("dispatch", lt["dispatch_s"])])
        scored = int(np.isfinite(out).sum())
        calls.append((t_call, len(chunk), scored, lt["featurize_s"]))
        if ctx.tracer.active:
            traced_batches += -(-scored // bs)
            if ctx.tracer.due():
                ctx.tracer.stop()
        smiles += chunk
        answers.append(out)
        if t - t0 >= ctx.seconds:
            break
    window = t - t0
    ctx.tracer.stop()
    answers = np.concatenate(answers)
    peak = ctx.memory_peak()
    del pred
    free_device(ctx)
    # the per-layer readers' counts: the untraced part of the window
    own = [c for c in calls if ctx.tracer.untraced(c[0])]
    counters = {"window_s": t - (ctx.tracer.t_resume or t0),
                "molecules": sum(c[1] for c in own),
                "scored": sum(c[2] for c in own),
                "featurize_s": sum(c[3] for c in own)}

    rng = np.random.default_rng(seed_for(ctx.seed, "check"))
    pick = np.sort(rng.choice(len(smiles), min(int(tr["check_molecules"]),
                                               len(smiles)), replace=False))
    want = reference_predictions(ctx, [smiles[i] for i in pick], scaler)
    checks = prediction_checks(ctx, answers[pick], want)
    return Outcome(
        metrics={"score_mol_per_s": len(smiles) / window},
        attempted=len(smiles), failed=0, checks=checks,
        memory_peak_bytes=peak,
        counters=counters, traced={"forward": {bs: traced_batches}})
