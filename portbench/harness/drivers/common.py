"""Set-up shared by the serving drivers: the seeded weights written as a
checkpoint of the program, as a user's trained model would be."""

from __future__ import annotations

import dataclasses
import gc
import os

from ..check import fit_scaler, load_csv
from ..traffic import seed_for
from ..weights import make_weights


def serving_checkpoint(ctx):
    """Make the seeded weights on the device and write them with the
    program's checkpoint format under the run's temporary directory.
    Returns ``(path, scaler)``; the scaler is the bundled training
    split's, as a model trained on it carries."""
    from mgat_graphsage_torch.train.checkpoint import save_checkpoint
    from mgat_graphsage_torch.train.config import get_config

    conf = ctx.config
    cfg = get_config(conf["preset"])
    scaler = fit_scaler(load_csv(ctx.traffic.get(
        "scaler_csv", "train_data.csv"))[1])
    with ctx.phase("weights"):
        w = make_weights(conf["model"], seed_for(ctx.seed, "weights"),
                         ctx.device)
    with ctx.phase("checkpoint"):
        path = os.path.join(ctx.tmpdir, "model.pt")
        n_nodes, n_edges = conf["budget"]
        save_checkpoint(path, w, {
            "config": dataclasses.asdict(cfg),
            "scaler": {"mean": scaler[0], "scale": scaler[1]},
            "max_nodes": n_nodes, "max_edges": n_edges})
        del w
    return path, scaler


def free_device(ctx) -> None:
    """Release what the program left on the device before the reference
    runs."""
    gc.collect()
    if ctx.device.type == "cuda":
        ctx.torch.cuda.synchronize()
        ctx.torch.cuda.empty_cache()
