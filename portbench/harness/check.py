"""The comparisons that decide ``correct``: what the timed path produced,
against the plain reference (``portbench/reference/``) run on the same
inputs and the same seeded weights once the window has closed.

Served answers: ``pred_gap``, the largest absolute gap in pChEMBL between
an answer and the reference's, and ``nan_mismatch``, the answers that are
NaN on one side only (an unparseable or over-budget SMILES must be NaN).
Training: ``loss_gap``, the largest relative gap of the first two steps'
losses; ``grad_gap``, the worst leaf's gap between the norms of the first
gradient as the optimizer took it (L2 term included), against the larger
of that leaf's reference norm and the median leaf's; ``change_gap``, the
same of the parameters' change over the first step, leaving out the
leaves whose reference gradient is under a thousandth of the median
leaf's (they move by round-off alone under Adam); ``change_gap_median``,
the median leaf's gap of the same.  A third step is not compared: Adam's
second update moves elements whose gradients sit at round-off by whole
steps either way, so a sound run's third loss can part from the
reference's by 3e-4 (PERF.md).  A cell compares the numbers its limits
file names.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..reference import featurize as ref_feat
from ..reference import model as ref_model
from . import weights
from .runner import Check
from .traffic import seed_for

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")


def load_csv(name: str):
    """``(smiles, targets)`` of ``portbench/data/<name>`` (a frozen copy of
    the bundled split)."""
    smiles, y = [], []
    with open(os.path.join(DATA_DIR, name), newline="") as f:
        for row in csv.DictReader(f):
            smiles.append(row["Smiles"])
            y.append(float(row["pchembl"]))
    return smiles, np.asarray(y, dtype=np.float32)


def fit_scaler(y: np.ndarray):
    """(mean, scale) with numpy's ddof=0 std, in float64."""
    y64 = np.asarray(y, dtype=np.float64)
    std = float(y64.std())
    return float(y64.mean()), std if std > 0 else 1.0


def ref_weights(ctx, numerics: ref_model.Numerics):
    w = weights.make_weights(ctx.config["model"],
                             seed_for(ctx.seed, "weights"), ctx.device)
    return {k: v.to(numerics.dtype) for k, v in w.items()}


def reference_predictions(ctx, smiles: Sequence[str], scaler,
                          mode: Optional[str] = None,
                          block: int = 256) -> np.ndarray:
    """The reference's pChEMBL for each SMILES (NaN where it does not
    featurise), in blocks of ``block`` molecules."""
    import torch

    conf = ctx.config
    num = ref_model.Numerics(mode or conf["numerics"])
    n_nodes, n_edges = conf["budget"]
    kept, nodes, edges, nmask, emask, fp = ref_feat.featurize(
        smiles, n_nodes, n_edges, conf["model"]["fp_bits"])
    w = ref_weights(ctx, num)
    dev, dt = ctx.device, num.dtype
    preds = []
    with torch.no_grad(), num.flags():
        for s in range(0, len(nodes), block):
            def up(a):
                return torch.from_numpy(a[s:s + block]).to(dev)
            adj = ref_model.dense_adjacency(up(edges), up(emask), n_nodes)
            pred, _ = ref_model.forward(w, up(nodes).to(dt), adj.to(dt),
                                        up(nmask).to(dt), up(fp).to(dt), num)
            preds.append(pred * scaler[1] + scaler[0])
    out = np.full(len(smiles), np.nan, np.float32)
    if preds:
        out[kept] = torch.cat(preds).cpu().numpy()
    return out


def prediction_numbers(got: np.ndarray, want: np.ndarray) -> Dict[str, float]:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    both = np.isfinite(got) & np.isfinite(want)
    gap = float(np.max(np.abs(got[both] - want[both]))) if both.any() else 0.0
    return {"pred_gap": gap,
            "nan_mismatch": float(np.sum(np.isnan(got) != np.isnan(want)))}


def prediction_checks(ctx, got, want) -> List[Check]:
    return [Check(k, v, ctx.limit(k))
            for k, v in prediction_numbers(got, want).items()]


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def epoch_rows(n: int, batch: int, seed: int, epoch: int = 0):
    """The trainer's batches of an epoch: rows and sample masks, the final
    batch padded with row 0, masked."""
    idx = np.random.default_rng(seed + epoch).permutation(n)
    n_batches = -(-n // batch)
    pad = n_batches * batch - n
    mask = np.ones(n_batches * batch, np.float32)
    if pad:
        idx = np.concatenate([idx, np.zeros(pad, idx.dtype)])
        mask[-pad:] = 0.0
    return idx.reshape(n_batches, batch), mask.reshape(n_batches, batch)


def dropout_seed(seed: int, epoch: int) -> int:
    """The seed of an epoch's dropout masks, as the trainer derives it."""
    return int(np.random.SeedSequence([int(seed), 1234, epoch])
               .generate_state(1)[0])


def reference_train(ctx, smiles, targets, steps: int,
                    mode: Optional[str] = None,
                    fault: Optional[str] = None) -> Dict:
    """The reference's first ``steps`` training steps from the seeded
    weights, on the trainer's batches and dropout masks of epoch 0.
    Returns ``losses``, ``grad`` (norm of each leaf's first gradient, L2
    term included), ``raw`` (without it) and ``change`` (norm of each
    leaf's change over the first step).  ``fault="half"`` leaves out half
    of each batch (the mean over the rest)."""
    import torch

    conf, train = ctx.config, ctx.config["train"]
    num = ref_model.Numerics(mode or conf["numerics"])
    n_nodes, n_edges = conf["budget"]
    kept, nodes, edges, nmask, emask, fp = ref_feat.featurize(
        smiles, n_nodes, n_edges, conf["model"]["fp_bits"])
    y = np.asarray(targets, np.float32)[kept]
    mean, scale = fit_scaler(y)
    yn = ((y - mean) / scale).astype(np.float32)
    rows, smask = epoch_rows(len(y), train["batch_size"], ctx.seed)
    dev, dt = ctx.device, num.dtype
    master = {k: v.clone() for k, v in weights.make_weights(
        conf["model"], seed_for(ctx.seed, "weights"), dev).items()}
    p0 = {k: v.clone() for k, v in master.items()}
    adam = ref_model.Adam(master, train["weight_decay"],
                          getattr(torch, train["moment_dtype"]),
                          torch_adam=num.dtype == torch.float32
                          and train["moment_dtype"] == "float32")
    gen = torch.Generator(device=dev).manual_seed(dropout_seed(ctx.seed, 0))
    p_drop = train["dropout"]

    def drop(x):
        keep = torch.empty_like(x).bernoulli_(1.0 - p_drop, generator=gen)
        return x * keep / (1.0 - p_drop)

    total = train["epochs"] * rows.shape[0]
    out = {"losses": []}
    for step in range(steps):
        sel, sm = rows[step], smask[step].copy()
        if fault == "half":
            sm[len(sm) // 2:] = 0.0

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a[sel])).to(dev)

        smd = torch.from_numpy(sm).to(dev)
        adj = ref_model.dense_adjacency(up(edges), up(emask), n_nodes)
        node_mask = up(nmask) * smd.unsqueeze(1)
        leaves = {k: v.detach().to(dt).requires_grad_(True)
                  for k, v in master.items()}
        with num.flags():
            pred, latent = ref_model.forward(
                leaves, up(nodes).to(dt), adj.to(dt), node_mask.to(dt),
                up(fp).to(dt), num, drop)
            mse = ref_model.masked_mse(pred, up(yn), smd)
            loss = mse + train["kl_lambda"] * ref_model.kl_loss(latent, smd)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        grads = dict(zip(leaves, grads))
        lr = ref_model.lr_at(step + 1, train["lr"], train["lr_schedule"],
                             train["warmup_steps"], train["lr_final_ratio"],
                             total)
        seen = adam.step(grads, lr)
        out["losses"].append(loss.item())
        if step == 0:
            out["grad"] = _norms(seen)
            out["raw"] = _norms({k: g.float() for k, g in grads.items()})
            out["change"] = _norms({k: master[k] - p0[k] for k in master})
    return out


def _norms(ts: Dict) -> Dict[str, float]:
    import torch

    names = list(ts)
    vals = torch.stack([torch.linalg.vector_norm(ts[k].double())
                        for k in names]).cpu().tolist()
    return dict(zip(names, vals))


def train_numbers(got: Dict, want: Dict, leaves: bool = False
                  ) -> Dict[str, float]:
    """The compared numbers; with ``leaves``, also the leaf that sets each
    gap (``grad_leaf``, ``change_leaf``)."""
    lp, lr = np.asarray(got["losses"]), np.asarray(want["losses"])
    loss_gap = float(np.max(np.abs(lp - lr) / np.abs(lr)))

    def worst(a: Dict, b: Dict, keys):
        med = float(np.median([b[k] for k in keys]))
        return max((abs(a[k] - b[k]) / max(b[k], med, 1e-30), k)
                   for k in keys)

    keys = list(want["grad"])
    med_raw = float(np.median([want["raw"][k] for k in keys]))
    moved = [k for k in keys if want["raw"][k] >= 1e-3 * med_raw]
    grad, change = (worst(got["grad"], want["grad"], keys),
                    worst(got["change"], want["change"], moved))
    med_c = float(np.median([want["change"][k] for k in moved]))
    gaps = [abs(got["change"][k] - want["change"][k])
            / max(want["change"][k], med_c, 1e-30) for k in moved]
    out = {"loss_gap": loss_gap, "grad_gap": float(grad[0]),
           "change_gap": float(change[0]),
           "change_gap_median": float(np.median(gaps))}
    if leaves:
        out.update(grad_leaf=grad[1], change_leaf=change[1],
                   left_out=sorted(set(keys) - set(moved)))
    return out


def train_checks(ctx, got, want) -> List[Check]:
    """The numbers the cell's limits file names, each with its limit."""
    nums = train_numbers(got, want)
    return [Check(k, nums[k], ctx.limit(k)) for k in ctx.limits]
