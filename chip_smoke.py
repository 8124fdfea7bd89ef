#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``mgat_graphsage_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed 0]

Phases (any failure raises and the script exits non-zero):

1. device report: torch and CUDA versions, the card, and ``nvidia-smi``'s
   name and power limit;
2. build both kernels from ``mgat_graphsage_torch/csrc`` (one ``nvcc`` per
   source, started together) and hold the adjacency kernel BITWISE against
   its plain version: the first 64 molecules of the test CSV at the
   (80, 176) budget, a batch of 61, an all-zero edge mask, duplicate edges,
   and N=128;
3. hold the attention kernel against its plain version to atol=rtol=1e-5
   (f32, another summation order): the serving path's own q, k_new, v at
   [64, 80, 35], random [64, 80, 35] with mixed padding and a fully-masked
   molecule, and [16, 128, 128]; residual on and off;
4. end to end at full width: the ``flagship`` hybrid initialised from a
   seeded ``torch.Generator``, saved with the port's checkpoint format
   (scaler fit on the train CSV, budget (80, 176)), then served on CUDA:
   ``predict_csv`` on all 961 test molecules, a ``Predictor`` on the same
   list, and requests of 1, 64 and 512 SMILES with the unparseable
   ``"C1CC("`` among them.  Both kernels' launch counters are set to 0
   before this phase and must have risen after it.  Predictions must be
   finite, NaN exactly where the input was unparseable, aligned with the
   input, within 1e-4 pChEMBL of the same model run on the card through
   the plain versions (f32 sums in another order), and within 1e-3 of the
   port on the CPU for the first 64 molecules (another BLAS and other
   convolution algorithms);
5. timings on the card: each kernel, its plain version and, for the
   attention, one ``scaled_dot_product_attention`` call plus ``v`` (timed
   here only; the port never calls it), at the serving shapes; each
   kernel's lower bound from the bytes it must move and the f32 operations
   it must do; molecules/s split into host featurisation and device time;
   p50 latency of each request size; and a ``torch.profiler`` trace of one
   Predictor call: the device's busy share and its top kernels by time.

Kernel times come from CUDA events around back-to-back launches queued
behind a device-side sleep, so the host's launch cost is not in them.

The last two lines are one JSON object listing the kernels, then
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, data sheet
F32_FLOPS_PER_S = 67e12      # H100 SXM, f32 outside the tensor cores
BUDGET = (80, 176)
BATCH = 64
BAD = "C1CC("


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line():
    if shutil.which("nvidia-smi") is None:
        return None
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else None


class DeviceTimer:
    """Device time of ``fn`` per call: warm up, queue a device-side sleep,
    enqueue ``iters`` calls behind it, and read CUDA events around them."""

    def __init__(self, torch):
        self.torch = torch
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        cycles = 20_000_000
        s.record()
        torch.cuda._sleep(cycles)
        e.record()
        torch.cuda.synchronize()
        self.cycles_per_ms = cycles / s.elapsed_time(e)

    def __call__(self, fn, iters=100):
        torch = self.torch
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(int(self.cycles_per_ms * (2.0 * host_ms + 5.0)))
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / iters


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def plain_path(predict_mod, layers_mod, adjacency_plain, attention_plain):
    """Route the serving path through the plain versions (reference run)."""
    saved = (predict_mod.dense_adjacency,
             layers_mod.fused_masked_attention_cuda)
    predict_mod.dense_adjacency = adjacency_plain
    layers_mod.fused_masked_attention_cuda = attention_plain
    try:
        yield
    finally:
        (predict_mod.dense_adjacency,
         layers_mod.fused_masked_attention_cuda) = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one "
              "card", file=sys.stderr)
        return 2
    try:
        import mgat_graphsage_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable next to this script "
              f"({e})", file=sys.stderr)
        return 2

    from mgat_graphsage_torch.data import (
        TEST_CSV, TRAIN_CSV, MolecularDataset, StandardScaler, load_csv)
    from mgat_graphsage_torch.eval import predict as predict_mod
    from mgat_graphsage_torch.eval.predict import (
        Predictor, predict_csv, predict_dataset)
    from mgat_graphsage_torch.models import build_model, reset_parameters
    from mgat_graphsage_torch.models import layers as layers_mod
    from mgat_graphsage_torch.ops import _build
    from mgat_graphsage_torch.ops.adjacency import (
        dense_adjacency_cuda, dense_adjacency_plain)
    from mgat_graphsage_torch.ops.attention import (
        attention_plain, fused_masked_attention_cuda)
    from mgat_graphsage_torch.train import get_config, save_checkpoint

    # the plain versions are the f32 reference: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    n_nodes, n_edges = BUDGET

    # ---- 1. device report ------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    log(f"[1] torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"python {sys.version.split()[0]}  device {kind}  "
        f"count {torch.cuda.device_count()}")
    smi = nvidia_smi_line()
    log(smi if smi else "nvidia-smi: not available")
    card = smi or kind

    # ---- 2. build, then kernel 1 against its plain version --------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"[2] built {', '.join(os.path.relpath(p, REPO) for p in libs)} "
        f"in {time.perf_counter() - t0:.1f} s")

    test_smiles, test_y = load_csv(TEST_CSV)
    ds64 = MolecularDataset(test_smiles[:BATCH], test_y[:BATCH],
                            max_nodes=n_nodes, max_edges=n_edges,
                            verbose=False)
    assert len(ds64) == BATCH, "a test molecule fell outside the budget"
    edges64 = torch.from_numpy(ds64.edges).to(dev)
    emask64 = torch.from_numpy(ds64.edge_mask).to(dev)
    rng = np.random.default_rng(args.seed)

    def dup_case(b, n, e):
        ed = rng.integers(0, n, size=(b, 2, e)).astype(np.int32)
        m = np.zeros((b, e), np.float32)
        for i in range(b):
            k = int(rng.integers(1, e + 1))
            m[i, :k] = 1.0
            ed[i, :, k:] = 0                      # padding points at node 0
            ed[i, :, 1:k:2] = ed[i, :, 0:k - 1:2]  # every other edge twice
        return torch.from_numpy(ed).to(dev), torch.from_numpy(m).to(dev)

    adj_cases = {
        "test64": (edges64, emask64, n_nodes),
        "batch61": (edges64[:61].contiguous(), emask64[:61].contiguous(),
                    n_nodes),
        "empty_mask": (edges64, torch.zeros_like(emask64), n_nodes),
        "duplicates": (*dup_case(BATCH, n_nodes, n_edges), n_nodes),
        "n128": (*dup_case(BATCH, 128, 320), 128),
    }
    adj_err = 0.0
    for name, (ed, em, n) in adj_cases.items():
        got = dense_adjacency_cuda(ed, em, n)
        want = dense_adjacency_plain(ed, em, n)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        adj_err = max(adj_err, err)
        if not torch.equal(got, want):
            raise AssertionError(f"adjacency kernel differs from its plain "
                                 f"version on {name}: max |err| {err}")
        log(f"[2] adjacency {name:<10} {tuple(got.shape)} bitwise equal "
            f"({int(want.sum().item())} ones)")

    # ---- 4a. the model, its checkpoint, and the serving path's q/k/v ----
    cfg = get_config("flagship")
    model = reset_parameters(build_model(cfg),
                             torch.Generator().manual_seed(args.seed))
    n_params = sum(p.numel() for p in model.parameters())
    _, train_y = load_csv(TRAIN_CSV)
    scaler = StandardScaler().fit(train_y)
    tmp = tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=REPO)
    ckpt = os.path.join(tmp.name, "flagship.pt")
    save_checkpoint(ckpt, model.state_dict(),
                    {"config": dataclasses.asdict(cfg),
                     "scaler": scaler.to_dict(),
                     "max_nodes": n_nodes, "max_edges": n_edges})
    log(f"[4] flagship hybrid, {n_params} parameters (seed {args.seed}), "
        f"saved to {os.path.relpath(ckpt, REPO)}")

    predictor = Predictor(ckpt)           # on CUDA: no device argument
    assert predictor.device.type == "cuda", predictor.device
    gat = predictor.model.gat_graphsage.conv1
    with torch.inference_mode():
        x = torch.from_numpy(ds64.nodes).to(dev)
        nm64 = torch.from_numpy(ds64.node_mask).to(dev)
        serve_q = gat.query_transform(x).contiguous()
        k = gat.key_transform(x)
        serve_k = gat.linear_transform(
            torch.cat([gat.conv3(k), gat.conv5(k), k], -1)).contiguous()
        serve_v = gat.value_transform(x).contiguous()

    # ---- 3. kernel 2 against its plain version ---------------------------
    def rand_attn(b, n, f):
        q, kk, v = (torch.from_numpy(rng.standard_normal((b, n, f))
                                     .astype(np.float32)).to(dev)
                    for _ in range(3))
        m = np.zeros((b, n), np.float32)
        for i in range(b):
            m[i, :int(rng.integers(1, n + 1))] = 1.0
        m[-1] = 0.0                                # fully-masked molecule
        return q, kk, v, torch.from_numpy(m).to(dev)

    attn_cases = {"serving": (serve_q, serve_k, serve_v, nm64),
                  "random": rand_attn(BATCH, n_nodes, 35),
                  "n128_f128": rand_attn(16, 128, 128)}
    attn_err = 0.0
    with torch.inference_mode():
        for name, (q, kk, v, m) in attn_cases.items():
            for residual in (True, False):
                got = fused_masked_attention_cuda(q, kk, v, m, residual)
                want = attention_plain(q, kk, v, m, residual)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                attn_err = max(attn_err, err)
                if not (torch.isfinite(got).all()
                        and torch.allclose(got, want, atol=1e-5, rtol=1e-5)):
                    raise AssertionError(
                        f"attention kernel differs from its plain version on "
                        f"{name} residual={residual}: max |err| {err}")
                log(f"[3] attention {name:<9} {tuple(q.shape)} "
                    f"residual={residual!s:<5} max |err| {err:.3e}")
        q, kk, v, m = attn_cases["random"]
        if fused_masked_attention_cuda(q, kk, v, m, False)[-1].abs().max() != 0:
            raise AssertionError("a fully-masked molecule must give 0")
    q = serve_q.clone().requires_grad_(True)
    try:
        fused_masked_attention_cuda(q, serve_k, serve_v, nm64)
    except RuntimeError as e:
        log(f"[3] forward-only guard: {str(e).split(':')[0]}")
    else:
        raise AssertionError("the attention kernel accepted a tensor that "
                             "requires grad")

    # ---- 4b. the main path, with the launch counters from 0 --------------
    rng_req = np.random.default_rng(args.seed + 1)

    def request(size):
        """``size`` test SMILES with ``BAD`` in a random slot (none in a
        request of 1, which would then hold no molecule); returns the
        request and each slot's index in the test CSV (-1 for BAD)."""
        idx = rng_req.choice(len(test_smiles), size, replace=False)
        if size > 1:
            idx[int(rng_req.integers(size))] = -1
        return [BAD if i < 0 else test_smiles[i] for i in idx], idx

    dense_adjacency_cuda.launches = 0
    fused_masked_attention_cuda.launches = 0
    t0 = time.perf_counter()
    metrics, csv_preds = predict_csv(
        ckpt, TEST_CSV, os.path.join(tmp.name, "pred.csv"), BATCH,
        verbose=False)
    torch.cuda.synchronize()
    csv_s = time.perf_counter() - t0
    full = predictor(test_smiles)
    full_t = dict(predictor.last_timings)
    latency = {}
    replies = [(predictor([BAD]), np.array([-1]))]
    for size in (1, 64, 512):
        times = []
        for _ in range(7):
            req, idx = request(size)
            t1 = time.perf_counter()
            out = predictor(req)
            times.append(time.perf_counter() - t1)
            replies.append((out, idx))
        latency[size] = float(np.median(times[1:]) * 1e3)
    launches = {"adjacency": dense_adjacency_cuda.launches,
                "attention": fused_masked_attention_cuda.launches}
    log(f"[4] main path launches: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the serving path never launched the "
                                 f"{name} kernel")

    # ---- 4c. checks of what came out -------------------------------------
    n_test = len(test_smiles)
    if csv_preds.shape != (n_test,) or not np.isfinite(csv_preds).all():
        raise AssertionError(f"predict_csv: shape {csv_preds.shape}, "
                             f"{int(np.isfinite(csv_preds).sum())} finite")
    if full.shape != (n_test,) or not np.isfinite(full).all():
        raise AssertionError("Predictor on the test list: non-finite values")
    if np.abs(full - csv_preds).max() > 1e-4:
        raise AssertionError("Predictor and predict_csv disagree")
    for out, idx in replies:
        bad = idx < 0
        if out.shape != idx.shape or not np.isnan(out[bad]).all() \
                or not np.isfinite(out[~bad]).all():
            raise AssertionError(f"request of {len(idx)}: NaN slots "
                                 f"{np.flatnonzero(np.isnan(out))}, "
                                 f"expected {np.flatnonzero(bad)}")
        err = np.abs(out[~bad] - csv_preds[idx[~bad]]).max(initial=0.0)
        if err > 1e-4:
            raise AssertionError(f"request of {len(idx)} is misaligned with "
                                 f"the full run: max |err| {err}")
    ds_test = MolecularDataset(test_smiles, test_y, scaler=scaler,
                               max_nodes=n_nodes, max_edges=n_edges,
                               verbose=False)
    with plain_path(predict_mod, layers_mod, dense_adjacency_plain,
                    attention_plain):
        plain_preds = predict_dataset(predictor.model, cfg, scaler, ds_test,
                                      BATCH)
    plain_err = float(np.abs(csv_preds - plain_preds).max())
    if plain_err > 1e-4:
        raise AssertionError(f"kernel path vs plain path on the card: max "
                             f"|err| {plain_err} pChEMBL > 1e-4")
    cpu_preds = Predictor(ckpt, device="cpu")(test_smiles[:BATCH])
    cpu_err = float(np.abs(csv_preds[:BATCH] - cpu_preds).max())
    if cpu_err > 1e-3:
        raise AssertionError(f"card vs CPU on 64 molecules: max |err| "
                             f"{cpu_err} pChEMBL > 1e-3")
    log(f"[4] {n_test} test molecules: MSE {metrics['mse']:.4f} (random "
        f"weights), all finite; vs plain path on the card max |err| "
        f"{plain_err:.3e}; vs the port on the CPU (64) {cpu_err:.3e}; "
        f"requests NaN-aligned")

    # ---- 5. timings --------------------------------------------------------
    timer = DeviceTimer(torch)
    b, n, f = serve_q.shape
    e = edges64.shape[2]
    with torch.inference_mode():
        adj_ms = timer(lambda: dense_adjacency_cuda(edges64, emask64, n))
        adj_plain_ms = timer(lambda: dense_adjacency_plain(edges64, emask64,
                                                           n))
        attn_ms = timer(lambda: fused_masked_attention_cuda(
            serve_q, serve_k, serve_v, nm64, True))
        attn_plain_ms = timer(lambda: attention_plain(
            serve_q, serve_k, serve_v, nm64, True))
        key_mask = (nm64 > 0).unsqueeze(1)         # [B, 1, N] over keys
        sdpa = torch.nn.functional.scaled_dot_product_attention
        attn_lib_ms = timer(lambda: sdpa(serve_k, serve_q, serve_v,
                                         attn_mask=key_mask) + serve_v)
    adj_bound = bound(b * 3 * e * 4 + b * n * n * 4, b * e)
    attn_bound = bound(3 * b * n * f * 4 + b * n * 4 + b * n * f * 4,
                       4 * b * n * n * f + 5 * b * n * n)
    for name, ms, plain, lib, (bms, by) in (
            ("adjacency", adj_ms, adj_plain_ms, None, adj_bound),
            ("attention", attn_ms, attn_plain_ms, attn_lib_ms, attn_bound)):
        log(f"[5] {name} at the serving shape: kernel {ms * 1e3:.2f} us, "
            f"plain {plain * 1e3:.2f} us, library "
            f"{'n/a' if lib is None else f'{lib * 1e3:.2f} us'}, bound "
            f"{bms * 1e3:.3f} us ({by}) on {card}")
    feat_s, disp_s = full_t["featurize_s"], full_t["dispatch_s"]
    log(f"[5] {n_test} molecules through the Predictor: "
        f"{n_test / (feat_s + disp_s):.1f} mol/s end to end; host "
        f"featurisation {feat_s:.3f} s ({n_test / feat_s:.1f} mol/s), "
        f"device {disp_s:.3f} s ({n_test / disp_s:.1f} mol/s); predict_csv "
        f"{csv_s:.3f} s including the model load")
    log("[5] p50 request latency: " + ", ".join(
        f"{k} SMILES {v:.2f} ms" for k, v in latency.items()))

    # where the device time of one Predictor call goes (kernels by name)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predictor(test_smiles)
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [ev for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(ev.self_device_time_total for ev in kern)
    log(f"[5] profile of one Predictor call on {n_test} molecules: wall "
        f"{wall_us:.0f} us, device busy {busy_us:.0f} us "
        f"({100 * busy_us / wall_us:.2f}%); top kernels:")
    ranked = sorted(kern, key=lambda ev: -ev.self_device_time_total)
    ours = ("dense_adjacency_kernel", "masked_attention_kernel")
    for i, ev in enumerate(ranked):
        if i < 8 or any(o in ev.key for o in ours):
            log(f"  #{i + 1:<3d}{ev.self_device_time_total:9.1f} us  "
                f"x{ev.count:<4d} {ev.key[:90]}")
    tmp.cleanup()

    kernels = [
        {"name": "dense_adjacency", "route": "cuda",
         "source": "mgat_graphsage_torch/csrc/adjacency.cu",
         "replaces": "mgat_graphsage_tpu/ops/pallas_adjacency.py:56",
         "launches": launches["adjacency"], "max_abs_err": adj_err,
         "ms": adj_ms, "plain_ms": adj_plain_ms, "bound_ms": adj_bound[0],
         "bound_by": adj_bound[1], "library_ms": None},
        {"name": "fused_masked_attention", "route": "cuda",
         "source": "mgat_graphsage_torch/csrc/attention.cu",
         "replaces": "mgat_graphsage_tpu/ops/pallas_attention.py:84",
         "launches": launches["attention"], "max_abs_err": attn_err,
         "ms": attn_ms, "plain_ms": attn_plain_ms,
         "bound_ms": attn_bound[0], "bound_by": attn_bound[1],
         "library_ms": attn_lib_ms},
    ]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
