#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``mgat_graphsage_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed 0]

Phases (any failure raises and the script exits non-zero):

1. device report: torch and CUDA versions, the card, and ``nvidia-smi``'s
   name and power limit;
2. build the five kernel sources (kernels 1-5, and 4-5's bf16 variants)
   from ``mgat_graphsage_torch/csrc`` (one ``nvcc``
   per source, started together) and the native host featuriser
   (``csrc/featurizer.cpp``, ``g++`` in a thread beside them; every later
   phase featurises through it), and hold the adjacency kernel BITWISE
   against its plain version on a CPU copy of the inputs
   (``check_adjacency``): the first 64 test and 128 training molecules at
   the (80, 176) budget, a batch of 61, an all-zero edge mask, duplicate
   edges, N=128, fractional masks with several edges per cell, N=256 and
   300, E=175, N=1, B=1 and B=133, out-of-range and negative indices, a
   NaN mask, unaligned tensors and an edge list past shared memory; a
   repeat bit for bit, and ``dense_adjacency`` at N=300 on the kernel;
3. hold the attention forward kernel against its plain version to
   atol=rtol=1e-5 (f32, another summation order): the serving path's own
   q, k_new, v at [64, 80, 35], random [64, 80, 35] with mixed padding and
   a fully-masked molecule, [16, 128, 128], the ragged and edge shapes
   [8, 37, 35], [4, 5, 3] and [16, 84, 128], and [1, 80, 35] and
   [200, 80, 35] (one and two row groups by the launcher's rule);
   residual on and off; the kernel must repeat bit for bit and give 0 for
   a fully-masked molecule;
4. serving at full width: the ``flagship`` hybrid initialised from a
   seeded ``torch.Generator``, saved with the port's checkpoint format
   (scaler fit on the train CSV, budget (80, 176)), then served on CUDA:
   ``predict_csv`` on all 961 test molecules, a ``Predictor`` on the same
   list, and requests of 1, 64 and 512 SMILES with the unparseable
   ``"C1CC("`` among them.  The launch counters are set to 0 before this
   phase and the serving kernels' must have risen after it.  Predictions
   must be finite, NaN exactly where the input was unparseable, aligned
   with the input, within 1e-4 pChEMBL of the same model run on the card
   through the plain versions, and within 1e-3 of the port on the CPU;
5. serving timings: each serving kernel, its plain version and the library
   computing the same function (timed here only; the port never calls
   it): for the adjacency, at B=64 and at the training batch B=128,
   ``zeros`` + ``index_add_`` + ``clamp_max_``; for the attention, one
   ``scaled_dot_product_attention`` call plus ``v``; each kernel's bound
   and bound share; molecules/s
   split into host featurisation and device time; host featurisation of
   the 961 test molecules natively and through the Python path; p50 request
   latency; a ``torch.profiler`` trace of one Predictor call;
6. the attention backward kernel against its plain version, each output
   within 1e-5 of its largest magnitude: the first training batch's own
   q, k_new, v at [128, 80, 35] with its last molecule fully masked, random
   [128, 80, 35], [16, 128, 35] and [16, 84, 128] (the gate's largest N at
   F = 35 and F = 128), [8, 37, 35] and [4, 5, 3] (ragged tiles); residual
   on and off; the kernel must repeat bit for bit, and the attn it
   recomputes must equal the forward kernel's bit for bit;
7. the CNN backward kernels against their plain versions at the training
   shape B=128, W=1024, on the model's own activations of that batch:
   ``dy3`` within 1e-5 and the six weight and bias gradients within 1e-4
   of each output's largest magnitude (sums over 131,072 positions); both
   kernels must repeat bit for bit; ``dy3`` also at three ragged shapes,
   the chain kernel at B=3, W=37; B=1, W=1; B=5, W=2048 and B=200,
   W=1024 on random ReLU-pattern inputs (same limit, bit for bit);
8. full-width ``flagship`` training on the bundled train and validation
   CSVs, twice: default and ``cnn_pallas_bwd=True``.  Each: the first 4
   train steps' losses within rel 1e-4 of a run through the plain versions
   from the same seed; then ``Trainer.fit`` for one epoch with the counters
   set to 0 before it and read after it (adjacency, attention forward and
   backward must have risen, the CNN kernels exactly when
   ``cnn_pallas_bwd``); finite metrics; the best checkpoint served through
   ``Predictor`` within 1e-4 pChEMBL of the trainer's own predictions.
   Then the training CLI (``--limit 256``) on CUDA in a subprocess;
9. the gate: a checkpoint padded to N = 160 served through ``Predictor``
   (attention on the plain path by the gate, adjacency on its kernel) and
   one training step at N = 160, each against the plain path;
10. training timings: kernels 2-5 at the training shape (kernel 2 on the
   first training batch's own q, k_new, v and mask), their plain versions,
   the library call computing the same function (timed here only), their
   bounds, bound shares (bound / kernel time) and launches per step; ms
   per train step and molecules/s both ways; a ``torch.profiler`` trace
   of one training epoch;
11. mixed precision at full width: the production preset
   ``flagship_bf16_bs1024_wc`` (bf16 compute and Adam moments, the carried
   bf16 working copy, batch 1024: 3 steps an epoch) on the bundled CSVs
   from seed 42.  The first 3 losses within rel 1e-4 of a run through the
   plain versions; kernels 1-3 on the first bf16 step's own inputs at
   B=1024 (recorded on their way in) against their plain versions: the
   adjacency bit for bit, the attention forward to atol=rtol=1e-5 and its
   backward to 1e-5 of each output's largest magnitude, as in phases 2, 3
   and 6; ``Trainer.fit`` for one epoch with the counters from 0
   (kernels 1-3 must have risen, 4-5 must not), finite metrics, an f32
   master; the best checkpoint served through ``Predictor(infer_dtype=
   "bfloat16")`` within 0.05 (normalised) of f32 serving, NaN exactly for
   ``"C1CC("``.  ``remat=True``: 3 steps within rel 1e-3 of the run
   without, kernels 1-2 launched twice a step; ``flagship_bf16sr``: 3
   steps, finite, parameters bf16; ``cnn_pallas_bwd=True`` with bf16
   compute raises; the CLI with ``--mixed-precision --limit 256``.  For
   information: ms per train step at batch 1024 for f32 ``flagship`` and
   the bf16 preset; the f32 ``flagship`` step at its batch of 128 with the
   port's ``TorchAdam`` and with ``torch.optim.Adam`` (foreach and fused),
   and each optimizer step alone; the bf16 Predictor's mol/s split into
   host and device, and the device-busy share of one bf16 epoch under
   ``torch.profiler``;
12. the host data and serving layer: the native featuriser against the
   Python path on the test (961) and train (3000) CSVs, nodes, edges,
   masks, fingerprints and kept indices bit for bit, and both rates; the
   phase-4 checkpoint served over HTTP by ``serve.make_server(port=0,
   device="cuda")`` in a thread, with the launch counters from 0 while it
   answers (kernels 1-2 must have risen): requests of 1, 64 and 512
   SMILES, ``"C1CC("`` among them, each ``null`` exactly there and within
   1e-4 pChEMBL of a direct ``Predictor`` call and of the plain path,
   p50 and p99 over 10 requests of each size and the server's own
   featurise/dispatch split; 8 concurrent clients of 64 SMILES with a 2 ms
   coalescing window, served in fewer dispatches than requests; a
   ``Predictor`` call of 1 SMILES timed in this thread, in one long-lived
   thread and in a fresh thread each (why the server dispatches on one
   thread); the batch
   count's power-of-two rounding timed with and without at 520 molecules
   (outputs equal); one ``flagship`` f32 epoch at batch 128 with
   ``dataset_storage="compact"`` beside ``"float32"``: every batch equal
   bit for bit, the first 4 losses (with cuDNN's deterministic
   algorithms) within the gap between two float32 runs (0: bit for bit),
   kernels 1-3 launched, and the device bytes of both;
13. the six baselines and the gat10 ablation: ``gcn``, ``graphsage``,
   ``gat``, ``gat_gcn``, ``gin``, ``chebnet`` and ``model1`` at their
   published widths and batch sizes on the bundled train and validation
   CSVs (no fingerprint; 5-dim nodes for ``gcn``), seed 42.  Each: the
   first 4 losses within rel 1e-4 of a run through the plain versions;
   ``Trainer.fit`` for one epoch with the counters from 0, in which the
   adjacency kernel must launch exactly once per train step and eval batch
   and no other kernel at all; finite metrics; GIN's running statistics
   moved from 0 and 1 and still f32; the best checkpoint served through
   ``Predictor`` within 1e-4 pChEMBL of the trainer's own predictions; ms
   per train step.  Then kernel 1 bit for bit against its plain version on
   the first ``gcn`` (B=32) and ``gat_gcn`` (B=64) batches, timed at B=32
   beside its plain version, the library yardstick and its bound; a GIN
   checkpoint behind ``serve.make_server(port=0, device="cuda")`` answering
   64 SMILES with ``"C1CC("`` among them, ``null`` exactly there; and the
   training CLI with ``--preset gcn --limit 256`` on CUDA; a
   ``torch.profiler`` trace of one GIN epoch (device busy share, device
   launches a step);
14. the fingerprint suite: ``maccs`` (167 bits), ``smifp`` and ``bci``
   (1024 each) at full width, seed 42, on the bundled train and
   validation CSVs; ``bci`` on the first 1024 + 256 molecules only, as
   its host featurisation (Python, descriptors) runs at a few tens of
   molecules a second.  Each: host featurisation in mol/s; the first 4
   losses within rel 1e-4 of a run through the plain versions;
   ``Trainer.fit`` for one epoch with the counters from 0, in which
   kernels 1-3 must launch and kernels 4-5 must not; finite metrics; the
   best checkpoint served through ``Predictor`` within 1e-4 pChEMBL of
   the trainer's own predictions; ms per train step;
15. interpretability: ``explain.hybrid_analysis_strategy`` on the phase-8
   flagship checkpoint (``cnn_pallas_bwd`` off) over the 961 test
   molecules, 200 in detail, ``make_figures=False``, on CUDA, with the
   counters from 0: the launches of kernels 1-3 must equal the counts
   derived from the batches (Stage 1: one adjacency, one forward and one
   backward a batch of 512; Stage 3: per batch of 64, one adjacency and
   one forward for the target and a forward and a backward for each of
   100 mask steps), kernels 4-5 none; ``analysis_results.json`` with 200
   entries, GNNExplainer's importances (no fallback).  Stage 1's
   predictions within 1e-4 pChEMBL of the same stage through the plain
   versions on the card; on every molecule, Stage 1's importances within
   1e-4, Stage 3's per-atom mask norms within 1e-5 and its importances
   within 1e-3 of the plain path (same selection, same generator seed);
   Stage 3 repeats bit for bit.  Stage 1 in
   mol/s, Stage 3 in s, and the host share of the call (device busy time
   of Stages 1 and 3 from a ``torch.profiler`` repeat);
16. kernels 4-5 in bf16: ``flagship_bf16_bs1024_wc`` with
   ``cnn_pallas_bwd=True``, seed 42, on the bundled CSVs.  The first 3
   losses within rel 1e-3 of a run through the plain versions; kernels
   4b's and 5b's registers and spills (ptxas; 4b's setmaxnreg of each
   warpgroup); on the first step's own B=1024,
   W=1024 inputs and at the ragged (B, W) = (3, 37), (5, 2048), and, for
   5b's tiles of TW = 128 positions, (1, TW+1), (1, 1), (2, TW-1) and
   (4, 2 TW); ``dy3`` also, for 4b's chunks of 64 molecules and column
   tiles of 128, at (63, 1), (64, 3), (65, 37), (129, 2), (952, 1024),
   (1025, 5), and at H=512 (its tiles of 64 columns) at (65, 3):
   ``dy3`` within one bf16 ulp per element (or, where the f32 sum
   cancels, within its summation bound ``2 H 2^-24 sum_h |dy w|``) and
   equal on >= 99% of elements, the six gradients within 2e-3 of each
   output's largest magnitude (the limit ``tests/test_torch_cnn_bf16.py``
   states), both kernels bit-for-bit repeatable; one epoch with the
   counters from 0: kernels 1-3 and the bf16 kernels 4-5, these exactly
   once a train step, the f32 ones never; finite metrics, the best
   checkpoint served; remat and ``flagship_bf16sr`` (3 steps each, bf16
   kernels 4-5 once a step).  For information: the two kernels' times,
   their plain versions', their library calls' (bf16 ``torch.matmul`` +
   ``where``; three bf16 ``convolution_backward`` + two ReLU masks), their
   bounds (bytes at 3.35 TB/s against operations at the dense bf16 rate,
   989 TFLOP/s) and shares; ms per bf16 step with and without
   ``cnn_pallas_bwd``; a profile of one epoch;
17. checkpoint interchange and utils: a seeded ``compare.torch_ref.
   TorchHybrid`` on the card written as a reference composite ``.pth``
   (its scaler the fitted ``mean_``/``scale_`` that ``compat`` reads: the
   card's machine has no scikit-learn), imported with ``compat`` and
   served through ``Predictor`` on the 961 test molecules within 1e-4
   pChEMBL of the oracle's own predictions on the card (one molecule a
   call, as the reference infers), kernels 1-2 launched; the export's
   state dicts (``compat.reference_state_dicts``) equal to the composite's
   bit for bit, and their re-import to the first import bit for bit; a
   seeded ``TorchGINNet`` ``state_dict`` imported and served within 1e-4
   of the oracle; ``utils.probe_backend()`` returns ``"cuda"``,
   ``device_memory_stats()`` names the card, ``trace()`` writes a Chrome
   trace holding device kernels;
18. the mesh (``parallel/``): the flagship f32, B=128,
   ``cnn_pallas_bwd=True``, the first 4 steps on the first 512 train
   molecules, each case in processes of its own (``--mesh-worker``, a
   timeout each): (a) NCCL at world size 1 equal to the trainer without a
   mesh bit for bit (both with deterministic algorithms), with the same
   launches of kernels 1-5; (b) 2 ranks on the one card over gloo
   (``--dist-backend gloo``'s path), data=2: 64 rows a rank, kernels 1-5
   once a step on each; (c) 2 ranks over gloo, model=2 (fc1 split):
   ``cnn_pallas_bwd`` turned off with its warning, kernels 1-3 once a
   step, 4-5 never.  (b) and (c) within rel 1e-4 of (a), their ranks
   within rel 1e-6; whether gloo sums bf16 on CUDA tensors; (d) ms a step
   of each, for information; then model=2 over gloo on the other presets
   the reference's rule splits, each against its own run without a mesh
   (rel 1e-4, the ranks within 1e-6), with ms a step: (e) gat_gcn at
   B=64 (``fc_g1`` split; kernel 1 once a step, 2-5 never) and (f)
   ecfp2048 at B=128 (``cnn.fc1``, ``cnn.fc2``, ``combined.fc1`` split;
   kernels 1-3 once a step, 4-5 never).

Kernel times come from CUDA events around back-to-back launches queued
behind a device-side sleep, so the host's launch cost is not in them.

The last two lines are one JSON object listing the kernels (launches from
the ``cnn_pallas_bwd=True`` training epoch, ``bf16_launches`` from phase
11's bf16 epoch, ``serve_launches`` and ``compact_launches`` from phase
12's server and compact epoch, ``baseline_launches`` from phase 13's seven
epochs, ``fingerprint_launches`` from phase 14's three epochs and
``explain_launches`` from phase 15's pipeline call; the adjacency row also
has its times at gcn's B=32 as ``gcn_*``; the bf16 rows of kernels 4-5,
``"dtype": "bfloat16"``, with their launches from phase 16's epoch; each f32
row's ``mesh_launches``, its launches on each rank of phase 18's (b)), then
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, data sheet
F32_FLOPS_PER_S = 67e12      # H100 SXM, f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12    # H100 SXM, dense bf16 on the tensor cores
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


def bound(nbytes, flops, flops_per_s=F32_FLOPS_PER_S):
    """Least time in ms for ``nbytes`` and ``flops`` (at the peak of their
    type: f32, or ``BF16_FLOPS_PER_S``), and which of the two sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# (module, kernel wrapper, plain version) for every kernel: the module is
# where the main path looks the wrapper up at call time; the plain version
# sits beside the wrapper, in the module that defines it
ROUTES = (("ops.graph", "dense_adjacency_cuda", "dense_adjacency_plain"),
          ("ops.attention", "fused_masked_attention_cuda", "attention_plain"),
          ("ops.attention", "attention_bwd_cuda", "attention_bwd_plain"),
          ("ops.cnn", "dy3_cuda", "dy3_plain"),
          ("ops.cnn", "cnn_chain_bwd_cuda", "cnn_chain_bwd_plain"))


@contextlib.contextmanager
def plain_path():
    """Route the serving AND the training path through the plain versions
    of all five kernels (the reference run on the same card)."""
    import importlib

    mods = [importlib.import_module(f"mgat_graphsage_torch.{m}")
            for m, _, _ in ROUTES]
    saved = [getattr(mod, w) for mod, (_, w, _) in zip(mods, ROUTES)]
    for mod, (_, w, plain), fn in zip(mods, ROUTES, saved):
        setattr(mod, w, getattr(sys.modules[fn.__module__], plain))
    try:
        yield
    finally:
        for mod, (_, w, _), fn in zip(mods, ROUTES, saved):
            setattr(mod, w, fn)


@contextlib.contextmanager
def first_calls():
    """Record the arguments of each kernel wrapper's first call on the
    main path (tensors cloned), passing every call on to the wrapper.
    Yields name -> argument tuple."""
    import importlib

    import torch

    mods = [importlib.import_module(f"mgat_graphsage_torch.{m}")
            for m, _, _ in ROUTES]
    saved = [getattr(mod, w) for mod, (_, w, _) in zip(mods, ROUTES)]
    seen = {}

    def spy(name, fn):
        def call(*args, **kw):
            if name not in seen:
                seen[name] = tuple(a.detach().clone() if torch.is_tensor(a)
                                   else a for a in args)
            return fn(*args, **kw)
        # a wrapper counts its launches on the name it is looked up by,
        # the spy while it stands in: the counts move back afterwards
        for c in counters(fn):
            setattr(call, c, getattr(fn, c))
        return call

    spies = [spy(w, fn) for (_, w, _), fn in zip(ROUTES, saved)]
    for mod, (_, w, _), fn in zip(mods, ROUTES, spies):
        setattr(mod, w, fn)
    try:
        yield seen
    finally:
        for mod, (_, w, _), fn, sp in zip(mods, ROUTES, saved, spies):
            setattr(mod, w, fn)
            for c in counters(fn):
                setattr(fn, c, max(getattr(fn, c), getattr(sp, c)))


def wrappers():
    """name -> kernel wrapper (each carries its launch counter)."""
    import importlib

    return {w: getattr(importlib.import_module("mgat_graphsage_torch." + m), w)
            for m, w, _ in ROUTES}


def counters(fn):
    """A wrapper's launch counters: ``launches`` (f32), and
    ``launches_bf16`` for kernels 4-5, which count their bf16 launches
    apart."""
    return [c for c in ("launches", "launches_bf16") if hasattr(fn, c)]


def reset_counts():
    for fn in wrappers().values():
        for c in counters(fn):
            setattr(fn, c, 0)


def read_counts():
    """name -> f32 launches, and name + "_bf16" -> bf16 launches."""
    out = {}
    for name, fn in wrappers().items():
        for c in counters(fn):
            out[name + c[len("launches"):]] = getattr(fn, c)
    return out


def device_events(torch, prof):
    """The profiler's device kernels and copies, without the ranges that
    ``record_function`` annotations (e.g. ``Optimizer.step``) also place on
    the device timeline: those overlap the kernels they enclose."""
    return [ev for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)
            and not ev.key.startswith(("Optimizer.", "ProfilerStep"))]


def bitwise_equal(got, want):
    """Same shape and the same bits, with NaN where the other has NaN (of
    any payload)."""
    import torch

    if got.shape != want.shape:
        return False
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan) and torch.equal(
        got.view(torch.int32)[~nan], want.view(torch.int32)[~nan]))


def order_sensitive_cells(edges, mask, n):
    """Cells of a numpy adjacency case whose f32 sum (before the clamp)
    differs between adding their edges in ascending and in descending
    order: a check that the case can tell the orders apart."""
    b, _, e = edges.shape
    up = np.zeros((b, n, n), np.float32)
    down = np.zeros((b, n, n), np.float32)
    for i in range(b):
        for j in range(e):
            s, d = edges[i, 0, j], edges[i, 1, j]
            if 0 <= s < n and 0 <= d < n:
                up[i, d, s] = np.float32(up[i, d, s] + mask[i, j])
            s, d = edges[i, 0, e - 1 - j], edges[i, 1, e - 1 - j]
            if 0 <= s < n and 0 <= d < n:
                down[i, d, s] = np.float32(down[i, d, s] + mask[i, e - 1 - j])
    return int((up != down).sum())


def rel_err(got, want):
    """max |got - want| over max |want| (0 when both are all zero)."""
    top = want.abs().max().item()
    err = (got - want).abs().max().item()
    return err / top if top > 0 else err


# ---------------------------------------------------------------------------
# training slice: kernels 3-5 against their plain versions, the trainer
# ---------------------------------------------------------------------------

def check_attention_bwd(torch, dev, rng, cases):
    """Kernel 3 against its plain version on every case, residual on and
    off; tolerance: each output within 1e-5 of its largest magnitude."""
    from mgat_graphsage_torch.ops.attention import (
        attention_bwd_cuda, attention_bwd_plain)

    worst = 0.0
    for name, (q, k, v, m) in cases.items():
        g = torch.from_numpy(rng.standard_normal(tuple(q.shape))
                             .astype(np.float32)).to(dev)
        for residual in (True, False):
            got = attention_bwd_cuda(q, k, v, m, g, residual)
            want = attention_bwd_plain(q, k, v, m, g, residual)
            again = attention_bwd_cuda(q, k, v, m, g, residual)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"attention backward kernel does not "
                                     f"repeat bit for bit on {name}")
            errs = [rel_err(a, b) for a, b in zip(got, want)]
            worst = max([worst] + [(a - b).abs().max().item()
                                   for a, b in zip(got, want)])
            if not all(torch.isfinite(a).all() for a in got) \
                    or max(errs) > 1e-5:
                raise AssertionError(f"attention backward kernel differs "
                                     f"on {name} residual={residual}: "
                                     f"relative errors {errs}")
            if (m.sum(1) == 0).any():
                dead = m.sum(1) == 0
                if got[0][dead].abs().max() != 0 or \
                        got[1][dead].abs().max() != 0:
                    raise AssertionError("a fully-masked molecule must get "
                                         "dq = dk_new = 0")
            log(f"[6] attention bwd {name:<10} {tuple(q.shape)} "
                f"residual={residual!s:<5} rel err dq/dk/dv "
                f"{errs[0]:.2e} {errs[1]:.2e} {errs[2]:.2e}, repeats bit for "
                f"bit")
    return worst


def check_attn_bitwise(torch, dev, rng):
    """The attn that kernel 3 recomputes is kernel 2's to the bit: with
    ``v`` and ``g`` one-hot (``[j, c] = 1`` where ``j == c``, N <= F) the
    forward returns ``attn`` and the backward's ``dv`` its transpose, each
    element a sum of one product and exact zeros."""
    from mgat_graphsage_torch.ops.attention import (
        attention_bwd_cuda, fused_masked_attention_cuda)

    for b, n, f in ((16, 32, 35), (16, 80, 128)):
        q, k = (torch.from_numpy(rng.standard_normal((b, n, f))
                                 .astype(np.float32)).to(dev)
                for _ in range(2))
        m = np.zeros((b, n), np.float32)
        for i in range(b):
            m[i, :int(rng.integers(1, n + 1))] = 1.0
        m[-1] = 0.0
        m = torch.from_numpy(m).to(dev)
        eye = torch.zeros((b, n, f), device=dev)
        eye[:, torch.arange(n), torch.arange(n)] = 1.0
        attn = fused_masked_attention_cuda(q, k, eye, m, False)[..., :n]
        dv = attention_bwd_cuda(q, k, eye, m, eye, False)[2][..., :n]
        torch.cuda.synchronize()
        if not torch.equal(attn, dv.transpose(1, 2)):
            err = (attn - dv.transpose(1, 2)).abs().max().item()
            raise AssertionError(f"attn recomputed by the backward differs "
                                 f"from the forward's at {(b, n, f)}: max "
                                 f"|err| {err}")
        log(f"[6] attn recomputed by the backward equals the forward's bit "
            f"for bit at {(b, n, f)}")


def cnn_activations(torch, model, fp):
    """y1, y2 (NCW) and the pos-major y3 [B, W, 128] of the model's CNN
    branch on ``fp``, as the forward keeps them."""
    import torch.nn.functional as F

    cnn = model.cnn
    with torch.no_grad():
        y1 = F.relu(cnn.conv1(fp.unsqueeze(1)))
        y2 = F.relu(cnn.conv2(y1))
        y3 = F.relu(cnn.conv3(y2)).transpose(1, 2).contiguous()
    return y1, y2, y3


def check_cnn_kernels(torch, dev, rng, model, fp):
    """Kernels 4 and 5 against their plain versions at the training shape;
    tolerances relative to each output's largest magnitude: 1e-5 for dy3
    (sums of 256 terms), 1e-4 for the weight and bias gradients (sums over
    B * W = 131,072 positions)."""
    from mgat_graphsage_torch.ops.cnn import (
        cnn_chain_bwd_cuda, cnn_chain_bwd_plain, dy3_cuda, dy3_plain)

    y1, y2, y3 = cnn_activations(torch, model, fp)
    w = model.cnn
    dy = torch.from_numpy((rng.standard_normal((fp.shape[0], 256)) * 0.01)
                          .astype(np.float32)).to(dev)
    fc1_w = w.fc1.weight.detach()
    got = dy3_cuda(dy, fc1_w, y3)
    want = dy3_plain(dy, fc1_w, y3)
    again = dy3_cuda(dy, fc1_w, y3)
    torch.cuda.synchronize()
    e4 = rel_err(got, want)
    if not torch.isfinite(got).all() or e4 > 1e-5:
        raise AssertionError(f"dy3 kernel differs: relative error {e4}")
    if not torch.equal(got, again):
        raise AssertionError("dy3 kernel does not repeat bit for bit")
    log(f"[7] dy3 {tuple(got.shape)} rel err {e4:.2e} (limit 1e-5), "
        f"repeats bit for bit")
    # ragged shapes: a partial molecule tile, more than one (dy streamed
    # with the weight), a partial column tile and reduction chunk, and
    # fewer reduction chunks than ring stages
    for b, h, k in ((61, 256, 4740), (200, 250, 4096), (128, 40, 1024)):
        rd = torch.from_numpy(rng.standard_normal((b, h)).astype(np.float32)
                              ).to(dev)
        rw = torch.from_numpy(rng.standard_normal((h, k)).astype(np.float32)
                              ).to(dev)
        ry = torch.from_numpy(rng.standard_normal((b, k // 4, 4))
                              .astype(np.float32)).to(dev)
        e = rel_err(dy3_cuda(rd, rw, ry), dy3_plain(rd, rw, ry))
        if e > 1e-5:
            raise AssertionError(f"dy3 kernel differs at B={b}, H={h}, "
                                 f"K={k}: relative error {e}")
        log(f"[7] dy3 B={b} H={h} K={k} rel err {e:.2e} (limit 1e-5)")
    args = (want, y2, y1, fp, w.conv3.weight.detach(),
            w.conv2.weight.detach())
    got5 = cnn_chain_bwd_cuda(*args)
    want5 = cnn_chain_bwd_plain(*args)
    torch.cuda.synchronize()
    errs = [rel_err(a, b) for a, b in zip(got5, want5)]
    if not all(torch.isfinite(a).all() for a in got5) or max(errs) > 1e-4:
        raise AssertionError(f"cnn chain kernel differs: {errs}")
    again = cnn_chain_bwd_cuda(*args)
    if not all(torch.equal(a, b) for a, b in zip(got5, again)):
        raise AssertionError("cnn chain kernel does not repeat bit for bit")
    log("[7] cnn chain bwd dw3/db3/dw2/db2/dw1/db1 rel err "
        + " ".join(f"{e:.2e}" for e in errs) + " (limit 1e-4), repeats "
        "bit for bit")
    chain_err = max((a - b).abs().max().item() for a, b in zip(got5, want5))
    # ragged shapes, on random inputs with the ReLU pattern of real
    # activations (about half zero) and fingerprint bits: one ragged tile
    # with W % 4 != 0, a single position, the ecfp2048 width, and more
    # tiles than the training shape
    def relu(*shape):
        return torch.from_numpy(np.maximum(rng.standard_normal(shape), 0)
                                .astype(np.float32)).to(dev)

    for b, wd in ((3, 37), (1, 1), (5, 2048), (200, 1024)):
        rfp = torch.from_numpy((rng.random((b, wd)) < 0.1)
                               .astype(np.float32)).to(dev)
        rargs = (relu(b, wd, 128), relu(b, 64, wd), relu(b, 32, wd), rfp,
                 args[4], args[5])
        rgot = cnn_chain_bwd_cuda(*rargs)
        rwant = cnn_chain_bwd_plain(*rargs)
        ragain = cnn_chain_bwd_cuda(*rargs)
        torch.cuda.synchronize()
        rerrs = [rel_err(a, b) for a, b in zip(rgot, rwant)]
        if not all(torch.isfinite(a).all() for a in rgot) \
                or max(rerrs) > 1e-4:
            raise AssertionError(f"cnn chain kernel differs at B={b}, "
                                 f"W={wd}: {rerrs}")
        if not all(torch.equal(a, c) for a, c in zip(rgot, ragain)):
            raise AssertionError(f"cnn chain kernel does not repeat bit for "
                                 f"bit at B={b}, W={wd}")
        log(f"[7] cnn chain bwd B={b} W={wd} rel err "
            + " ".join(f"{e:.2e}" for e in rerrs) + " (limit 1e-4), "
            "repeats bit for bit")
    return (dy, y1, y2, y3, want, (got - want).abs().max().item(),
            chain_err)


def check_adjacency(torch, dev, rng, seed, edges64, emask64, edges128,
                    emask128):
    """Kernel 1 BITWISE against its plain version on a CPU copy of the
    inputs: the real serving and training batches, a batch of 61, an
    all-zero mask, duplicate edges, N=128, 256 and 300, N=37 with E=175,
    N=1, B=1 and B=133, fractional masks with several edges per cell,
    out-of-range and negative indices, a NaN mask, tensors 4 bytes off a
    16-byte boundary and an edge list too long for shared memory; a
    repeat bit for bit; ``dense_adjacency`` at N=300 must launch.
    Returns the largest |error|."""
    from mgat_graphsage_torch.ops.adjacency import (
        dense_adjacency_cuda, dense_adjacency_plain)
    from mgat_graphsage_torch.ops.graph import dense_adjacency

    n_nodes, n_edges = BUDGET

    def dup_case(b, n, e, frac=False, r=rng):
        """Random edges, every other one twice, the first k real and the
        rest padding; masks 1, or in (0, 0.25) when ``frac``."""
        ed = r.integers(0, n, size=(b, 2, e)).astype(np.int32)
        m = np.zeros((b, e), np.float32)
        for i in range(b):
            k = int(r.integers(1, e + 1))
            m[i, :k] = r.uniform(0.001, 0.25, k) if frac else 1.0
            ed[i, :, k:] = 0                      # padding points at node 0
            ed[i, :, 1:k:2] = ed[i, :, 0:k - 1:2]  # every other edge twice
        return torch.from_numpy(ed).to(dev), torch.from_numpy(m).to(dev)

    # the fractional and edge cases draw from a stream of their own, so the
    # five first cases and the later phases keep their data
    rng1 = np.random.default_rng(seed + 2)

    def oob_case(b, n, e):
        """Indices in [-3, n + 3) and a few far outside: those edges are
        dropped."""
        ed = rng1.integers(-3, n + 3, size=(b, 2, e)).astype(np.int32)
        ed[:, 0, ::17] = n + 1000
        ed[:, 1, 5::23] = -(1 << 30)
        m = rng1.uniform(0.001, 0.5, (b, e)).astype(np.float32)
        return torch.from_numpy(ed).to(dev), torch.from_numpy(m).to(dev)

    def shifted(t):
        """A contiguous copy of ``t`` 4 bytes past a 16-byte boundary."""
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out

    nan_ed, nan_m = dup_case(8, 16, 64, True, rng1)
    nan_m[0, 0] = float("nan")                     # edge 0 is real
    frac_n8 = dup_case(BATCH, 8, n_edges, True, rng1)
    adj_cases = {
        "test64": (edges64, emask64, n_nodes),
        "batch61": (edges64[:61].contiguous(), emask64[:61].contiguous(),
                    n_nodes),
        "empty_mask": (edges64, torch.zeros_like(emask64), n_nodes),
        "duplicates": (*dup_case(BATCH, n_nodes, n_edges), n_nodes),
        "n128": (*dup_case(BATCH, 128, 320), 128),
        "train128": (edges128, emask128, n_nodes),
        "frac_n8": (*frac_n8, 8),
        "frac_n80": (*dup_case(BATCH, n_nodes, n_edges, True, rng1),
                     n_nodes),
        "n256": (*dup_case(16, 256, 560, True, rng1), 256),
        "n300": (*dup_case(16, 300, 660, True, rng1), 300),
        "n37_e175": (*dup_case(16, 37, 175, True, rng1), 37),
        "n1": (*dup_case(4, 1, 8, True, rng1), 1),
        "b1": (*dup_case(1, n_nodes, n_edges, True, rng1), n_nodes),
        "b133": (*dup_case(133, n_nodes, n_edges, True, rng1), n_nodes),
        "out_of_range": (*oob_case(BATCH, n_nodes, n_edges), n_nodes),
        "nan_mask": (nan_ed, nan_m, 16),
        "unaligned": (shifted(edges64), shifted(emask64), n_nodes),
        # 12 bytes an edge past a block's shared memory: the global path
        "big_e": (*dup_case(2, 300, 20_000, True, rng1), 300),
    }
    adj_err = 0.0
    for name, (ed, em, n) in adj_cases.items():
        got = dense_adjacency_cuda(ed, em, n)
        # the reference: the plain version on a CPU copy, on one thread,
        # which sums each cell in ascending edge order (from 32,768 edges
        # on, PyTorch's CPU index_put_ adds floats from several threads in
        # no fixed order).  The plain version on the card may add a cell's
        # fractional masks in another order too, so it is a reference only
        # for 0/1 masks, where every order gives the same small integers.
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        want = dense_adjacency_plain(ed.cpu(), em.cpu(), n)
        torch.set_num_threads(threads)
        on_card = dense_adjacency_plain(ed, em, n)
        torch.cuda.synchronize()
        got = got.cpu()
        err = (got - want).nan_to_num(nan=0.0).abs().max().item()
        adj_err = max(adj_err, err)
        if not bitwise_equal(got, want):
            raise AssertionError(f"adjacency kernel differs from its plain "
                                 f"version on {name}: max |err| {err}")
        binary = bool(((em == 0) | (em == 1)).all())
        card_same = bitwise_equal(on_card.cpu(), want)
        if binary and not card_same:
            raise AssertionError(f"the plain version on the card differs from "
                                 f"the CPU's on 0/1 masks ({name})")
        log(f"[2] adjacency {name:<12} {tuple(got.shape)} bitwise equal to "
            f"the plain version on the CPU ({int((want != 0).sum())} nonzero, "
            f"masks {'0/1' if binary else 'fractional'}; plain on the card "
            f"{'equal' if card_same else 'differs'})")
    # the fractional cases must tell the summation orders apart
    for name in ("frac_n8", "frac_n80", "n300"):
        ed, em, n = adj_cases[name]
        cells = order_sensitive_cells(ed.cpu().numpy(), em.cpu().numpy(), n)
        if cells == 0:
            raise AssertionError(f"{name}: no cell depends on the order of "
                                 "its additions")
        log(f"[2] adjacency {name}: {cells} cells whose f32 sum "
            f"changes if the edges are added in descending order")
    again = dense_adjacency_cuda(*frac_n8, 8).cpu()
    if not bitwise_equal(again, dense_adjacency_cuda(*frac_n8, 8).cpu()):
        raise AssertionError("adjacency kernel does not repeat bit for bit")
    nan_adj = dense_adjacency_cuda(nan_ed, nan_m, 16)
    if not torch.isnan(nan_adj).any():
        raise AssertionError("a NaN mask must give a NaN cell")
    before = dense_adjacency_cuda.launches
    dense_adjacency(*adj_cases["n300"])
    if dense_adjacency_cuda.launches != before + 1:
        raise AssertionError("dense_adjacency at N=300 did not launch the "
                             "kernel")
    log("[2] adjacency repeats bit for bit (frac_n8), a NaN mask gives NaN, "
        "and dense_adjacency at N=300 launches the kernel")
    return adj_err


def adjacency_times(torch, timer, ed, em, n):
    """Kernel 1, its plain version and the library's yardstick (zeros,
    ``index_add_`` with atomics and ``clamp_max_``: three calls, on the flat
    index built here, outside the timing) in ms on 0/1 masks, and the
    kernel's bound (bytes or operations)."""
    from mgat_graphsage_torch.ops.adjacency import (
        dense_adjacency_cuda, dense_adjacency_plain)

    bb, _, e = ed.shape
    ok = ((ed[:, 0] >= 0) & (ed[:, 0] < n) & (ed[:, 1] >= 0)
          & (ed[:, 1] < n))
    flat = (torch.arange(bb, device=ed.device).view(bb, 1) * n * n
            + ed[:, 1].long() * n + ed[:, 0].long())[ok]
    vals = em[ok]

    def lib_adj():
        return torch.zeros(bb * n * n, device=ed.device).index_add_(
            0, flat, vals).clamp_max_(1.0)

    if not bitwise_equal(lib_adj().view(bb, n, n),
                         dense_adjacency_cuda(ed, em, n)):
        raise AssertionError("index_add_ yardstick differs from the "
                             "adjacency kernel on 0/1 masks")
    return (timer(lambda: dense_adjacency_cuda(ed, em, n)),
            timer(lambda: dense_adjacency_plain(ed, em, n)),
            timer(lib_adj),
            bound(bb * 3 * e * 4 + bb * n * n * 4, bb * e))


def first_steps(torch, Trainer, cfg, train, val, steps=4):
    """The losses of the first ``steps`` train steps from cfg.seed, in the
    epoch-0 batch order with the epoch-0 dropout generator."""
    trainer = Trainer(cfg, train, val)
    state = trainer.init_state()
    gen = trainer._dropout_generator(0)
    losses = []
    for i, batch in enumerate(trainer._batches(
            train, cfg.batch_size, np.random.default_rng(cfg.seed))):
        if i == steps:
            break
        losses.append(trainer.train_step(state, batch, gen)["loss"].item())
    return np.array(losses)


def time_steps(torch, trainer, state, data, iters=20):
    """ms per train step in steady state (host clock, synchronised), with
    the bf16 working copy carried from step to step as in an epoch."""
    batches = list(trainer._batches(data, trainer.cfg.batch_size,
                                    np.random.default_rng(0)))
    copy = trainer.compute_copy(state.model)
    for b in batches[:3]:
        trainer.train_step(state, b, params_c=copy)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        trainer.train_step(state, batches[i % len(batches)], params_c=copy)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def three_steps(Trainer, c, train_ds):
    """The first 3 train steps of config ``c`` (its epoch-0 batch order,
    dropout generator and carried working copy), counters from 0:
    ``(losses, launches, state)``."""
    t = Trainer(c, train_ds)
    st = t.init_state()
    gen = t._dropout_generator(0)
    copy = t.compute_copy(st.model)
    reset_counts()
    batches = t._batches(train_ds, c.batch_size,
                         np.random.default_rng(c.seed))
    out = [t.train_step(st, next(batches), gen, copy)["loss"].item()
           for _ in range(3)]
    return np.array(out), read_counts(), st


def bf16_phase(torch, train_ds, val_ds, val_smiles, test_smiles, tmpdir,
               card, timer):
    """Phase 11: the production preset ``flagship_bf16_bs1024_wc`` (bf16
    compute and Adam moments, the carried bf16 working copy, batch 1024, 3
    steps an epoch) and the other mixed-precision knobs on the card.
    Returns the launches of kernels 1-5 in the bf16 epoch."""
    from torch.profiler import ProfilerActivity, profile

    from mgat_graphsage_torch.eval.predict import Predictor
    from mgat_graphsage_torch.ops.adjacency import (
        dense_adjacency_cuda, dense_adjacency_plain)
    from mgat_graphsage_torch.ops.attention import (
        attention_bwd_cuda, attention_bwd_plain, attention_plain,
        fused_masked_attention_cuda)
    from mgat_graphsage_torch.train import Trainer, get_config
    from mgat_graphsage_torch.train.optim import TorchAdam

    t_phase = time.perf_counter()
    cfg = get_config("flagship_bf16_bs1024_wc", epochs=1)
    bs = cfg.batch_size
    # the first 3 steps on the kernels and on the plain versions; bf16
    # rounds both runs' products alike, so their f32 attention's last
    # bits are all that differ before the updates
    with first_calls() as seen:
        losses = first_steps(torch, Trainer, cfg, train_ds, val_ds, steps=3)
    with plain_path():
        plain = first_steps(torch, Trainer, cfg, train_ds, val_ds, steps=3)
    step_err = float(np.max(np.abs(losses - plain) / np.abs(plain)))
    if not np.isfinite(losses).all() or step_err > 1e-4:
        raise AssertionError(f"bf16 preset: first 3 losses {losses} vs plain "
                             f"path {plain} (limit rel 1e-4)")
    # kernels 1-3 on the first bf16 step's own inputs at B=1024, against
    # their plain versions at the limits of phases 2, 3 and 6
    a = seen["dense_adjacency_cuda"]
    if a[0].shape[0] != bs or not bitwise_equal(
            dense_adjacency_cuda(*a), dense_adjacency_plain(*a)):
        raise AssertionError(f"adjacency kernel at the bf16 step's shape "
                             f"{tuple(a[0].shape)} differs from its plain "
                             f"version")
    a = seen["fused_masked_attention_cuda"]
    got, want = fused_masked_attention_cuda(*a), attention_plain(*a)
    fwd_err = (got - want).abs().max().item()
    if a[0].shape[0] != bs or not (torch.isfinite(got).all() and
                                   torch.allclose(got, want, atol=1e-5,
                                                  rtol=1e-5)):
        raise AssertionError(f"attention kernel at the bf16 step's shape "
                             f"{tuple(a[0].shape)}: max |err| {fwd_err}")
    a = seen["attention_bwd_cuda"]
    bwd_errs = [rel_err(x, y) for x, y in zip(attention_bwd_cuda(*a),
                                               attention_bwd_plain(*a))]
    if a[0].shape[0] != bs or not max(bwd_errs) <= 1e-5:
        raise AssertionError(f"attention backward kernel at the bf16 step's "
                             f"shape {tuple(a[0].shape)}: relative errors "
                             f"dq/dk/dv {bwd_errs}")
    log(f"[11] kernels on the first bf16 step's inputs: adjacency "
        f"{tuple(seen['dense_adjacency_cuda'][0].shape)} bit for bit, "
        f"attention {tuple(a[0].shape)} max |err| {fwd_err:.3e} (limit "
        f"1e-5), attention bwd rel err dq/dk/dv "
        f"{' '.join(f'{e:.2e}' for e in bwd_errs)} (limit 1e-5)")
    ckdir = os.path.join(tmpdir, "bf16")
    trainer = Trainer(cfg, train_ds, val_ds, ckpt_dir=ckdir)
    reset_counts()
    t0 = time.perf_counter()
    _, best, hist = trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = read_counts()
    for name in ("dense_adjacency_cuda", "fused_masked_attention_cuda",
                 "attention_bwd_cuda"):
        if counts[name] <= 0:
            raise AssertionError(f"the bf16 epoch never launched {name}")
    if any(counts[k] for k in ("dy3_cuda", "cnn_chain_bwd_cuda",
                               "dy3_cuda_bf16", "cnn_chain_bwd_cuda_bf16")):
        raise AssertionError(f"the CNN kernels ran in the bf16 epoch: "
                             f"{counts}")
    row = hist[-1]
    if not all(np.isfinite(row[k]) for k in ("train_loss", "val_mse",
                                              "original_mse")):
        raise AssertionError(f"non-finite bf16 training metrics: {row}")
    if any(p.dtype != torch.float32 for p in best.model.parameters()):
        raise AssertionError("the bf16 preset's master is not f32")
    ckpt = os.path.join(ckdir, "best_model.pt")
    req = list(val_smiles)
    req.insert(len(req) // 2, BAD)
    bf16_pred = Predictor(ckpt, infer_dtype="bfloat16")
    if any(p.dtype != torch.bfloat16 for p in bf16_pred.model.parameters()):
        raise AssertionError("the bf16 Predictor holds non-bf16 weights")
    served = bf16_pred(req)
    served32 = Predictor(ckpt)(req)
    bad = np.array([s == BAD for s in req])
    gap = float(np.abs(served[~bad] - served32[~bad]).max()
                / train_ds.scaler.scale_)
    if not (np.isnan(served) == ~np.isfinite(served32)).all() \
            or not np.isnan(served[bad]).all() \
            or not np.isfinite(served[~bad]).all() or gap > 0.05:
        raise AssertionError(f"bf16 serving of the best checkpoint: gap "
                             f"{gap} (normalised, limit 0.05), NaN slots "
                             f"{np.flatnonzero(np.isnan(served))}")
    log(f"[11] flagship_bf16_bs1024_wc (batch {bs}, "
        f"{-(-len(train_ds) // bs)} steps an epoch): first 3 losses "
        f"{np.round(losses, 6)} vs plain path rel err {step_err:.2e} "
        f"(limit 1e-4); one epoch {fit_s:.2f} s (train "
        f"{row['epoch_time_s']:.2f} s incl. first-step warm-up), loss "
        f"{row['train_loss']:.4f}, val MSE {row['val_mse']:.4f}, original "
        f"MSE {row['original_mse']:.4f}; launches {counts}; best checkpoint "
        f"served in bf16 within {gap:.2e} (normalised) of f32 serving, NaN "
        f"exactly for {BAD!r}")

    # remat: the same 3 steps, the forward's kernels launched twice a step
    plain3, c_plain, _ = three_steps(Trainer, cfg, train_ds)
    remat3, c_remat, _ = three_steps(Trainer, cfg.replace(remat=True),
                                     train_ds)
    remat_err = float(np.max(np.abs(remat3 - plain3) / np.abs(plain3)))
    fwd = ("dense_adjacency_cuda", "fused_masked_attention_cuda")
    if remat_err > 1e-3 or any(c_remat[k] != 2 * c_plain[k] for k in fwd) \
            or c_remat["attention_bwd_cuda"] != c_plain["attention_bwd_cuda"]:
        raise AssertionError(f"remat: losses {remat3} vs {plain3}, launches "
                             f"{c_remat} vs {c_plain}")
    log(f"[11] remat: 3 steps rel err {remat_err:.2e} (limit 1e-3) from the "
        f"run without; forward launches doubled "
        f"({', '.join(f'{k} {c_plain[k]} -> {c_remat[k]}' for k in fwd)}), "
        f"attention bwd {c_remat['attention_bwd_cuda']}")

    sr3, _, st_sr = three_steps(Trainer, get_config("flagship_bf16sr",
                                                    epochs=1), train_ds)
    if not np.isfinite(sr3).all() or any(
            p.dtype != torch.bfloat16 for p in st_sr.model.parameters()):
        raise AssertionError(f"flagship_bf16sr: losses {sr3}")
    log(f"[11] flagship_bf16sr (bf16 master, stochastic rounding): 3 steps "
        f"losses {np.round(sr3, 6)}, parameters bf16")
    cli = subprocess.run(
        [sys.executable, "-m", "mgat_graphsage_torch.train.run", "--preset",
         "flagship", "--mixed-precision", "--limit", "256", "--epochs", "1",
         "--ckpt-dir", os.path.join(tmpdir, "cli_bf16")], cwd=REPO,
        capture_output=True, text=True, timeout=600)
    if cli.returncode != 0 or "Training completed" not in cli.stdout:
        raise AssertionError(f"the bf16 training CLI failed:\n{cli.stdout}\n"
                             f"{cli.stderr}")
    log("[11] python -m mgat_graphsage_torch.train.run --preset flagship "
        "--mixed-precision --limit 256 --epochs 1 on CUDA: "
        + cli.stdout.strip().splitlines()[0])

    # information: step times at batch 1024, bf16 serving, the epoch profile
    for name, c in (("flagship f32", get_config("flagship",
                                                batch_size=bs)),
                    ("flagship_bf16_bs1024_wc", cfg)):
        t = Trainer(c, train_ds)
        ms = time_steps(torch, t, t.init_state(), train_ds, iters=12)
        log(f"[11] train step, {name} B={bs}: {ms:.3f} ms "
            f"({bs / ms * 1e3:.1f} mol/s), on {card}")
    # the f32 flagship's optimizer at its preset's batch: the port's
    # TorchAdam against torch.optim.Adam (foreach, the default on CUDA,
    # and fused; timed here only), whole train steps in the order
    # A B C C B A and the optimizer step alone on random gradients
    c32 = get_config("flagship")
    t32 = Trainer(c32, train_ds)
    kw = dict(lr=c32.lr, weight_decay=c32.weight_decay)
    makers = {"TorchAdam": lambda ps: TorchAdam(ps, **kw),
              "torch.optim.Adam": lambda ps: torch.optim.Adam(ps, **kw),
              "torch.optim.Adam(fused=True)":
                  lambda ps: torch.optim.Adam(ps, fused=True, **kw)}
    step32 = {k: [] for k in makers}
    alone = {}
    for name in list(makers) + list(makers)[::-1]:
        st = t32.init_state()
        st.optimizer = makers[name](st.model.parameters())
        step32[name].append(time_steps(torch, t32, st, train_ds, iters=20))
        if name not in alone:
            gen = torch.Generator(device="cuda").manual_seed(0)
            for q in st.model.parameters():
                q.grad = torch.randn(q.shape, device="cuda", generator=gen)
            alone[name] = timer(st.optimizer.step, iters=20)
    for name in makers:
        log(f"[11] f32 flagship B={c32.batch_size}, optimizer {name}: train "
            f"step {' '.join(f'{ms:.3f}' for ms in step32[name])} ms "
            f"(host clock, two runs), optimizer step alone "
            f"{alone[name]:.3f} ms (device), on {card}")
    bf16_pred(test_smiles)
    bf16_pred(test_smiles)
    ft = bf16_pred.last_timings
    n = len(test_smiles)
    log(f"[11] bf16 Predictor on {n} test molecules: "
        f"{n / (ft['featurize_s'] + ft['dispatch_s']):.1f} mol/s end to end; "
        f"host featurisation {ft['featurize_s']:.3f} s "
        f"({n / ft['featurize_s']:.1f} mol/s), device "
        f"{ft['dispatch_s']:.3f} s ({n / ft['dispatch_s']:.1f} mol/s), on "
        f"{card}")
    st = trainer.init_state()
    trainer.train_epoch(st, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_epoch(st, 1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = device_events(torch, prof)
    busy_us = sum(ev.self_device_time_total for ev in kern)
    log(f"[11] profile of one bf16 epoch ({-(-len(train_ds) // bs)} steps of "
        f"{bs}): wall {wall_us:.0f} us, device busy {busy_us:.0f} us "
        f"({100 * busy_us / wall_us:.2f}%), on {card}; top kernels:")
    ranked = sorted(kern, key=lambda ev: -ev.self_device_time_total)
    ours = ("dense_adjacency_kernel", "masked_attention_kernel",
            "masked_attention_bwd_kernel")
    for i, ev in enumerate(ranked):
        if i < 12 or any(o in ev.key for o in ours):
            log(f"  #{i + 1:<3d}{ev.self_device_time_total:9.1f} us  "
                f"x{ev.count:<4d} {ev.key[:90]}")
    log(f"[11] phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# kernels 4-5 in bf16 on the bf16 training path
# ---------------------------------------------------------------------------

CHAIN_BF16_LIMIT = 2e-3   # tests/test_torch_cnn_bf16.py states and measures it


def bf16_ulp(torch, x):
    """The spacing of bf16 values at |x| (f32 tensor): the next bf16 above
    |x| minus |x|."""
    a = x.abs().float()
    return (a.view(torch.int32) + 0x10000).view(torch.float32) - a


def check_dy3_bf16(torch, dy, fc1_w, y3, where):
    """Kernel 4 in bf16 against its plain version: each element within one
    bf16 ulp, or, where the f32 sum cancels below its own rounding error,
    within that error's bound 2 H 2^-24 sum_h |dy w| (the two sum in other
    orders, then round once); equal on >= 99% of elements; bit-for-bit
    repeats.  Returns the max |err|."""
    from mgat_graphsage_torch.ops.cnn import dy3_cuda, dy3_plain

    got = dy3_cuda(dy, fc1_w, y3)
    want = dy3_plain(dy, fc1_w, y3)
    again = dy3_cuda(dy, fc1_w, y3)
    torch.cuda.synchronize()
    if got.dtype != torch.bfloat16 or not torch.equal(
            got.view(torch.int16), again.view(torch.int16)):
        raise AssertionError(f"bf16 dy3 kernel at {where}: dtype {got.dtype} "
                             "or it does not repeat bit for bit")
    g, w = got.float(), want.float()
    gap = (g - w).abs()
    ulp = bf16_ulp(torch, torch.maximum(g.abs(), w.abs()))
    terms = torch.matmul(dy.float().abs(), fc1_w.float().abs()).view(y3.shape)
    f32_bound = 2 * dy.shape[1] * 2.0 ** -24 * terms
    over = int((gap > torch.maximum(ulp, f32_bound)).sum())
    past_ulp = int((gap > ulp).sum())
    equal = float((gap == 0).float().mean())
    if not torch.isfinite(g).all() or over or equal < 0.99:
        raise AssertionError(f"bf16 dy3 kernel at {where}: {over} elements "
                             f"beyond one ulp and the f32 bound, equal on "
                             f"{equal:.6f} (limit 0.99)")
    log(f"[16] dy3 bf16 {where} {tuple(got.shape)}: equal on "
        f"{100 * equal:.4f}% of elements, {past_ulp} past one ulp (all "
        f"within the f32 summation bound), max |err| {gap.max().item():.3e}, "
        f"repeats bit for bit")
    return gap.max().item()


def check_chain_bf16(torch, args, where):
    """Kernel 5 in bf16 against its plain version: each f32 output within
    CHAIN_BF16_LIMIT of its largest magnitude; bit-for-bit repeats.
    Returns the max |err|."""
    from mgat_graphsage_torch.ops.cnn import (
        cnn_chain_bwd_cuda, cnn_chain_bwd_plain)

    got = cnn_chain_bwd_cuda(*args)
    want = cnn_chain_bwd_plain(*args)
    again = cnn_chain_bwd_cuda(*args)
    torch.cuda.synchronize()
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    if not all(torch.isfinite(a).all() and a.dtype == torch.float32
               for a in got) or max(errs) > CHAIN_BF16_LIMIT:
        raise AssertionError(f"bf16 cnn chain kernel at {where}: relative "
                             f"errors {errs} (limit {CHAIN_BF16_LIMIT})")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"bf16 cnn chain kernel at {where} does not "
                             "repeat bit for bit")
    log(f"[16] cnn chain bwd bf16 {where}: dw3/db3/dw2/db2/dw1/db1 rel err "
        + " ".join(f"{e:.2e}" for e in errs)
        + f" (limit {CHAIN_BF16_LIMIT:g}), repeats bit for bit")
    return max((a - b).abs().max().item() for a, b in zip(got, want))


def bf16_cnn_phase(torch, train_ds, val_ds, val_smiles, tmpdir, card,
                   timer):
    """Phase 16: kernels 4-5 in bf16 on ``flagship_bf16_bs1024_wc`` with
    ``cnn_pallas_bwd=True``.  Returns the bf16 rows' numbers."""
    from torch.profiler import ProfilerActivity, profile

    from mgat_graphsage_torch.eval.predict import Predictor
    from mgat_graphsage_torch.ops import _build
    from mgat_graphsage_torch.ops.cnn import (
        _TILE_W_BF16, cnn_chain_bwd_cuda, cnn_chain_bwd_plain, dy3_cuda,
        dy3_plain)
    from mgat_graphsage_torch.train import Trainer, get_config

    t_phase = time.perf_counter()
    for line in _build.ptxas_report("cnn_chain_bwd"):
        if "bf16" in line:
            log(f"[16] ptxas cnn_chain_bwd.cu {line}")
    with open(os.path.join(_build.CSRC_DIR, "cnn_dy3.cu")) as fh:
        regs = dict(re.findall(r"constexpr int k(Producer|Consumer)Regs = "
                               r"(\d+);", fh.read()))
    ignored = "C7508" in _build.BUILD_LOGS.get("cnn_dy3", "")
    for line in _build.ptxas_report("cnn_dy3"):
        if "bf16" in line:
            log(f"[16] ptxas cnn_dy3.cu {line}; setmaxnreg: producer "
                f"warpgroup {regs['Producer']}, consumer warpgroups "
                f"{regs['Consumer']}" + (" (IGNORED by ptxas)" if ignored
                                         else ""))
    bf16 = torch.bfloat16
    cfg = get_config("flagship_bf16_bs1024_wc", epochs=1,
                     cnn_pallas_bwd=True)
    bs = cfg.batch_size
    # the first 3 steps through the kernels and through the plain versions
    with first_calls() as seen:
        losses = first_steps(torch, Trainer, cfg, train_ds, val_ds, steps=3)
    with plain_path():
        plain = first_steps(torch, Trainer, cfg, train_ds, val_ds, steps=3)
    step_err = float(np.max(np.abs(losses - plain) / np.abs(plain)))
    if not np.isfinite(losses).all() or step_err > 1e-3:
        raise AssertionError(f"bf16 cnn_pallas_bwd: first 3 losses {losses} "
                             f"vs plain path {plain} (limit rel 1e-3)")
    log(f"[16] flagship_bf16_bs1024_wc, cnn_pallas_bwd=True: first 3 losses "
        f"{np.round(losses, 6)} vs plain path rel err {step_err:.2e} (limit "
        f"1e-3)")
    # kernels 4-5 on the first step's own inputs at B=1024
    a4 = seen["dy3_cuda"]
    a5 = seen["cnn_chain_bwd_cuda"]
    if a4[0].shape[0] != bs or any(t.dtype != bf16 for t in a4 + a5):
        raise AssertionError(f"the first bf16 step's kernel 4-5 inputs: "
                             f"{[(tuple(t.shape), t.dtype) for t in a4 + a5]}")
    dy3_err = check_dy3_bf16(torch, *a4, "first step")
    chain_err = check_chain_bf16(torch, a5, f"first step B={bs} "
                                 f"W={a5[3].shape[1]}")
    # ragged shapes on random bf16 inputs
    gen = torch.Generator(device="cuda").manual_seed(16)

    def rnd(*shape, scale=1.0, relu=False):
        x = torch.randn(shape, device="cuda", generator=gen) * scale
        return (x.clamp_min(0) if relu else x).to(bf16)

    # ragged shapes for kernel 5b's tiles of _TILE_W_BF16 positions: W below
    # a tile and W % 8 != 0 (its windows then take plain loads), B=1, one
    # position past a tile, a last tile one short, whole tiles
    tw = _TILE_W_BF16
    for b, wd in ((3, 37), (5, 2048), (1, tw + 1), (1, 1), (2, tw - 1),
                  (4, 2 * tw)):
        h = a4[0].shape[1]
        dy3_err = max(dy3_err, check_dy3_bf16(
            torch, rnd(b, h, scale=0.01), rnd(h, wd * 128, scale=0.01),
            rnd(b, wd, 128, relu=True), f"B={b} W={wd}"))
        rfp = (torch.rand((b, wd), device="cuda", generator=gen) < 0.1
               ).to(bf16)
        chain_err = max(chain_err, check_chain_bf16(
            torch, (rnd(b, wd, 128, relu=True), rnd(b, 64, wd, relu=True),
                    rnd(b, 32, wd, relu=True), rfp, a5[4], a5[5]),
            f"B={b} W={wd}"))

    # ragged shapes for kernel 4b's chunks of 64 molecules and tiles of 128
    # columns: a chunk short, whole, one past; W=1; the padded batch's own
    # width with B=952 (a real batch before padding) and B=1025; H=512,
    # where the tiles are 64 columns wide
    for b, wd, h in ((63, 1, 256), (64, 3, 256), (65, 37, 256),
                     (129, 2, 256), (952, 1024, 256), (1025, 5, 256),
                     (65, 3, 512)):
        dy3_err = max(dy3_err, check_dy3_bf16(
            torch, rnd(b, h, scale=0.01), rnd(h, wd * 128, scale=0.01),
            rnd(b, wd, 128, relu=True), f"B={b} W={wd} H={h}"))

    # one epoch through the kernels, counters from 0
    ckdir = os.path.join(tmpdir, "bf16_cnn")
    trainer = Trainer(cfg, train_ds, val_ds, ckpt_dir=ckdir)
    steps = -(-len(train_ds) // bs)
    reset_counts()
    t0 = time.perf_counter()
    _, best, hist = trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = read_counts()
    for name in ("dense_adjacency_cuda", "fused_masked_attention_cuda",
                 "attention_bwd_cuda"):
        if counts[name] <= 0:
            raise AssertionError(f"the bf16 epoch never launched {name}")
    if counts["dy3_cuda_bf16"] != steps \
            or counts["cnn_chain_bwd_cuda_bf16"] != steps \
            or counts["dy3_cuda"] or counts["cnn_chain_bwd_cuda"]:
        raise AssertionError(f"kernels 4-5 in the bf16 epoch of {steps} "
                             f"steps: launches {counts}")
    row = hist[-1]
    if not all(np.isfinite(row[k]) for k in ("train_loss", "val_mse",
                                              "original_mse")):
        raise AssertionError(f"non-finite metrics: {row}")
    served = Predictor(os.path.join(ckdir, "best_model.pt"))(val_smiles)
    if served.shape != (len(val_smiles),) or not np.isfinite(served).all():
        raise AssertionError("the best checkpoint does not serve")
    log(f"[16] one epoch ({steps} steps of {bs}) {fit_s:.2f} s, loss "
        f"{row['train_loss']:.4f}, val MSE {row['val_mse']:.4f}, original "
        f"MSE {row['original_mse']:.4f}; launches {counts}; best checkpoint "
        f"served on {len(val_smiles)} validation molecules, finite")

    # remat: kernels 4-5 once a step; the bf16 master
    _, c_remat, _ = three_steps(Trainer, cfg.replace(remat=True), train_ds)
    if c_remat["dy3_cuda_bf16"] != 3 or c_remat["cnn_chain_bwd_cuda_bf16"] != 3:
        raise AssertionError(f"remat with cnn_pallas_bwd: 3 steps, launches "
                             f"{c_remat}")
    sr3, c_sr, st_sr = three_steps(Trainer, get_config(
        "flagship_bf16sr", epochs=1, cnn_pallas_bwd=True), train_ds)
    if not np.isfinite(sr3).all() or c_sr["dy3_cuda_bf16"] != 3 or any(
            p.dtype != bf16 for p in st_sr.model.parameters()):
        raise AssertionError(f"flagship_bf16sr with cnn_pallas_bwd: losses "
                             f"{sr3}, launches {c_sr}")
    log(f"[16] remat: 3 steps, kernels 4-5 {c_remat['dy3_cuda_bf16']} and "
        f"{c_remat['cnn_chain_bwd_cuda_bf16']} launches; flagship_bf16sr: "
        f"3 steps losses {np.round(sr3, 6)}, parameters bf16")

    # times on the first step's inputs, for information
    dy, fc1_w, y3 = a4
    d3, y2, y1, fp, w3, w2 = a5
    w1 = best.model.cnn.conv1.weight.detach().to(bf16)
    bb, ww = fp.shape
    hh = dy.shape[1]
    k4 = dict(ms=timer(lambda: dy3_cuda(dy, fc1_w, y3)),
              plain_ms=timer(lambda: dy3_plain(dy, fc1_w, y3), iters=20),
              library_ms=timer(lambda: torch.where(y3 > 0, torch.matmul(
                  dy, fc1_w).view(y3.shape), 0.0)),
              bound=bound(2 * (bb * hh + hh * ww * 128 + 2 * bb * ww * 128),
                          2 * bb * hh * ww * 128, BF16_FLOPS_PER_S))
    d3_ncw = d3.transpose(1, 2).contiguous()
    conv_bwd = torch.ops.aten.convolution_backward

    def lib5():
        gi2, _, _ = conv_bwd(d3_ncw, y2, w3, [128], [1], [1], [1], False,
                             [0], 1, [True, True, True])
        gi1, _, _ = conv_bwd(gi2 * (y2 > 0), y1, w2, [64], [1], [1], [1],
                             False, [0], 1, [True, True, True])
        return conv_bwd(gi1 * (y1 > 0), fp.unsqueeze(1), w1, [32], [1], [1],
                        [1], False, [0], 1, [False, True, True])

    k5 = dict(ms=timer(lambda: cnn_chain_bwd_cuda(*a5), iters=20),
              plain_ms=timer(lambda: cnn_chain_bwd_plain(*a5), iters=10),
              library_ms=timer(lib5, iters=20),
              bound=bound(2 * (bb * ww * (128 + 64 + 32 + 1) + 128 * 64 * 3
                               + 64 * 32 * 3) + 4 * 31040,
                          2 * bb * ww * (2 * 3 * (128 * 64 + 64 * 32)
                                         + 32 * 3)
                          + bb * ww * (128 + 64 + 32), BF16_FLOPS_PER_S))
    for name, k, calls in (
            ("dy3", k4, "bf16 torch.matmul + where (two calls)"),
            ("cnn chain bwd", k5, "3 bf16 convolution_backward + 2 ReLU "
                                  "masks (five calls)")):
        bms, by = k["bound"]
        log(f"[16] {name} bf16 at B={bb}, W={ww}: kernel "
            f"{k['ms'] * 1e3:.2f} us, plain {k['plain_ms'] * 1e3:.2f} us, "
            f"library {k['library_ms'] * 1e3:.2f} us ({calls}), bound "
            f"{bms * 1e3:.2f} us ({by}), bound share {bms / k['ms']:.4f}, "
            f"{steps} launches an epoch of {steps} steps, on {card}")
    for pb in (False, True):
        t = Trainer(cfg.replace(cnn_pallas_bwd=pb), train_ds)
        ms = time_steps(torch, t, t.init_state(), train_ds, iters=12)
        log(f"[16] train step, flagship_bf16_bs1024_wc B={bs}, "
            f"cnn_pallas_bwd={pb}: {ms:.3f} ms ({bs / ms * 1e3:.1f} mol/s), "
            f"on {card}")
    st = trainer.init_state()
    trainer.train_epoch(st, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_epoch(st, 1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = device_events(torch, prof)
    busy_us = sum(ev.self_device_time_total for ev in kern)
    log(f"[16] profile of one bf16 epoch with cnn_pallas_bwd ({steps} steps "
        f"of {bs}): wall {wall_us:.0f} us, device busy {busy_us:.0f} us "
        f"({100 * busy_us / wall_us:.2f}%), on {card}; top kernels:")
    ranked = sorted(kern, key=lambda ev: -ev.self_device_time_total)
    ours = ("dense_adjacency_kernel", "masked_attention_kernel",
            "masked_attention_bwd_kernel", "cnn_dy3_bf16_kernel",
            "cnn_chain_bwd_bf16_kernel", "cnn_chain_sum_kernel")
    for i, ev in enumerate(ranked):
        if i < 12 or any(o in ev.key for o in ours):
            log(f"  #{i + 1:<3d}{ev.self_device_time_total:9.1f} us  "
                f"x{ev.count:<4d} {ev.key[:90]}")
    log(f"[16] phase 16 took {time.perf_counter() - t_phase:.1f} s")
    rows = []
    for name, k, cname, err, src, line in (
            ("cnn_dy3_bf16", k4, "dy3_cuda_bf16", dy3_err, "cnn_dy3", 127),
            ("cnn_chain_bwd_bf16", k5, "cnn_chain_bwd_cuda_bf16", chain_err,
             "cnn_chain_bwd", 264)):
        rows.append({
            "name": name, "route": "cuda",
            "source": f"mgat_graphsage_torch/csrc/{src}.cu",
            "replaces": f"mgat_graphsage_tpu/ops/pallas_cnn.py:{line}",
            "launches": counts[cname], "max_abs_err": err, "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound"][0],
            "bound_by": k["bound"][1], "bound_share": k["bound"][0] / k["ms"],
            "library_ms": k["library_ms"], "dtype": "bfloat16"})
    return rows


# ---------------------------------------------------------------------------
# reference-checkpoint interchange and tooling
# ---------------------------------------------------------------------------

class RefScaler:
    """The fitted attributes of the sklearn ``StandardScaler`` that a
    reference composite pickles (``mean_``, ``scale_`` of shape (1,)),
    which are all ``compat`` reads: the card's machine has no
    scikit-learn."""

    def __init__(self, y):
        y = np.asarray(y, np.float64).reshape(-1)
        self.mean_ = np.array([y.mean()])
        self.scale_ = np.array([y.std()])


def interchange_phase(torch, test_smiles, tmpdir, card, seed):
    """Phase 17: a seeded reference composite ``.pth`` (the port's
    ``compare.torch_ref.TorchHybrid`` on the card) imported with
    ``compat`` and served through ``Predictor`` on the test molecules;
    its export's state dicts (``compat.reference_state_dicts``; the
    export's sklearn scaler is held on the CPU, in
    ``tests/test_torch_compat.py``) and their re-import, bit for bit; a
    GIN ``state_dict``; the utils' CUDA probe, memory statistics and
    trace."""
    import warnings

    from mgat_graphsage_torch.compare.torch_ref import TorchHybrid, flat_batch
    from mgat_graphsage_torch.compare.torch_ref_gnn import TorchGINNet
    from mgat_graphsage_torch.compat import (
        import_baseline_checkpoint, import_reference_checkpoint,
        reference_state_dicts)
    from mgat_graphsage_torch.data import MolecularDataset
    from mgat_graphsage_torch.eval.predict import Predictor
    from mgat_graphsage_torch.train.checkpoint import load_checkpoint
    from mgat_graphsage_torch.utils import (
        device_memory_stats, probe_backend, trace)

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    n_nodes, n_edges = BUDGET
    ds = MolecularDataset(test_smiles, np.zeros(len(test_smiles), np.float32),
                          max_nodes=n_nodes, max_edges=n_edges,
                          verbose=False)
    graphs = []
    for i in range(len(ds)):
        n, e = int(ds.node_mask[i].sum()), int(ds.edge_mask[i].sum())
        graphs.append((ds.nodes[i, :n], ds.edges[i, :, :e]))
    kept = np.asarray(ds.kept_indices)

    def flat(gs, fps):
        return [t.to(dev) if torch.is_tensor(t) else t
                for t in flat_batch(gs, fps)]

    # the reference composite, as train.py:287-296 writes it
    torch.manual_seed(seed)
    tmodel = TorchHybrid().to(dev).eval()
    sk = RefScaler(np.random.default_rng(seed).normal(6.5, 1.2, 64))
    pth = os.path.join(tmpdir, "reference", "best_model.pth")
    os.makedirs(os.path.dirname(pth), exist_ok=True)
    torch.save({"gat_graphsage_model_state_dict": tmodel.graph.state_dict(),
                "cnn_model_state_dict": tmodel.cnn.state_dict(),
                "combined_model_state_dict": tmodel.combined.state_dict(),
                "optimizer_state_dict": {}, "normalized_mse": 0.5,
                "original_mse": 0.7, "scaler": sk}, pth)
    ours = os.path.join(tmpdir, "imported", "best_model.pt")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # the layout caveat
        import_reference_checkpoint(pth, ours, preset="flagship",
                                    max_nodes=n_nodes, max_edges=n_edges)
    reset_counts()
    served = Predictor(ours)(test_smiles)
    torch.cuda.synchronize()
    counts = read_counts()
    # the oracle, one molecule at a time as the reference infers
    with torch.no_grad():
        oracle = np.array([
            tmodel(*flat([g], [ds.fp[i:i + 1]]))[0][0, 0].item()
            for i, g in enumerate(graphs)]) * sk.scale_[0] + sk.mean_[0]
    err = float(np.abs(served[kept] - oracle).max())
    if not np.isfinite(served[kept]).all() or err > 1e-4 \
            or counts["dense_adjacency_cuda"] <= 0 \
            or counts["fused_masked_attention_cuda"] <= 0:
        raise AssertionError(f"imported reference checkpoint: max |err| "
                             f"{err} pChEMBL (limit 1e-4), launches "
                             f"{counts}")
    log(f"[17] reference .pth (seeded TorchHybrid) imported "
        f"with compat, served on {len(kept)} test molecules through "
        f"Predictor(device='cuda') within {err:.2e} pChEMBL of the oracle "
        f"on the card (limit 1e-4); launches {counts}")

    # export's state dicts, then their import: both bit for bit
    back = os.path.join(tmpdir, "exported", "best_model.pth")
    rt, scaler = reference_state_dicts(ours)
    os.makedirs(os.path.dirname(back), exist_ok=True)
    torch.save({**rt, "optimizer_state_dict": {}, "scaler": sk}, back)
    orig = torch.load(pth, map_location="cpu", weights_only=False)
    parts = ("gat_graphsage_model_state_dict", "cnn_model_state_dict",
             "combined_model_state_dict")
    same = all(list(orig[p]) == list(rt[p]) and all(
        torch.equal(orig[p][k], rt[p][k]) for k in orig[p]) for p in parts)
    again = os.path.join(tmpdir, "reimported", "best_model.pt")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        import_reference_checkpoint(back, again, preset="flagship",
                                    max_nodes=n_nodes, max_edges=n_edges)
    sd1, sd2 = load_checkpoint(ours)[0], load_checkpoint(again)[0]
    if not same or (scaler.mean_, scaler.scale_) != (sk.mean_[0],
                                                     sk.scale_[0]) \
            or list(sd1) != list(sd2) or not all(
                torch.equal(sd1[k], sd2[k].to(sd1[k].device))
                for k in sd1):
        raise AssertionError("export -> import does not give the state "
                             "dicts back bit for bit")
    log(f"[17] export's state dicts -> the reference composite's, bit for bit "
        f"({sum(len(orig[p]) for p in parts)} tensors); re-import -> the "
        f"port's state_dict equal bit for bit ({len(sd1)} tensors)")

    # a baseline: GIN's bare state_dict
    torch.manual_seed(seed + 1)
    gin = TorchGINNet().to(dev).eval()
    gpth = os.path.join(tmpdir, "reference", "gin.pth")
    torch.save(gin.state_dict(), gpth)
    gout = os.path.join(tmpdir, "imported", "gin.pt")
    import_baseline_checkpoint(gpth, gout, preset="gin", max_nodes=n_nodes,
                               max_edges=n_edges)
    gserved = Predictor(gout)(test_smiles)
    with torch.no_grad():
        x, ei, batch, ng, _ = flat(graphs, [np.zeros((1, 1), np.float32)]
                                   * len(graphs))
        gwant = gin(x, ei, batch, ng).reshape(-1).cpu().numpy()
    gerr = float(np.abs(gserved[kept] - gwant).max())
    if not np.isfinite(gserved[kept]).all() or gerr > 1e-4:
        raise AssertionError(f"imported GIN: max |err| {gerr} (limit 1e-4)")
    log(f"[17] gin state_dict (seeded TorchGINNet) imported and served "
        f"within {gerr:.2e} of the oracle on the card (limit 1e-4)")

    # the utils
    t0 = time.perf_counter()
    probe = probe_backend(timeout_s=300)
    probe_s = time.perf_counter() - t0
    mem = device_memory_stats()
    kind = torch.cuda.get_device_name(0)
    if probe != "cuda" or not any(kind in k for k in mem):
        raise AssertionError(f"utils: probe_backend() {probe!r}, "
                             f"device_memory_stats() keys {list(mem)}")
    logdir = os.path.join(tmpdir, "trace")
    pred = Predictor(ours)
    with trace(logdir):
        pred(test_smiles[:64])
        torch.cuda.synchronize()
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = [ev.get("name", "") for ev in events
               if ev.get("cat") == "kernel"]
    if not kernels:
        raise AssertionError(f"utils.trace recorded no device kernel: "
                             f"{len(events)} events")
    ours = [k for k in ("dense_adjacency_kernel", "masked_attention_kernel")
            if any(k in n for n in kernels)]
    key = next(k for k in mem if kind in k)
    log(f"[17] utils: probe_backend() -> {probe!r} in {probe_s:.1f} s; "
        f"device_memory_stats() {key}: peak allocated "
        f"{mem[key]['allocated_bytes.all.peak']} bytes; trace() of a "
        f"Predictor call on 64 molecules: {len(events)} events, "
        f"{len(kernels)} device kernels, of kernels 1-2: {ours}, on "
        f"{card}")
    log(f"[17] phase 17 took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 18: the mesh (parallel/), in processes of their own
# ---------------------------------------------------------------------------

MESH_MOLS = 512              # 4 global batches of 128
MESH_STEPS, MESH_TIMED = 4, 6
MESH_TIMEOUT = 240
F32_KERNELS = [w for _, w, _ in ROUTES]
# case -> (preset, batch, config overrides); (e) and (f) split the layers
# the reference's rule splits beyond the flagship's CNN fc1
MESH_PRESETS = {"e": ("gat_gcn", 64, {}),
                "f": ("ecfp2048", 128, {})}
MESH_FLAGSHIP = ("flagship", 128, {"cnn_pallas_bwd": True})


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def mesh_steps(torch, Trainer, cfg, ds, mesh):
    """The first ``MESH_STEPS`` train steps of epoch 0 (its batch order and
    dropout generator, this rank's rows of each) with the counters from 0,
    then ``MESH_TIMED`` more, timed on the host clock (synchronised)."""
    from mgat_graphsage_torch.parallel import gather_rows

    t = Trainer(cfg, ds, mesh=mesh)
    state = t.init_state()
    gen = t._dropout_generator(0)
    batches = list(t._batches(ds, cfg.batch_size,
                              np.random.default_rng(cfg.seed), shard=True))
    reset_counts()
    losses = [t.train_step(state, b, gen)["loss"].item()
              for b in batches[:MESH_STEPS]]
    counts = read_counts()
    # the weights after the checked steps as two sums over every element
    # (all the rows of a split parameter): whether two runs' weights part
    whole = [gather_rows(p.detach(), mesh) if n in t._split else p.detach()
             for n, p in state.model.named_parameters()]
    weights = [float(sum(w.double().sum() for w in whole)),
               float(sum(w.double().abs().sum() for w in whole))]
    times = []
    for i in range(MESH_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.train_step(state, batches[i % len(batches)], gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"losses": losses, "counts": counts, "weights": weights,
            "rows": int(batches[0]["y"].shape[0]),
            "cnn_pallas_bwd": t.cfg.cnn_pallas_bwd, "device": str(t.device),
            "mesh": None if mesh is None else mesh.shape,
            "split": sorted(t._split),
            "ms_per_step": float(np.median(times))}


def mesh_worker(mode, rank, world, port, out):
    """One rank of phase 18 (``--mesh-worker``).  (a): the 1-rank NCCL
    mesh against the trainer without a mesh, both deterministic, in this
    process; (b) and (c): 2 ranks on ``cuda:0`` over gloo, data=2 and
    model=2; (e) and (f): gat_gcn and ecfp2048 at model=2 over gloo, rank
    0 running the preset without a mesh first."""
    import warnings

    import torch

    if not torch.cuda.is_available():
        return 2
    from mgat_graphsage_torch.data import TRAIN_CSV, MolecularDataset, load_csv
    from mgat_graphsage_torch.parallel import (
        all_reduce_gradients, initialize_distributed, make_mesh)
    from mgat_graphsage_torch.train import Trainer, get_config

    rank, world = int(rank), int(world)
    if mode in "aef":
        # the same deterministic algorithms for both runs, so (a) compares
        # bit for bit and (e), (f) part only where the split sums in
        # another order (CUBLAS_WORKSPACE_CONFIG is set by the parent)
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
    preset, batch, over = MESH_PRESETS.get(mode, MESH_FLAGSHIP)
    cfg = get_config(preset, epochs=1, batch_size=batch, **over)
    sm, y = load_csv(TRAIN_CSV)
    ds = MolecularDataset(sm[:MESH_MOLS], y[:MESH_MOLS], fit_scaler=True,
                          fingerprint=cfg.fingerprint,
                          featurizer=cfg.featurizer, verbose=False)
    res = {"preset": preset}
    if mode == "a" or (mode in MESH_PRESETS and rank == 0):
        res["plain"] = mesh_steps(torch, Trainer, cfg, ds, None)
    initialize_distributed(f"127.0.0.1:{port}", world, rank,
                           backend="nccl" if mode == "a" else "gloo")
    res["backend"] = torch.distributed.get_backend()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mesh = make_mesh(model_parallel=1 if mode in "ab" else 2)
        res["mesh"] = mesh_steps(torch, Trainer, cfg, ds, mesh)
    res["warnings"] = sorted({str(w.message) for w in caught
                              if "cnn_pallas_bwd" in str(w.message)})
    if mode == "b":
        # does the backend sum bf16 gradients on CUDA tensors?
        p16 = torch.nn.Parameter(torch.zeros(5, dtype=torch.bfloat16,
                                             device="cuda"))
        p16.grad = torch.full_like(p16, rank + 1.0)
        all_reduce_gradients([p16])
        res["bf16_sum"] = p16.grad.float().tolist()
    with open(os.path.join(out, f"{mode}.{rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()
    return 0


def run_mesh_workers(mode, world, out):
    """``world`` ranks of ``mesh_worker(mode)``; raises unless each exits
    0 within ``MESH_TIMEOUT`` s (the others are killed)."""
    port = str(free_port())
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-worker", mode,
         str(r), str(world), port, out], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    try:
        for r, p in enumerate(procs):
            stdout, stderr = p.communicate(timeout=MESH_TIMEOUT)
            if p.returncode != 0:
                raise AssertionError(f"[18] ({mode}) rank {r} exited "
                                     f"{p.returncode}:\n{stdout[-2000:]}\n"
                                     f"{stderr[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [json.load(open(os.path.join(out, f"{mode}.{r}.json")))
            for r in range(world)]


def close_losses(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.max(np.abs(got - want) / np.abs(want)))
    return err <= rel, err


def mesh_phase(tmpdir, card):
    """Phase 18: the flagship f32, B=128, ``cnn_pallas_bwd=True``, 4 steps
    on a mesh, each case in processes of its own: (a) NCCL at world size
    1, bit for bit the trainer without a mesh, the same launches of
    kernels 1-5; (b) 2 ranks on the one card over gloo, data=2, each with
    64 rows and kernels 1-5 once a step; (c) 2 ranks over gloo, model=2
    (fc1 split), ``cnn_pallas_bwd`` turned off with a warning, kernels 1-3
    once a step.  (b) and (c) within rel 1e-4 of (a), their ranks within
    rel 1e-6 of each other.  ms per step for information (two ranks over
    gloo stage every collective through the host).  Then, each against
    its preset's run without a mesh (rel 1e-4, the ranks within 1e-6),
    model=2 over gloo beyond the CNN fc1: (e) gat_gcn at B=64, ``fc_g1``
    split, kernel 1 once a step and no other; (f) ecfp2048 at B=128,
    ``cnn.fc1``, ``cnn.fc2`` and ``combined.fc1`` split, kernels 1-3 once
    a step (the flagship's (c) launches) and 4-5 never.  (e) and (f) run
    deterministic algorithms on both sides, as (a) does."""
    t_phase = time.perf_counter()
    out = os.path.join(tmpdir, "mesh")
    os.makedirs(out, exist_ok=True)
    a = run_mesh_workers("a", 1, out)[0]
    plain, m = a["plain"], a["mesh"]
    if a["backend"] != "nccl" or m["mesh"] != {"data": 1}:
        raise AssertionError(f"[18] (a) ran on {a['backend']}, {m['mesh']}")
    if plain["losses"] != m["losses"] or not np.isfinite(
            m["losses"]).all():
        raise AssertionError(f"[18] (a) NCCL world size 1: losses "
                             f"{m['losses']} vs no mesh {plain['losses']}")
    for w in F32_KERNELS:
        if m["counts"][w] != plain["counts"][w] or m["counts"][w] <= 0:
            raise AssertionError(f"[18] (a) {w}: {m['counts'][w]} launches "
                                 f"on the mesh, {plain['counts'][w]} "
                                 "without")
    log(f"[18] (a) NCCL, world size 1, mesh {m['mesh']}: first "
        f"{MESH_STEPS} losses {m['losses']} equal to the trainer's without "
        f"a mesh bit for bit (deterministic algorithms in both); launches "
        f"{ {w: m['counts'][w] for w in F32_KERNELS} } in both; weights "
        f"after them (sum, sum of |w|) {m['weights']}, "
        f"{'equal to' if m['weights'] == plain['weights'] else 'not'} "
        f"the trainer's without a mesh {plain['weights']}")
    runs = {"a": a}
    for mode, ways, need in (("b", "data", F32_KERNELS),
                             ("c", "model", F32_KERNELS[:3])):
        ranks = run_mesh_workers(mode, 2, out)
        runs[mode] = ranks
        for r, res in enumerate(ranks):
            mm = res["mesh"]
            ok, err = close_losses(mm["losses"], m["losses"], 1e-4)
            if res["backend"] != "gloo" or mm["mesh"].get(ways) != 2 \
                    or not ok:
                raise AssertionError(f"[18] ({mode}) rank {r} on "
                                     f"{res['backend']}, {mm['mesh']}: "
                                     f"losses {mm['losses']} vs (a) "
                                     f"{m['losses']} (rel err {err:.2e})")
            for w in F32_KERNELS:
                want = MESH_STEPS if w in need else 0
                if mm["counts"][w] != want:
                    raise AssertionError(f"[18] ({mode}) rank {r}: {w} "
                                         f"launched {mm['counts'][w]} times "
                                         f"in {MESH_STEPS} steps, not "
                                         f"{want}")
        same, err01 = close_losses(ranks[1]["mesh"]["losses"],
                                   ranks[0]["mesh"]["losses"], 1e-6)
        if not same:
            raise AssertionError(f"[18] ({mode}) the ranks' losses part by "
                                 f"{err01:.2e}")
        mm = ranks[0]["mesh"]
        if mode == "b" and (mm["rows"] != 64 or not mm["cnn_pallas_bwd"]):
            raise AssertionError(f"[18] (b) {mm['rows']} rows a rank, "
                                 f"cnn_pallas_bwd={mm['cnn_pallas_bwd']}")
        if mode == "c" and (mm["rows"] != 128 or mm["cnn_pallas_bwd"]
                            or not ranks[0]["warnings"]):
            raise AssertionError(f"[18] (c) {mm['rows']} rows a rank, "
                                 f"cnn_pallas_bwd={mm['cnn_pallas_bwd']}, "
                                 f"warnings {ranks[0]['warnings']}")
        log(f"[18] ({mode}) gloo, 2 ranks on {mm['device']}, mesh "
            f"{mm['mesh']}, {mm['rows']} rows a rank: losses {mm['losses']}, "
            f"rel err to (a) {close_losses(mm['losses'], m['losses'], 1)[1]:.2e}"
            f" (limit 1e-4), between the ranks {err01:.2e}; launches a rank "
            f"{ {w: mm['counts'][w] for w in F32_KERNELS} }; weights after "
            f"them (sum, sum of |w|) {mm['weights']}")
    log(f"[18] (c) warning: {runs['c'][0]['warnings'][0]}")
    b0 = runs["b"][0]
    if b0["bf16_sum"] != [3.0] * 5:
        raise AssertionError(f"[18] bf16 gradient sum {b0['bf16_sum']}")
    log("[18] gloo sums bf16 gradients on CUDA tensors in bf16")
    step_ms = {k: ", ".join(f"{r['mesh']['ms_per_step']:.3f}"
                            for r in runs[k]) for k in "bc"}
    log(f"[18] (d) ms a step, median of {MESH_TIMED} after the first "
        f"{MESH_STEPS} (host clock, synchronised; (b), (c) stage every "
        f"collective through the host over gloo, not NVLink): no mesh "
        f"{plain['ms_per_step']:.3f}, (a) NCCL world 1 "
        f"{m['ms_per_step']:.3f} (both deterministic), (b) data=2 "
        f"{step_ms['b']}, (c) model=2 {step_ms['c']} (rank 0, 1); {card}")
    flagship_counts = {w: runs["c"][0]["mesh"]["counts"][w]
                       for w in F32_KERNELS}
    for mode, need, split in (
            ("e", F32_KERNELS[:1], ["fc_g1.bias", "fc_g1.weight"]),
            ("f", F32_KERNELS[:3], sorted(
                f"{layer}.{attr}" for layer in ("cnn.fc1", "cnn.fc2",
                                                "combined.fc1")
                for attr in ("weight", "bias")))):
        preset, batch, _ = MESH_PRESETS[mode]
        t_case = time.perf_counter()
        ranks = run_mesh_workers(mode, 2, out)
        runs[mode] = ranks
        plain = ranks[0]["plain"]
        for w in F32_KERNELS:
            want = MESH_STEPS if w in need else 0
            if plain["counts"][w] != want:
                raise AssertionError(f"[18] ({mode}) {preset} without a "
                                     f"mesh: {w} launched "
                                     f"{plain['counts'][w]} times in "
                                     f"{MESH_STEPS} steps, not {want}")
        for r, res in enumerate(ranks):
            mm = res["mesh"]
            ok, err = close_losses(mm["losses"], plain["losses"], 1e-4)
            if res["backend"] != "gloo" or res["preset"] != preset \
                    or mm["mesh"] != {"data": 1, "model": 2} or not ok \
                    or not np.isfinite(mm["losses"]).all():
                raise AssertionError(f"[18] ({mode}) {res['preset']} rank "
                                     f"{r} on {res['backend']}, "
                                     f"{mm['mesh']}: losses {mm['losses']} "
                                     f"vs no mesh {plain['losses']} (rel "
                                     f"err {err:.2e})")
            if mm["split"] != split or mm["rows"] != batch \
                    or mm["cnn_pallas_bwd"]:
                raise AssertionError(f"[18] ({mode}) rank {r}: split "
                                     f"{mm['split']}, {mm['rows']} rows, "
                                     f"cnn_pallas_bwd={mm['cnn_pallas_bwd']}")
            for w in F32_KERNELS:
                want = MESH_STEPS if w in need else 0
                if mm["counts"][w] != want:
                    raise AssertionError(f"[18] ({mode}) rank {r}: {w} "
                                         f"launched {mm['counts'][w]} times "
                                         f"in {MESH_STEPS} steps, not "
                                         f"{want}")
        same, err01 = close_losses(ranks[1]["mesh"]["losses"],
                                   ranks[0]["mesh"]["losses"], 1e-6)
        if not same:
            raise AssertionError(f"[18] ({mode}) the ranks' losses part by "
                                 f"{err01:.2e}")
        mm = ranks[0]["mesh"]
        counts = {w: mm["counts"][w] for w in F32_KERNELS}
        log(f"[18] ({mode}) {preset}, gloo, 2 ranks on {mm['device']}, mesh "
            f"{mm['mesh']}, {mm['rows']} rows a rank, split {mm['split']}: "
            f"losses {mm['losses']}, rel err to the run without a mesh "
            f"{close_losses(mm['losses'], plain['losses'], 1)[1]:.2e} "
            f"(limit 1e-4; by step "
            + ", ".join(f"{close_losses([g], [w], 1)[1]:.2e}" for g, w in
                        zip(mm["losses"], plain["losses"]))
            + f"; both with deterministic algorithms), between the ranks "
            f"{err01:.2e}; launches a rank "
            f"{counts}"
            + (f", {'the same as' if counts == flagship_counts else 'not'}"
               f" the flagship's (c) {flagship_counts}"
               if mode == "f" else "")
            + f"; ms a step (host clock, synchronised): no mesh "
            f"{plain['ms_per_step']:.3f}, model=2 "
            + ", ".join(f"{r['mesh']['ms_per_step']:.3f}" for r in ranks)
            + f" (rank 0, 1); {card}; the case took "
            f"{time.perf_counter() - t_case:.1f} s")
    log(f"[18] phase 18 took {time.perf_counter() - t_phase:.1f} s")
    return runs


FEATURE_FIELDS = ("nodes", "edges", "node_mask", "edge_mask", "fp",
                  "kept_indices")


def featurise_both(MolecularDataset, smiles, y):
    """The dataset through the native library and through the Python path,
    and each one's seconds."""
    t0 = time.perf_counter()
    native = MolecularDataset(smiles, y, verbose=False)
    t1 = time.perf_counter()
    python = MolecularDataset(smiles, y, verbose=False, use_native=False)
    t2 = time.perf_counter()
    return native, python, t1 - t0, t2 - t1


def same_features(a, b):
    """Names of the featurised arrays in which two datasets differ."""
    return [k for k in FEATURE_FIELDS
            if not np.array_equal(getattr(a, k), getattr(b, k))]


def http(url, body=None, timeout=300):
    """(status, JSON reply) of a GET, or of a POST of ``body``."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def serve_phase(torch, ckpt, predictor, test_smiles, train_smiles, train_y,
                test_feats, plain_preds, train_ds, val_ds, card, native_build):
    """Phase 12: the host data and serving layer on the card.  Returns the
    launches of kernels 1-5 while the server answered, and in the compact
    epoch."""
    from mgat_graphsage_torch.data import MolecularDataset
    from mgat_graphsage_torch.data.packed import packed_nbytes, plain_nbytes
    from mgat_graphsage_torch.serve import make_server
    from mgat_graphsage_torch.train import Trainer, get_config

    t_phase = time.perf_counter()
    # ---- 12a. native against Python featurisation, bit for bit ----------
    cmd, build_s = native_build
    log(f"[12] {cmd}: built in {build_s:.2f} s")
    n_test = len(test_smiles)
    tr_native, tr_python, tr_nat_s, tr_py_s = featurise_both(
        MolecularDataset, train_smiles, train_y)
    te_native, te_python, te_nat_s, te_py_s = test_feats
    for name, a, b in (("test", te_native, te_python),
                       ("train", tr_native, tr_python)):
        diff = same_features(a, b)
        if diff or len(a) != len(b):
            raise AssertionError(f"native and Python featurisation of the "
                                 f"{name} CSV differ in {diff} ({len(a)} "
                                 f"against {len(b)} molecules)")
    n_all = n_test + len(train_smiles)
    log(f"[12] native = Python featurisation bit for bit (nodes, edges, "
        f"masks, ECFP-1024, kept indices) on {n_test} test + "
        f"{len(train_smiles)} train molecules; native {n_test / te_nat_s:.1f}"
        f" / {len(train_smiles) / tr_nat_s:.1f} mol/s, Python "
        f"{n_test / te_py_s:.1f} / {len(train_smiles) / tr_py_s:.1f} mol/s "
        f"(test / train, MolecularDataset, {n_all} molecules), on {card}")

    # ---- 12b. the HTTP server, its counters from 0 -------------------------
    rng = np.random.default_rng(12)

    def request(size):
        idx = rng.choice(n_test, size, replace=False)
        if size > 1:
            idx[int(rng.integers(size))] = -1
        return [BAD if i < 0 else test_smiles[i] for i in idx], idx

    def check_reply(body, req, idx, what):
        got = np.array([np.nan if p is None else p
                        for p in body["predictions"]], np.float64)
        bad = idx < 0
        if body["count"] != len(req) or got.shape != idx.shape \
                or not all((p is None) == b for p, b in
                           zip(body["predictions"], bad)):
            raise AssertionError(f"{what}: nulls at "
                                 f"{np.flatnonzero(np.isnan(got))}, "
                                 f"expected {np.flatnonzero(bad)}")
        t0 = time.perf_counter()
        direct = predictor(req)
        direct_ms.setdefault(len(req), []).append(
            (time.perf_counter() - t0) * 1e3)
        e_direct = float(np.abs(got[~bad] - direct[~bad]).max(initial=0.0))
        e_plain = float(np.abs(got[~bad] - plain_preds[idx[~bad]])
                        .max(initial=0.0))
        if e_direct > 1e-4 or e_plain > 1e-4:
            raise AssertionError(f"{what}: max |err| {e_direct} against "
                                 f"Predictor, {e_plain} against the plain "
                                 f"path (limit 1e-4 pChEMBL)")
        return max(e_direct, e_plain)

    # replies are held against the direct and the plain path after the
    # server has stopped, so the counts are the server's own launches
    answered, direct_ms = [], {}
    reset_counts()
    server = make_server(ckpt, port=0, device=str(predictor.device))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        status, health = http(url + "/health?probe=1")
        if status != 200 or health["device"] != str(predictor.device) \
                or health["max_nodes"] != BUDGET[0]:
            raise AssertionError(f"/health: {status} {health}")
        status, body = http(url + "/predict", {"smiles": [BAD]})
        if status != 200 or body["predictions"] != [None]:
            raise AssertionError(f"a request of {BAD!r} alone: {body}")
        lat = {}
        for size in (1, 64, 512):
            times, split = [], []
            for i in range(11):
                req, idx = request(size)
                t0 = time.perf_counter()
                status, body = http(url + "/predict",
                                    {"smiles": req, "timing": True})
                times.append(time.perf_counter() - t0)
                if status != 200:
                    raise AssertionError(f"request of {size}: {status} "
                                         f"{body}")
                answered.append((body, req, idx, f"request of {size}"))
                split.append((body["timing"]["featurize_ms"],
                              body["timing"]["dispatch_ms"]))
            ms = np.array(times[1:]) * 1e3          # the first is warm-up
            sp = np.array(split[1:])
            lat[size] = (float(np.percentile(ms, 50)),
                         float(np.percentile(ms, 99)),
                         float(np.median(sp[:, 0])),
                         float(np.median(sp[:, 1])))

        # coalescing: 8 clients of 64 SMILES at once, merged
        backend = server.backend
        backend.enable_coalescing(2.0)
        before = http(url + "/health")[1]
        reqs = [request(64) for _ in range(8)]
        replies = [None] * 8
        gate = threading.Barrier(8)

        def client(i):
            gate.wait()
            replies[i] = http(url + "/predict", {"smiles": reqs[i][0]})

        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=300)
        after = http(url + "/health")[1]
        backend.enable_coalescing(0.0)
        disp = after["device_dispatches"] - before["device_dispatches"]
        served = after["requests_served"] - before["requests_served"]
        for (req, idx), reply in zip(reqs, replies):
            if reply is None or reply[0] != 200:
                raise AssertionError(f"a coalesced client failed: {reply}")
            answered.append((reply[1], req, idx, "coalesced"))
        if served != 8 or disp >= 8:
            raise AssertionError(f"coalescing: {served} requests served in "
                                 f"{disp} dispatches")
    finally:
        server.shutdown()
        server.server_close()
        server.backend.close()
        thread.join(timeout=60)
    serve_counts = read_counts()
    log(f"[12] launches while the server answered: {serve_counts}")
    for name in ("dense_adjacency_cuda", "fused_masked_attention_cuda"):
        if serve_counts[name] <= 0:
            raise AssertionError(f"the server never launched {name}")
    worst = max(check_reply(*a) for a in answered)
    for size, (p50, p99, f_ms, d_ms) in lat.items():
        log(f"[12] HTTP {size:>3} SMILES: p50 {p50:.2f} ms, p99 {p99:.2f} ms "
            f"over 10 requests; server featurize_ms {f_ms:.2f}, dispatch_ms "
            f"{d_ms:.2f} (medians); the same requests through Predictor in "
            f"this thread p50 {np.median(direct_ms[size][1:11]):.2f} ms, on "
            f"{card}")
    log(f"[12] {len(answered)} replies NaN-aligned ({BAD!r} -> null "
        f"exactly), within {worst:.2e} pChEMBL of Predictor and of the plain "
        f"path (limit 1e-4); coalescing at 2 ms: 8 concurrent requests of 64 "
        f"SMILES served in {disp} device dispatches")

    # why the server dispatches on one long-lived thread: a Predictor call
    # of 1 SMILES here, in one other thread, and in a fresh thread each
    def one_call(out):
        t0 = time.perf_counter()
        predictor([test_smiles[0]])
        out.append((time.perf_counter() - t0) * 1e3)

    where = {"this thread": [], "one long-lived thread": [],
             "a fresh thread each": []}
    for _ in range(8):
        one_call(where["this thread"])
    keep = threading.Thread(target=lambda: [one_call(
        where["one long-lived thread"]) for _ in range(8)])
    keep.start()
    keep.join()
    for _ in range(8):
        fresh = threading.Thread(target=one_call,
                                 args=(where["a fresh thread each"],))
        fresh.start()
        fresh.join()
    log("[12] Predictor, 1 SMILES, ms per call (the first of each is "
        "warm-up): " + "; ".join(
            f"{k} {' '.join(f'{t:.2f}' for t in v)}" for k, v in
            where.items()) + f", on {card}")

    # ---- 12c. compact storage: the float32 run, bit for bit --------------
    cfg = get_config("flagship", epochs=1)
    ccfg = cfg.replace(dataset_storage="compact")
    plain_t, comp_t = Trainer(cfg, train_ds), Trainer(ccfg, train_ds)
    rng_b = np.random.default_rng(cfg.seed)
    a_batches = list(plain_t._batches(train_ds, cfg.batch_size, rng_b))
    rng_b = np.random.default_rng(cfg.seed)
    for i, b in enumerate(comp_t._batches(train_ds, cfg.batch_size, rng_b)):
        if set(b) != set(a_batches[i]) or not all(
                b[k].dtype == a_batches[i][k].dtype
                and torch.equal(b[k], a_batches[i][k]) for k in b):
            raise AssertionError(f"compact batch {i} differs from the "
                                 f"float32 batch")
    bytes_dev = {name: sum(v.numel() * v.element_size() for v in
                           t._device_dataset(train_ds).values())
                 for name, t in (("float32", plain_t), ("compact", comp_t))}
    del a_batches
    # the f32 step repeats bit for bit only with cuDNN's deterministic
    # algorithms (its default convolution backward may pick one that sums
    # in another order from run to run: two float32 runs have parted by
    # 4.8e-7 in loss), so the losses are compared under them
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        l32 = first_steps(torch, Trainer, cfg, train_ds, val_ds)
        lc = first_steps(torch, Trainer, ccfg, train_ds, val_ds)
        l32b = first_steps(torch, Trainer, cfg, train_ds, val_ds)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = saved
    repeat_gap = float(np.abs(l32 - l32b).max())
    comp_gap = float(np.abs(lc - l32).max())
    if not np.isfinite(lc).all() or comp_gap > repeat_gap:
        raise AssertionError(f"compact storage: first 4 losses {lc} against "
                             f"float32 {l32} (two float32 runs part by "
                             f"{repeat_gap}; cuDNN deterministic)")
    hist = {}
    for name, c in (("float32", cfg), ("compact", ccfg)):
        t = Trainer(c, train_ds, val_ds)
        if name == "compact":
            reset_counts()
        t0 = time.perf_counter()
        _, _, h = t.fit(save_best=False, verbose=False)
        torch.cuda.synchronize()
        hist[name] = (h[-1], time.perf_counter() - t0)
    compact_counts = read_counts()
    for name in ("dense_adjacency_cuda", "fused_masked_attention_cuda",
                 "attention_bwd_cuda"):
        if compact_counts[name] <= 0:
            raise AssertionError(f"the compact epoch never launched {name}")
    row, row32 = hist["compact"][0], hist["float32"][0]
    if not all(np.isfinite(row[k]) for k in ("train_loss", "val_mse")):
        raise AssertionError(f"non-finite compact training metrics: {row}")
    same = "equal bit for bit to" if comp_gap == 0 \
        else f"{comp_gap:.3e} from"
    log(f"[12] compact storage: every batch of the epoch equal to the "
        f"float32 one bit for bit; first 4 losses {np.round(lc, 6)}, "
        f"{same} float32's (two float32 runs part by {repeat_gap:.3e}; "
        f"cuDNN deterministic); one epoch "
        f"loss {row['train_loss']:.6f} / val MSE {row['val_mse']:.6f} "
        f"(float32 {row32['train_loss']:.6f} / {row32['val_mse']:.6f}), "
        f"{hist['compact'][1]:.2f} s against {hist['float32'][1]:.2f} s; "
        f"launches {compact_counts}")
    log(f"[12] training set on the device: float32 {bytes_dev['float32']} "
        f"bytes, compact {bytes_dev['compact']} bytes "
        f"({bytes_dev['float32'] / bytes_dev['compact']:.2f}x; "
        f"plain_nbytes/packed_nbytes {plain_nbytes(train_ds)} / "
        f"{packed_nbytes(train_ds)}), {len(train_ds)} molecules at N="
        f"{train_ds.max_nodes}, E={train_ds.max_edges}")
    log(f"[12] phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return serve_counts, compact_counts


# ---------------------------------------------------------------------------
# the baselines and the gat10 ablation
# ---------------------------------------------------------------------------

BASELINES = ("gcn", "graphsage", "gat", "gat_gcn", "gin", "chebnet",
             "model1")


def baselines_phase(torch, train_smiles, train_y, val_smiles, val_y, tmpdir,
                    card, timer):
    """Phase 13: the six baselines and ``model1`` (gat10) at their
    published widths and batch sizes.  Returns the launches of kernels 1-5
    over the seven epochs, kernel 1's times at gcn's B=32 and the largest
    |error| of kernel 1 on the recorded batches."""
    from mgat_graphsage_torch.data import MolecularDataset
    from mgat_graphsage_torch.eval.predict import Predictor
    from mgat_graphsage_torch.models import MaskedBatchNorm
    from mgat_graphsage_torch.ops.adjacency import (
        dense_adjacency_cuda, dense_adjacency_plain)
    from mgat_graphsage_torch.serve import make_server
    from mgat_graphsage_torch.train import Trainer, get_config

    t_phase = time.perf_counter()
    data = {}
    for feat in ("35", "5"):
        tr = MolecularDataset(train_smiles, train_y, fingerprint=None,
                              featurizer=feat, verbose=False)
        va = MolecularDataset(val_smiles, val_y, scaler=tr.scaler,
                              fingerprint=None, featurizer=feat,
                              max_nodes=tr.max_nodes,
                              max_edges=tr.max_edges, verbose=False)
        if tr.nodes.shape[-1] != int(feat) or tr.fp_dim:
            raise AssertionError(f"featurizer {feat}: nodes "
                                 f"{tr.nodes.shape}, fingerprint bits "
                                 f"{tr.fp_dim}")
        data[feat] = (tr, va)
    log(f"[13] featurised {len(data['35'][0])} train + "
        f"{len(data['35'][1])} validation molecules twice (35- and 5-dim "
        f"nodes, no fingerprint) in {time.perf_counter() - t_phase:.1f} s")
    total = dict.fromkeys(read_counts(), 0)
    first, ckpts = {}, {}
    for name in BASELINES:
        cfg = get_config(name, epochs=1)
        tr, va = data[cfg.featurizer]
        with first_calls() as seen:
            losses = first_steps(torch, Trainer, cfg, tr, va)
        first[name] = seen["dense_adjacency_cuda"]
        with plain_path():
            plain = first_steps(torch, Trainer, cfg, tr, va)
        step_err = float(np.max(np.abs(losses - plain) / np.abs(plain)))
        if not np.isfinite(losses).all() or step_err > 1e-4:
            raise AssertionError(f"{name}: first 4 losses {losses} vs plain "
                                 f"path {plain}")
        ckdir = os.path.join(tmpdir, f"baseline_{name}")
        trainer = Trainer(cfg, tr, va, ckpt_dir=ckdir)
        reset_counts()
        t0 = time.perf_counter()
        _, best, hist = trainer.fit(verbose=False)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = read_counts()
        steps = -(-len(tr) // cfg.batch_size)
        evals = -(-len(va) // cfg.eval_batch_size)
        if counts["dense_adjacency_cuda"] != steps + evals or any(
                v for k, v in counts.items() if k != "dense_adjacency_cuda"):
            raise AssertionError(f"{name}: one epoch of {steps} steps and "
                                 f"{evals} eval batches launched {counts}")
        for k, v in counts.items():
            total[k] += v
        row = hist[-1]
        if not all(np.isfinite(row[k]) for k in ("train_loss", "val_mse",
                                                  "original_mse")):
            raise AssertionError(f"{name}: non-finite metrics {row}")
        bns = [m for m in best.model.modules()
               if isinstance(m, MaskedBatchNorm)]
        for m in bns:
            if m.mean.dtype != torch.float32 or m.var.dtype != torch.float32 \
                    or not (m.mean != 0).any() or not (m.var != 1).any():
                raise AssertionError(f"{name}: running statistics "
                                     f"{m.mean.dtype} {m.var.dtype} did not "
                                     "move from 0 and 1")
        ckpts[name] = os.path.join(ckdir, "best_model.pt")
        served = Predictor(ckpts[name])(val_smiles)
        ev = trainer.evaluate(best)
        serve_err = float(np.abs(served[va.kept_indices]
                                 - ev["pred_denorm"]).max())
        if not np.isfinite(served).all() or serve_err > 1e-4:
            raise AssertionError(f"{name}: best checkpoint serves "
                                 f"{serve_err} pChEMBL from the trainer")
        step_ms = time_steps(torch, trainer, trainer.init_state(), tr)
        log(f"[13] {name} (B={cfg.batch_size}, "
            f"{sum(p.numel() for p in best.model.parameters())} parameters"
            f"{f', {len(bns)} batch norms' if bns else ''}): first 4 losses "
            f"{np.round(losses, 6)} vs plain path rel err {step_err:.2e} "
            f"(limit 1e-4); one epoch {fit_s:.2f} s (train "
            f"{row['epoch_time_s']:.2f} s), loss {row['train_loss']:.4f}, "
            f"val MSE {row['val_mse']:.4f}; adjacency launches "
            f"{counts['dense_adjacency_cuda']} = {steps} steps + {evals} "
            f"eval batches, no other kernel; served max |err| "
            f"{serve_err:.2e} pChEMBL; train step {step_ms:.3f} ms "
            f"({cfg.batch_size / step_ms * 1e3:.1f} mol/s), on {card}")

    # kernel 1 bit for bit on the first gcn and gat_gcn batches
    adj_err = 0.0
    for name, b in (("gcn", 32), ("gat_gcn", 64)):
        ed, em, n = first[name]
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        want = dense_adjacency_plain(ed.cpu(), em.cpu(), n)
        torch.set_num_threads(threads)
        got = dense_adjacency_cuda(ed, em, n).cpu()
        adj_err = max(adj_err, (got - want).abs().max().item())
        if ed.shape[0] != b or not bitwise_equal(got, want):
            raise AssertionError(f"{name}: adjacency kernel on the first "
                                 f"batch {tuple(ed.shape)} differs from its "
                                 "plain version")
        log(f"[13] adjacency on the first {name} batch {tuple(got.shape)} "
            f"bit for bit equal to the plain version on the CPU")
    adj32 = adjacency_times(torch, timer, *first["gcn"])
    log(f"[13] adjacency at gcn's B=32: kernel {adj32[0] * 1e3:.2f} us, "
        f"plain {adj32[1] * 1e3:.2f} us, library {adj32[2] * 1e3:.2f} us, "
        f"bound {adj32[3][0] * 1e3:.2f} us ({adj32[3][1]}), on {card}")

    # a GIN checkpoint behind the HTTP server
    req = list(val_smiles[:64])
    req[17] = BAD
    server = make_server(ckpts["gin"], port=0, device="cuda")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        status, body = http(
            f"http://127.0.0.1:{server.server_address[1]}/predict",
            {"smiles": req})
    finally:
        server.shutdown()
        server.server_close()
        server.backend.close()
        thread.join(timeout=60)
    nulls = [i for i, p in enumerate(body.get("predictions", []))
             if p is None]
    if status != 200 or nulls != [17]:
        raise AssertionError(f"gin served over HTTP: {status}, nulls at "
                             f"{nulls}")
    got = np.array([np.nan if p is None else p for p in body["predictions"]])
    direct = Predictor(ckpts["gin"])(req)
    http_err = float(np.nanmax(np.abs(got - direct)))
    if http_err > 1e-4:
        raise AssertionError(f"gin over HTTP: max |err| {http_err}")
    log(f"[13] gin checkpoint over HTTP: 64 SMILES, null exactly at "
        f"{BAD!r}, max |err| {http_err:.2e} against Predictor")

    cli = subprocess.run(
        [sys.executable, "-m", "mgat_graphsage_torch.train.run", "--preset",
         "gcn", "--limit", "256", "--ckpt-dir",
         os.path.join(tmpdir, "cli_gcn")], cwd=REPO, capture_output=True,
        text=True, timeout=600)
    if cli.returncode != 0 or "Training completed" not in cli.stdout:
        raise AssertionError(f"the training CLI failed on gcn:\n"
                             f"{cli.stdout}\n{cli.stderr}")
    log("[13] python -m mgat_graphsage_torch.train.run --preset gcn "
        "--limit 256 on CUDA: " + cli.stdout.strip().splitlines()[-2])
    # where a baseline step's time goes: one GIN epoch (the slowest step)
    from torch.profiler import ProfilerActivity, profile

    cfg = get_config("gin", epochs=1)
    trainer = Trainer(cfg, *data["35"])
    state = trainer.init_state()
    trainer.train_epoch(state, 0)                  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_epoch(state, 1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = device_events(torch, prof)
    busy_us = sum(ev.self_device_time_total for ev in kern)
    launches = sum(ev.count for ev in kern)
    steps = -(-len(data["35"][0]) // cfg.batch_size)
    log(f"[13] profile of one gin epoch ({steps} steps): wall {wall_us:.0f} "
        f"us, device busy {busy_us:.0f} us ({100 * busy_us / wall_us:.2f}%), "
        f"{launches / steps:.1f} device kernels and copies a step; top:")
    for ev in sorted(kern, key=lambda ev: -ev.self_device_time_total)[:6]:
        log(f"  {ev.self_device_time_total:9.1f} us  x{ev.count:<5d} "
            f"{ev.key[:90]}")
    log(f"[13] launches over the seven epochs: {total}")
    log(f"[13] phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return total, adj32, adj_err


# ---------------------------------------------------------------------------
# the fingerprint suite and interpretability
# ---------------------------------------------------------------------------

# preset -> (train, validation) molecules of phase 14: BCI's host
# featurisation runs at a few tens of molecules a second, so it takes the
# first 1024 + 256 only
FINGERPRINT_PRESETS = {"maccs": (None, None), "smifp": (None, None),
                       "bci": (1024, 256)}
KERNELS_1_3 = ("dense_adjacency_cuda", "fused_masked_attention_cuda",
               "attention_bwd_cuda")


def fingerprint_phase(torch, train_smiles, train_y, val_smiles, val_y,
                      tmpdir, card):
    """Phase 14: the ``maccs``, ``smifp`` and ``bci`` presets at full
    width.  Returns the launches of kernels 1-5 over the three epochs."""
    from mgat_graphsage_torch.data import MolecularDataset
    from mgat_graphsage_torch.eval.predict import Predictor
    from mgat_graphsage_torch.train import Trainer, get_config

    t_phase = time.perf_counter()
    total = dict.fromkeys(read_counts(), 0)
    for name, (n_tr, n_va) in FINGERPRINT_PRESETS.items():
        cfg = get_config(name, epochs=1)
        sm, y = train_smiles[:n_tr], train_y[:n_tr]
        vs, vy = val_smiles[:n_va], val_y[:n_va]
        t0 = time.perf_counter()
        tr = MolecularDataset(sm, y, fit_scaler=True,
                              fingerprint=cfg.fingerprint, verbose=False)
        va = MolecularDataset(vs, vy, scaler=tr.scaler,
                              fingerprint=cfg.fingerprint,
                              max_nodes=tr.max_nodes,
                              max_edges=tr.max_edges, verbose=False)
        feat_s = time.perf_counter() - t0
        losses = first_steps(torch, Trainer, cfg, tr, va)
        with plain_path():
            plain = first_steps(torch, Trainer, cfg, tr, va)
        step_err = float(np.max(np.abs(losses - plain) / np.abs(plain)))
        if not np.isfinite(losses).all() or step_err > 1e-4:
            raise AssertionError(f"{name}: first 4 losses {losses} vs plain "
                                 f"path {plain}")
        ckdir = os.path.join(tmpdir, f"fingerprint_{name}")
        trainer = Trainer(cfg, tr, va, ckpt_dir=ckdir)
        reset_counts()
        t0 = time.perf_counter()
        _, best, hist = trainer.fit(verbose=False)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = read_counts()
        if any(counts[k] <= 0 for k in KERNELS_1_3) or any(
                counts[k] for k in counts if k not in KERNELS_1_3):
            raise AssertionError(f"{name}: one epoch launched {counts}")
        for k, v in counts.items():
            total[k] += v
        row = hist[-1]
        if not all(np.isfinite(row[k]) for k in ("train_loss", "val_mse",
                                                  "original_mse")):
            raise AssertionError(f"{name}: non-finite metrics {row}")
        served = Predictor(os.path.join(ckdir, "best_model.pt"))(vs)
        ev = trainer.evaluate(best)
        serve_err = float(np.abs(served[va.kept_indices]
                                 - ev["pred_denorm"]).max())
        if not np.isfinite(served[va.kept_indices]).all() or \
                serve_err > 1e-4:
            raise AssertionError(f"{name}: best checkpoint serves "
                                 f"{serve_err} pChEMBL from the trainer")
        step_ms = time_steps(torch, trainer, trainer.init_state(), tr)
        cut = "" if n_tr is None else (f" (cut to the first {n_tr} train + "
                                       f"{n_va} validation molecules: host "
                                       f"featurisation)")
        log(f"[14] {name} ({tr.fp_dim}-bit fingerprint, fc1 "
            f"{tuple(best.model.cnn.fc1.weight.shape)}, "
            f"{sum(p.numel() for p in best.model.parameters())} parameters)"
            f"{cut}: featurised {len(tr)} + {len(va)} molecules in "
            f"{feat_s:.2f} s ({(len(tr) + len(va)) / feat_s:.1f} mol/s, "
            f"Python path); first 4 losses {np.round(losses, 6)} vs plain "
            f"path rel err {step_err:.2e} (limit 1e-4); one epoch "
            f"{fit_s:.2f} s, loss {row['train_loss']:.4f}, val MSE "
            f"{row['val_mse']:.4f}; launches {counts}; served max |err| "
            f"{serve_err:.2e} pChEMBL; train step {step_ms:.3f} ms "
            f"({cfg.batch_size / step_ms * 1e3:.1f} mol/s), on {card}")
    log(f"[14] launches over the three epochs: {total}")
    log(f"[14] phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return total


def explain_phase(torch, ckpt, tmpdir, card):
    """Phase 15: the interpretability pipeline on the phase-8 flagship
    checkpoint over the 961 test molecules.  Returns the launches of
    kernels 1-5 in the pipeline's call."""
    from torch.profiler import ProfilerActivity, profile

    from mgat_graphsage_torch.data import TEST_CSV, MolecularDataset, load_csv
    from mgat_graphsage_torch.eval.predict import load_model_from_checkpoint
    from mgat_graphsage_torch.explain import (
        hybrid_analysis_strategy, quick_importance_analysis_all)
    from mgat_graphsage_torch.explain.pipeline import detailed_importance

    t_phase = time.perf_counter()
    target, stage1_batch, batch = 200, 512, 64
    out = os.path.join(tmpdir, "explain")
    reset_counts()
    # one call, profiled: its own wall time and device busy time give the
    # host share of that call
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = hybrid_analysis_strategy(
            TEST_CSV, ckpt, target, output_dir=out,
            stage1_batch=stage1_batch, batch_size=batch, make_figures=False,
            verbose=False)
        torch.cuda.synchronize()
    counts = read_counts()
    busy_s = sum(ev.self_device_time_total
                 for ev in device_events(torch, prof)) / 1e6
    tm = res["timings"]
    n, sel = res["n_molecules"], res["selected_indices"]
    nb1 = -(-n // min(stage1_batch, n))
    nb3 = -(-len(sel) // batch)
    want = {"dense_adjacency_cuda": nb1 + nb3,
            "fused_masked_attention_cuda": nb1 + nb3 * 101,
            "attention_bwd_cuda": nb1 + nb3 * 100,
            "dy3_cuda": 0, "cnn_chain_bwd_cuda": 0, "dy3_cuda_bf16": 0,
            "cnn_chain_bwd_cuda_bf16": 0}
    if counts != want:
        raise AssertionError(f"explain launched {counts}, expected {want} "
                             f"({nb1} Stage 1 batches, {nb3} Stage 3 "
                             "batches of 1 target + 100 steps)")
    with open(os.path.join(out, "analysis_results.json")) as f:
        written = json.load(f)
    if len(written["selected_indices"]) != target or len(sel) != target \
            or res["detailed_method"] != "gnnexplainer":
        raise AssertionError(f"analysis_results.json holds "
                             f"{len(written['selected_indices'])} entries, "
                             f"method {res['detailed_method']}")
    stage1 = res["stage1"]
    detailed = [res["detailed_importances"][i] for i in sel]
    if any(np.array_equal(d, stage1["importances"][i])
           for d, i in zip(detailed, sel)):
        raise AssertionError("a Stage 3 importance equals its Stage 1 one "
                             "(no GNNExplainer result)")
    log(f"[15] explain on {os.path.relpath(ckpt, REPO)}: {n} molecules, "
        f"{len(sel)} in detail, make_figures=False; launches {counts} "
        f"(= {nb1} Stage 1 batches of {stage1_batch} + {nb3} Stage 3 "
        f"batches of {batch} x (1 target + 100 steps)); "
        f"analysis_results.json with {len(written['selected_indices'])} "
        f"entries; no fallback")

    # the same stages through the plain versions on the card
    t_cmp = time.perf_counter()
    model, cfg, scaler, (mn, me) = load_model_from_checkpoint(ckpt)
    branch = model.gat_graphsage
    smiles, y = load_csv(TEST_CSV)
    ds = MolecularDataset(smiles, y, scaler=scaler, fingerprint=None,
                          max_nodes=mn, max_edges=me, verbose=False)
    dd = tuple(torch.from_numpy(np.ascontiguousarray(a)).cuda()
               for a in (ds.nodes, ds.edges, ds.edge_mask, ds.node_mask))
    with plain_path():
        plain1 = quick_importance_analysis_all(ds, branch, scaler,
                                               stage1_batch, False, dd)
        plain_norms, plain3 = detailed_importance(ds, branch, sel, batch, dd)
    pred_err = float(np.abs(stage1["prediction"]
                            - plain1["prediction"]).max())
    gap1 = np.array([np.abs(a - b).max() for a, b in
                     zip(stage1["importances"], plain1["importances"])])
    gap3 = np.array([np.abs(a - b).max() for a, b in zip(detailed, plain3)])
    # Stage 3's per-atom mask norms before the min-max scaling
    raw3 = np.abs(res["detailed_norms"] - plain_norms).max(axis=1)
    # per molecule, every molecule (importances are min-max scaled, so a
    # molecule's gap is its largest over its atoms)
    checks = (("Stage 1 importances", gap1, 1e-4),
              ("Stage 3 mask norms", raw3, 1e-5),
              ("Stage 3 importances", gap3, 1e-3))
    log(f"[15] kernels vs plain path on the card: Stage 1 predictions max "
        f"|err| {pred_err:.2e} pChEMBL (limit 1e-4); " + "; ".join(
            f"{what} max |err| {gap.max():.2e} over {len(gap)} molecules "
            f"(limit {lim:g})" for what, gap, lim in checks)
        + f"; {time.perf_counter() - t_cmp:.1f} s")
    for what, gap, lim in checks:
        past = np.where(gap > lim)[0]
        if len(past):
            log(f"[15] {what} past {lim:g}: molecules "
                f"{[int(i) for i in past[:20]]}, |err| "
                f"{np.round(gap[past[:20]], 5).tolist()}")
    if not pred_err <= 1e-4 or any((gap > lim).any()
                                   for _, gap, lim in checks):
        raise AssertionError("explain: the kernel path parts from the plain "
                             "path beyond the limits above")

    host = 1.0 - busy_s / tm["total_s"]
    log(f"[15] under the CUDA-activity profiler: Stage 1 "
        f"{tm['stage1_s']:.3f} s ({n / tm['stage1_s']:.1f} mol/s); Stage 2 "
        f"{tm['stage2_s']:.3f} s; Stage 3 GNNExplainer "
        f"{tm['stage3_gnnexplainer_s']:.3f} s ({len(sel)} molecules, "
        f"{nb3 * 100} mask steps, "
        f"{tm['stage3_gnnexplainer_s'] / (nb3 * 100) * 1e3:.2f} ms a "
        f"step), substructures {tm['stage3_substructures_s']:.3f} s; "
        f"load + featurise {tm['load_s']:.3f} s; report {tm['stage4_s']:.3f} "
        f"s; whole call {tm['total_s']:.3f} s, device busy {busy_s:.3f} s "
        f"in that call: host share {100 * host:.1f}%, on {card}")
    log(f"[15] phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh-worker", nargs=5, default=None,
                    metavar=("MODE", "RANK", "WORLD", "PORT", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.mesh_worker:
        return mesh_worker(*args.mesh_worker)

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

    from mgat_graphsage_torch.chem import native
    from mgat_graphsage_torch.data import (
        TEST_CSV, TRAIN_CSV, MolecularDataset, StandardScaler, load_csv)
    from mgat_graphsage_torch.eval.predict import (
        Predictor, predict_csv, predict_dataset)
    from mgat_graphsage_torch.models import build_model, reset_parameters
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
    # the host featuriser with g++ in a thread, beside one nvcc per kernel
    native_cmd = " ".join(["g++", *native.GXX_FLAGS, os.path.relpath(
        native.SOURCE, REPO), "-o", os.path.relpath(native.library_path(),
                                                    REPO)])
    native_build = []

    def build_native():
        t = time.perf_counter()
        try:
            native.get_lib()
        except Exception as e:  # noqa: BLE001 -- raised below, in main
            native_build.append(e)
        else:
            native_build.append(time.perf_counter() - t)

    gxx = threading.Thread(target=build_native)
    t0 = time.perf_counter()
    gxx.start()
    libs = _build.build_all()
    nvcc_s = time.perf_counter() - t0
    gxx.join()
    if isinstance(native_build[0], Exception):
        raise native_build[0]
    log(f"[2] built {', '.join(os.path.relpath(p, REPO) for p in libs)} "
        f"in {nvcc_s:.1f} s; {native_cmd} in {native_build[0]:.2f} s "
        f"(in a thread beside nvcc)")
    for name in _build.KERNELS:
        for line in _build.ptxas_report(name):
            log(f"[2] ptxas {name}.cu {line}")

    test_smiles, test_y = load_csv(TEST_CSV)
    ds64 = MolecularDataset(test_smiles[:BATCH], test_y[:BATCH],
                            max_nodes=n_nodes, max_edges=n_edges,
                            verbose=False)
    assert len(ds64) == BATCH, "a test molecule fell outside the budget"
    edges64 = torch.from_numpy(ds64.edges).to(dev)
    emask64 = torch.from_numpy(ds64.edge_mask).to(dev)
    rng = np.random.default_rng(args.seed)

    train_smiles, train_y = load_csv(TRAIN_CSV)
    ds128 = MolecularDataset(train_smiles[:128], train_y[:128],
                             max_nodes=n_nodes, max_edges=n_edges,
                             verbose=False)
    assert len(ds128) == 128, "a train molecule fell outside the budget"
    edges128 = torch.from_numpy(ds128.edges).to(dev)
    emask128 = torch.from_numpy(ds128.edge_mask).to(dev)
    adj_err = check_adjacency(torch, dev, rng, args.seed, edges64, emask64,
                              edges128, emask128)

    # ---- 4a. the model, its checkpoint, and the serving path's q/k/v ----
    cfg = get_config("flagship")
    model = reset_parameters(build_model(cfg),
                             torch.Generator().manual_seed(args.seed))
    n_params = sum(p.numel() for p in model.parameters())
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
    def rand_attn(b, n, f, dead=True):
        """Random q, k_new, v; each molecule's first 1..n nodes real, and
        the last molecule fully masked when ``dead``."""
        q, kk, v = (torch.from_numpy(rng.standard_normal((b, n, f))
                                     .astype(np.float32)).to(dev)
                    for _ in range(3))
        m = np.zeros((b, n), np.float32)
        for i in range(b):
            m[i, :int(rng.integers(1, n + 1))] = 1.0
        if dead:
            m[-1] = 0.0                            # fully-masked molecule
        return q, kk, v, torch.from_numpy(m).to(dev)

    attn_cases = {"serving": (serve_q, serve_k, serve_v, nm64),
                  "random": rand_attn(BATCH, n_nodes, 35),
                  "n128_f128": rand_attn(16, 128, 128),
                  "n37_f35": rand_attn(8, 37, 35),
                  "n5_f3": rand_attn(4, 5, 3),
                  "b1": rand_attn(1, n_nodes, 35, dead=False),
                  "b200": rand_attn(200, n_nodes, 35),
                  "n84_f128": rand_attn(16, 84, 128)}
    attn_err = 0.0
    with torch.inference_mode():
        for name, (q, kk, v, m) in attn_cases.items():
            for residual in (True, False):
                got = fused_masked_attention_cuda(q, kk, v, m, residual)
                want = attention_plain(q, kk, v, m, residual)
                again = fused_masked_attention_cuda(q, kk, v, m, residual)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                attn_err = max(attn_err, err)
                if not (torch.isfinite(got).all()
                        and torch.allclose(got, want, atol=1e-5, rtol=1e-5)):
                    raise AssertionError(
                        f"attention kernel differs from its plain version on "
                        f"{name} residual={residual}: max |err| {err}")
                if not torch.equal(got, again):
                    raise AssertionError(f"attention kernel does not repeat "
                                         f"bit for bit on {name}")
                dead = m.sum(1) == 0
                if dead.any() and not residual \
                        and got[dead].abs().max() != 0:
                    raise AssertionError(f"a fully-masked molecule must give "
                                         f"0 ({name})")
                log(f"[3] attention {name:<9} {tuple(q.shape)} "
                    f"residual={residual!s:<5} max |err| {err:.3e}, repeats "
                    f"bit for bit")

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

    reset_counts()
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
    with plain_path():
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
    adj_t = {ed.shape[0]: adjacency_times(torch, timer, ed, em, n)
             for ed, em in ((edges64, emask64), (edges128, emask128))}
    with torch.inference_mode():
        attn_ms = timer(lambda: fused_masked_attention_cuda(
            serve_q, serve_k, serve_v, nm64, True))
        attn_plain_ms = timer(lambda: attention_plain(
            serve_q, serve_k, serve_v, nm64, True))
        key_mask = (nm64 > 0).unsqueeze(1)         # [B, 1, N] over keys
        sdpa = torch.nn.functional.scaled_dot_product_attention
        attn_lib_ms = timer(lambda: sdpa(serve_k, serve_q, serve_v,
                                         attn_mask=key_mask) + serve_v)
    attn_bound = bound(3 * b * n * f * 4 + b * n * 4 + b * n * f * 4,
                       4 * b * n * n * f + 5 * b * n * n)
    for name, ms, plain, lib, (bms, by) in (
            ("adjacency at B=64 (serving)", *adj_t[64]),
            ("adjacency at B=128 (training)", *adj_t[128]),
            ("attention at the serving shape", attn_ms, attn_plain_ms,
             attn_lib_ms, attn_bound)):
        log(f"[5] {name}: kernel {ms * 1e3:.2f} us, plain "
            f"{plain * 1e3:.2f} us, library {lib * 1e3:.2f} us, bound "
            f"{bms * 1e3:.3f} us ({by}), bound share {bms / ms:.4f} on "
            f"{card}")
    test_feats = featurise_both(MolecularDataset, test_smiles, test_y)
    nat_s, py_s = test_feats[2:]
    log(f"[5] host featurisation of the {n_test} test molecules "
        f"(MolecularDataset, graphs + ECFP-1024): native {nat_s:.3f} s "
        f"({n_test / nat_s:.1f} mol/s), Python {py_s:.3f} s "
        f"({n_test / py_s:.1f} mol/s), {py_s / nat_s:.1f}x, on {card}")
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
    kern = device_events(torch, prof)
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

    # ---- 6. kernel 3 against its plain version ---------------------------
    from mgat_graphsage_torch.data import VAL_CSV
    from mgat_graphsage_torch.ops.attention import (
        attention_bwd_cuda, attention_bwd_plain)
    from mgat_graphsage_torch.ops.cnn import (
        cnn_chain_bwd_cuda, cnn_chain_bwd_plain, dy3_cuda, dy3_plain)
    from mgat_graphsage_torch.train import Trainer

    val_smiles, val_y = load_csv(VAL_CSV)
    t0 = time.perf_counter()
    train_ds = MolecularDataset(train_smiles, train_y, fit_scaler=True,
                                verbose=False)
    val_ds = MolecularDataset(val_smiles, val_y, scaler=train_ds.scaler,
                              max_nodes=train_ds.max_nodes,
                              max_edges=train_ds.max_edges, verbose=False)
    log(f"[6] featurised {len(train_ds)} train + {len(val_ds)} validation "
        f"molecules in {time.perf_counter() - t0:.1f} s; training budget "
        f"N={train_ds.max_nodes}, E={train_ds.max_edges}")
    tcfg = get_config("flagship", epochs=1)
    tb = tcfg.batch_size
    probe = Trainer(tcfg, train_ds, val_ds)
    batch = next(probe._batches(train_ds, tb,
                                np.random.default_rng(tcfg.seed)))
    gat = predictor.model.gat_graphsage.conv1
    with torch.no_grad():
        x = batch["nodes"]
        tq = gat.query_transform(x).contiguous()
        k = gat.key_transform(x)
        tk = gat.linear_transform(
            torch.cat([gat.conv3(k), gat.conv5(k), k], -1)).contiguous()
        tv = gat.value_transform(x).contiguous()
    tmask = batch["node_mask"].contiguous()
    dead = tmask.clone()
    dead[-1] = 0.0                                 # a fully-masked molecule
    attn_bwd_err = check_attention_bwd(torch, dev, rng, {
        "train": (tq, tk, tv, dead),
        "random": rand_attn(tb, train_ds.max_nodes, 35),
        "n128_f35": rand_attn(16, 128, 35),
        "n84_f128": rand_attn(16, 84, 128),
        "n37_f35": rand_attn(8, 37, 35),
        "n5_f3": rand_attn(4, 5, 3)})
    check_attn_bitwise(torch, dev, rng)

    # ---- 7. kernels 4 and 5 against their plain versions -----------------
    dy, y1, y2, y3, d3, dy3_err, chain_err = check_cnn_kernels(
        torch, dev, rng, predictor.model, batch["fp"].contiguous())

    # ---- 8. full-width flagship training, default and cnn_pallas_bwd -----
    runs = {}
    for pb in (False, True):
        cfg_pb = get_config("flagship", epochs=1, cnn_pallas_bwd=pb)
        losses = first_steps(torch, Trainer, cfg_pb, train_ds, val_ds)
        with plain_path():
            plain = first_steps(torch, Trainer, cfg_pb, train_ds, val_ds)
        step_err = float(np.max(np.abs(losses - plain) / np.abs(plain)))
        if not np.isfinite(losses).all() or step_err > 1e-4:
            raise AssertionError(f"cnn_pallas_bwd={pb}: first 4 losses "
                                 f"{losses} vs plain path {plain}")
        ckdir = os.path.join(tmp.name, f"train_pb{int(pb)}")
        trainer = Trainer(cfg_pb, train_ds, val_ds, ckpt_dir=ckdir,
                          log_path=os.path.join(ckdir, "log.jsonl"))
        reset_counts()
        t0 = time.perf_counter()
        _, best, hist = trainer.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = read_counts()
        need = ["dense_adjacency_cuda", "fused_masked_attention_cuda",
                "attention_bwd_cuda"]
        cnn_k = ["dy3_cuda", "cnn_chain_bwd_cuda"]
        for name in need + (cnn_k if pb else []):
            if counts[name] <= 0:
                raise AssertionError(f"training (cnn_pallas_bwd={pb}) "
                                     f"never launched {name}")
        if not pb and any(counts[n] for n in cnn_k):
            raise AssertionError("the CNN kernels ran with cnn_pallas_bwd "
                                 "off")
        row = hist[-1]
        if not all(np.isfinite(row[k]) for k in ("train_loss", "val_mse",
                                                  "original_mse")):
            raise AssertionError(f"non-finite training metrics: {row}")
        served = Predictor(os.path.join(ckdir, "best_model.pt"))(val_smiles)
        ev = trainer.evaluate(best)
        serve_err = float(np.abs(served[val_ds.kept_indices]
                                 - ev["pred_denorm"]).max())
        if not np.isfinite(served).all() or serve_err > 1e-4:
            raise AssertionError(f"best checkpoint serves {serve_err} "
                                 "pChEMBL away from the trainer")
        runs[pb] = {"counts": counts, "steps": -(-len(train_ds) // tb)}
        log(f"[8] cnn_pallas_bwd={pb}: first 4 losses {np.round(losses, 6)} "
            f"vs plain path rel err {step_err:.2e} (limit 1e-4); one epoch "
            f"{fit_s:.2f} s (train {row['epoch_time_s']:.2f} s, "
            f"{row['molecules_per_s']:.1f} mol/s incl. first-step warm-up), "
            f"loss {row['train_loss']:.4f}, val MSE {row['val_mse']:.4f}, "
            f"original MSE {row['original_mse']:.4f}; launches {counts}; "
            f"best checkpoint served, max |err| {serve_err:.2e} pChEMBL")
    cli = subprocess.run(
        [sys.executable, "-m", "mgat_graphsage_torch.train.run", "--preset",
         "flagship", "--limit", "256", "--epochs", "1", "--ckpt-dir",
         os.path.join(tmp.name, "cli")], cwd=REPO, capture_output=True,
        text=True, timeout=600)
    if cli.returncode != 0 or "Training completed" not in cli.stdout:
        raise AssertionError(f"the training CLI failed:\n{cli.stdout}\n"
                             f"{cli.stderr}")
    log("[8] python -m mgat_graphsage_torch.train.run --preset flagship "
        "--limit 256 --epochs 1 on CUDA: " + cli.stdout.strip()
        .splitlines()[0])

    # ---- 9. the gate: N = 160, serving and one training step -------------
    ckpt160 = os.path.join(tmp.name, "flagship_n160.pt")
    save_checkpoint(ckpt160, model.state_dict(),
                    {"config": dataclasses.asdict(cfg),
                     "scaler": scaler.to_dict(),
                     "max_nodes": 160, "max_edges": 352})
    reset_counts()
    p160 = Predictor(ckpt160)(test_smiles[:BATCH])
    c160 = read_counts()
    with plain_path():
        p160_plain = Predictor(ckpt160)(test_smiles[:BATCH])
    e160 = float(np.abs(p160 - p160_plain).max())
    if not np.isfinite(p160).all() or e160 > 1e-4 \
            or c160["fused_masked_attention_cuda"] != 0 \
            or c160["dense_adjacency_cuda"] <= 0:
        raise AssertionError(f"N=160 serving: max |err| {e160}, launches "
                             f"{c160}")
    ds160 = MolecularDataset(train_smiles[:tb], train_y[:tb],
                             scaler=train_ds.scaler, max_nodes=160,
                             max_edges=352, verbose=False)
    cfg160 = get_config("flagship", cnn_pallas_bwd=True)

    def step160():
        t = Trainer(cfg160, ds160)
        st = t.init_state()
        b = next(t._batches(ds160, tb))
        return t.train_step(st, b, t._dropout_generator(0))["loss"].item()

    l160 = step160()
    with plain_path():
        l160_plain = step160()
    if not np.isfinite(l160) or abs(l160 - l160_plain) > 1e-4 * abs(
            l160_plain):
        raise AssertionError(f"N=160 train step: {l160} vs {l160_plain}")
    log(f"[9] N=160: Predictor on {BATCH} molecules vs plain path max |err| "
        f"{e160:.2e} pChEMBL (attention on the plain path by the gate, "
        f"launches {c160}); one train step loss {l160:.6f} vs plain "
        f"{l160_plain:.6f}")

    # ---- 10. training timings and profile --------------------------------
    k2t_ms = timer(lambda: fused_masked_attention_cuda(tq, tk, tv, tmask,
                                                       True))
    k2t_plain_ms = timer(lambda: attention_plain(tq, tk, tv, tmask, True))
    tkey_mask = (tmask > 0).unsqueeze(1)
    k2t_lib_ms = timer(lambda: sdpa(tk, tq, tv, attn_mask=tkey_mask) + tv)
    g_attn = torch.from_numpy(rng.standard_normal(tuple(tq.shape))
                              .astype(np.float32)).to(dev)
    k3_ms = timer(lambda: attention_bwd_cuda(tq, tk, tv, tmask, g_attn))
    k3_plain_ms = timer(lambda: attention_bwd_plain(tq, tk, tv, tmask,
                                                    g_attn))
    k3_lib_ms = None
    try:
        lq, lk, lv = (t.clone().requires_grad_(True) for t in (tq, tk, tv))
        with torch.enable_grad():
            lout = sdpa(lk, lq, lv, attn_mask=(tmask > 0).unsqueeze(1)) + lv
        k3_lib_ms = timer(lambda: torch.autograd.grad(
            lout, (lq, lk, lv), g_attn, retain_graph=True))
    except RuntimeError as e:
        log(f"[10] SDPA backward not timed: {e}")
    fc1_w = predictor.model.cnn.fc1.weight.detach()
    k4_ms = timer(lambda: dy3_cuda(dy, fc1_w, y3))
    k4_plain_ms = timer(lambda: dy3_plain(dy, fc1_w, y3))
    k4_lib_ms = timer(lambda: torch.where(y3 > 0, torch.matmul(
        dy, fc1_w).view(y3.shape), 0.0))
    cw = predictor.model.cnn
    w3, w2, w1 = (c.weight.detach() for c in (cw.conv3, cw.conv2, cw.conv1))
    fp_b = batch["fp"].contiguous()
    k5_ms = timer(lambda: cnn_chain_bwd_cuda(d3, y2, y1, fp_b, w3, w2))
    k5_plain_ms = timer(lambda: cnn_chain_bwd_plain(d3, y2, y1, fp_b, w3,
                                                    w2))
    d3_ncw = d3.transpose(1, 2).contiguous()
    conv_bwd = torch.ops.aten.convolution_backward

    def lib5():
        gi2, _, _ = conv_bwd(d3_ncw, y2, w3, [128], [1], [1], [1], False,
                             [0], 1, [True, True, True])
        gi1, _, _ = conv_bwd(gi2 * (y2 > 0), y1, w2, [64], [1], [1], [1],
                             False, [0], 1, [True, True, True])
        return conv_bwd(gi1 * (y1 > 0), fp_b.unsqueeze(1), w1, [32], [1],
                        [1], [1], False, [0], 1, [False, True, True])

    k5_lib_ms = timer(lib5, iters=20)
    bt, nt, ft = tq.shape
    bw = y3.shape[1]
    hh = dy.shape[1]
    k2t_bound = bound(3 * bt * nt * ft * 4 + bt * nt * 4 + bt * nt * ft * 4,
                      4 * bt * nt * nt * ft + 5 * bt * nt * nt)
    k3_bound = bound(4 * (4 * bt * nt * ft + bt * nt + 3 * bt * nt * ft),
                     10 * bt * nt * nt * ft)
    k4_bound = bound(4 * (bt * hh + hh * bw * 128 + 2 * bt * bw * 128),
                     2 * bt * hh * bw * 128)
    k5_bound = bound(4 * (bt * bw * (128 + 64 + 32 + 1) + 128 * 64 * 3
                          + 64 * 32 * 3 + 31040),
                     2 * bt * bw * (2 * 3 * (128 * 64 + 64 * 32) + 32 * 3)
                     + bt * bw * (128 + 64 + 32))
    steps_b = runs[True]["steps"]
    for name, ms, plain, lib, (bms, by), calls, cname in (
            ("attention", k2t_ms, k2t_plain_ms, k2t_lib_ms, k2t_bound,
             "SDPA + v; launches/step count the validation batches too",
             "fused_masked_attention_cuda"),
            ("attention bwd", k3_ms, k3_plain_ms, k3_lib_ms, k3_bound,
             "SDPA backward + the residual's gradient (more than one call)",
             "attention_bwd_cuda"),
            ("dy3", k4_ms, k4_plain_ms, k4_lib_ms, k4_bound,
             "torch.matmul + where (two calls)", "dy3_cuda"),
            ("cnn chain bwd", k5_ms, k5_plain_ms, k5_lib_ms, k5_bound,
             "3 convolution_backward + 2 ReLU masks (five calls)",
             "cnn_chain_bwd_cuda")):
        log(f"[10] {name} at the training shape: kernel {ms * 1e3:.2f} us, "
            f"plain {plain * 1e3:.2f} us, library "
            f"{'n/a' if lib is None else f'{lib * 1e3:.2f} us'} ({calls}), "
            f"bound {bms * 1e3:.2f} us ({by}), bound share "
            f"{bms / ms:.4f}, "
            f"{runs[True]['counts'][cname] / steps_b:.2f} launches/step, "
            f"on {card}")
    step_ms = {}
    for pb in (False, True):
        t = Trainer(get_config("flagship", cnn_pallas_bwd=pb), train_ds)
        st = t.init_state()
        step_ms[pb] = time_steps(torch, t, st, train_ds)
        log(f"[10] train step, flagship f32 B={tb}, cnn_pallas_bwd={pb}: "
            f"{step_ms[pb]:.3f} ms ({tb / step_ms[pb] * 1e3:.1f} mol/s), "
            f"on {card}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        t.train_epoch(st, 1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = device_events(torch, prof)
    busy_us = sum(ev.self_device_time_total for ev in kern)
    log(f"[10] profile of one training epoch (cnn_pallas_bwd=True, "
        f"{steps_b} steps): wall {wall_us:.0f} us, device busy "
        f"{busy_us:.0f} us ({100 * busy_us / wall_us:.2f}%); top kernels:")
    ranked = sorted(kern, key=lambda ev: -ev.self_device_time_total)
    ours = ours + ("masked_attention_bwd_kernel", "cnn_dy3_kernel",
                   "cnn_chain_bwd_kernel", "cnn_chain_reduce_kernel")
    for i, ev in enumerate(ranked):
        if i < 12 or any(o in ev.key for o in ours):
            log(f"  #{i + 1:<3d}{ev.self_device_time_total:9.1f} us  "
                f"x{ev.count:<4d} {ev.key[:90]}")

    # ---- 11. mixed precision at full width --------------------------------
    bf16_counts = bf16_phase(torch, train_ds, val_ds, val_smiles,
                             test_smiles, tmp.name, card, timer)

    # ---- 12. the host data and serving layer -----------------------------
    serve_counts, compact_counts = serve_phase(
        torch, ckpt, predictor, test_smiles, train_smiles, train_y,
        test_feats, plain_preds, train_ds, val_ds, card,
        (native_cmd, native_build[0]))

    # ---- 13. the baselines and the gat10 ablation --------------------------
    base_counts, adj32, base_adj_err = baselines_phase(
        torch, train_smiles, train_y, val_smiles, val_y, tmp.name, card,
        timer)

    # ---- 14. the fingerprint suite -----------------------------------------
    fp_counts = fingerprint_phase(torch, train_smiles, train_y, val_smiles,
                                  val_y, tmp.name, card)

    # ---- 15. interpretability on the phase-8 checkpoint ------------------
    explain_counts = explain_phase(
        torch, os.path.join(tmp.name, "train_pb0", "best_model.pt"),
        tmp.name, card)

    # ---- 16. kernels 4-5 in bf16 on the bf16 training path ---------------
    bf16_rows = bf16_cnn_phase(torch, train_ds, val_ds, val_smiles,
                               tmp.name, card, timer)

    # ---- 17. reference-checkpoint interchange and tooling ----------------
    interchange_phase(torch, test_smiles, tmp.name, card, args.seed)

    # ---- 18. the mesh: NCCL at one rank, two ranks over gloo --------------
    mesh_runs = mesh_phase(tmp.name, card)
    tmp.cleanup()

    train_counts = runs[True]["counts"]
    kernels = [
        {"name": "dense_adjacency", "route": "cuda",
         "source": "mgat_graphsage_torch/csrc/adjacency.cu",
         "replaces": "mgat_graphsage_tpu/ops/pallas_adjacency.py:56",
         "launches": train_counts["dense_adjacency_cuda"],
         "bf16_launches": bf16_counts["dense_adjacency_cuda"],
         "max_abs_err": max(adj_err, base_adj_err),
         "ms": adj_t[64][0], "plain_ms": adj_t[64][1],
         "bound_ms": adj_t[64][3][0], "bound_by": adj_t[64][3][1],
         "bound_share": adj_t[64][3][0] / adj_t[64][0],
         "library_ms": adj_t[64][2],
         "train_ms": adj_t[128][0], "train_plain_ms": adj_t[128][1],
         "train_bound_ms": adj_t[128][3][0],
         "train_bound_by": adj_t[128][3][1],
         "train_bound_share": adj_t[128][3][0] / adj_t[128][0],
         "train_library_ms": adj_t[128][2],
         "gcn_ms": adj32[0], "gcn_plain_ms": adj32[1],
         "gcn_bound_ms": adj32[3][0], "gcn_bound_by": adj32[3][1],
         "gcn_bound_share": adj32[3][0] / adj32[0],
         "gcn_library_ms": adj32[2],
         "launches_per_step": train_counts["dense_adjacency_cuda"]
         / runs[True]["steps"]},
        {"name": "fused_masked_attention", "route": "cuda",
         "source": "mgat_graphsage_torch/csrc/attention.cu",
         "replaces": "mgat_graphsage_tpu/ops/pallas_attention.py:84",
         "launches": train_counts["fused_masked_attention_cuda"],
         "bf16_launches": bf16_counts["fused_masked_attention_cuda"],
         "max_abs_err": attn_err,
         "ms": attn_ms, "plain_ms": attn_plain_ms,
         "bound_ms": attn_bound[0], "bound_by": attn_bound[1],
         "bound_share": attn_bound[0] / attn_ms,
         "library_ms": attn_lib_ms,
         "train_ms": k2t_ms, "train_plain_ms": k2t_plain_ms,
         "train_bound_ms": k2t_bound[0], "train_bound_by": k2t_bound[1],
         "train_bound_share": k2t_bound[0] / k2t_ms,
         "train_library_ms": k2t_lib_ms,
         "launches_per_step": train_counts["fused_masked_attention_cuda"]
         / runs[True]["steps"]},
        {"name": "fused_masked_attention_bwd", "route": "cuda",
         "source": "mgat_graphsage_torch/csrc/attention_bwd.cu",
         "replaces": "mgat_graphsage_tpu/ops/pallas_attention.py:146",
         "launches": train_counts["attention_bwd_cuda"],
         "bf16_launches": bf16_counts["attention_bwd_cuda"],
         "max_abs_err": attn_bwd_err, "ms": k3_ms, "plain_ms": k3_plain_ms,
         "bound_ms": k3_bound[0], "bound_by": k3_bound[1],
         "bound_share": k3_bound[0] / k3_ms, "library_ms": k3_lib_ms},
        {"name": "cnn_dy3", "route": "cuda",
         "source": "mgat_graphsage_torch/csrc/cnn_dy3.cu",
         "replaces": "mgat_graphsage_tpu/ops/pallas_cnn.py:127",
         "launches": train_counts["dy3_cuda"],
         "bf16_launches": bf16_counts["dy3_cuda"], "max_abs_err": dy3_err,
         "ms": k4_ms, "plain_ms": k4_plain_ms, "bound_ms": k4_bound[0],
         "bound_by": k4_bound[1], "bound_share": k4_bound[0] / k4_ms,
         "library_ms": k4_lib_ms},
        {"name": "cnn_chain_bwd", "route": "cuda",
         "source": "mgat_graphsage_torch/csrc/cnn_chain_bwd.cu",
         "replaces": "mgat_graphsage_tpu/ops/pallas_cnn.py:264",
         "launches": train_counts["cnn_chain_bwd_cuda"],
         "bf16_launches": bf16_counts["cnn_chain_bwd_cuda"],
         "max_abs_err": chain_err, "ms": k5_ms, "plain_ms": k5_plain_ms,
         "bound_ms": k5_bound[0], "bound_by": k5_bound[1],
         "bound_share": k5_bound[0] / k5_ms, "library_ms": k5_lib_ms},
    ]
    for row, (_, w, _) in zip(kernels, ROUTES):
        row["serve_launches"] = serve_counts[w]
        row["compact_launches"] = compact_counts[w]
        row["baseline_launches"] = base_counts[w]
        row["fingerprint_launches"] = fp_counts[w]
        row["explain_launches"] = explain_counts[w]
        row["mesh_launches"] = [r["mesh"]["counts"][w]
                                for r in mesh_runs["b"]]
    log(json.dumps({"kernels": kernels + bf16_rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
