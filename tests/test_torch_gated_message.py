"""GraphGPS's gated message passing kernels (``csrc/gated_message.cu``) and
their plain version (``ops/gated_message.py``).

On the CPU: the plain version of the forward kernel (per-target lists of
real slots) against the explicit ``GatedMessage``, and of the backward
kernel (gates and sums recomputed from the inputs, sums over per-target
and per-source lists) against autograd through the explicit path, in f64
to 1e-12, for random edges under random masks that are no prefix, a
target with no incoming edge, self-loops, repeated edges, a batch of 1
and the support limits (N = 128, E = 256); masked slots, whatever their
indices and values, change no real output; a ``gradcheck`` of the kernel
path's ``autograd.Function`` in f64; the support check's limits; the
kernel wrappers returning the plain version on CPU tensors; the path
counters; and the benchmark's reader of ``gps.message_roofline.train``.

On the card (marked ``card``; they skip without CUDA): at the training
cell's shape (B = 1024, N = 80, E = 176, D = 384) and at small ragged ones,
in bf16 and f32, the kernels against the explicit path and an f64 sum,
and one GraphGPS training step through the kernels against the explicit
path.  This file imports no JAX, so on the card it runs without the
suite's ``conftest.py``::

    python3 -m pytest --noconftest -q tests/test_torch_gated_message.py
"""

import os
import sys
import types

import pytest
import torch

from mgat_graphsage_torch.ops import gated_message as gm
from mgat_graphsage_torch.utils import telemetry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _graph(b, n, e, kind="random", seed=0, device="cpu"):
    """``edges [b, 2, e]`` int32 and a 0/1 ``mask [b, e]`` (f64): about a
    third of the slots real, scattered (no prefix); real slots join atoms
    of the molecule's first ``size`` atoms, masked slots either 0 -> 0
    (the featuriser's padding) or anywhere.  ``kind``: ``isolated`` keeps
    every target off atom ``n - 1`` (no incoming edge), ``loops`` makes a
    quarter of the real slots self-loops, ``repeats`` repeats one edge of
    each molecule in many slots."""
    g = torch.Generator().manual_seed(seed)
    sizes = torch.randint(1, n + 1, (b, 1), generator=g)
    sizes[0] = n
    mask = torch.rand(b, e, generator=g) < 0.35
    mask[0, -1] = True
    u = torch.rand(b, 2, e, generator=g)
    real = (u * sizes[:, None]).long().clamp_max(n - 1)
    if kind == "isolated":
        real[:, 1] = real[:, 1] % max(n - 1, 1)
    elif kind == "loops":
        loop = torch.rand(b, e, generator=g) < 0.25
        real[:, 1] = torch.where(loop, real[:, 0], real[:, 1])
    elif kind == "repeats":
        rep = torch.rand(b, e, generator=g) < 0.5
        real = torch.where(rep[:, None], real[:, :, :1], real)
    pad = torch.where(torch.rand(b, 1, e, generator=g) < 0.5,
                      torch.zeros_like(real),
                      torch.randint(0, n, real.shape, generator=g))
    edges = torch.where(mask[:, None], real, pad).to(torch.int32)
    return edges.to(device), mask.double().to(device)


def _inputs(b, n, e, d, dtype=torch.float64, seed=0, device="cpu"):
    g = torch.Generator(device).manual_seed(seed)
    rows = [torch.randn(b, n, d, generator=g, device=device) for _ in range(3)]
    ce = torch.randn(b, e, d, generator=g, device=device)
    dh, eh, bh = (t.to(dtype) for t in rows)
    return dh, eh, ce.to(dtype), bh


def _explicit(dh, eh, ce, bh, edges, mask):
    src, dst = gm._flat(edges, dh.shape[1])
    return gm.GatedMessage.apply(dh, eh, ce, bh, src, dst, mask.reshape(-1))


def _explicit_grads(x, edges, mask, g_agg, g_e):
    """The four inputs' gradients through the explicit path's autograd for
    cotangents ``g_agg`` and ``g_e`` (None: that output unused)."""
    leaves = [t.clone().requires_grad_(True) for t in x]
    agg, e = _explicit(*leaves, edges, mask)
    loss = 0.0
    if g_agg is not None:
        loss = loss + (agg * g_agg).sum()
    if g_e is not None:
        loss = loss + (e * g_e).sum()
    loss.backward()
    return [t.grad for t in leaves]


# b, n, e, d, kind
CASES = [pytest.param(3, 7, 12, 8, "random", id="random"),
         pytest.param(4, 11, 30, 16, "isolated", id="target-without-edges"),
         pytest.param(2, 9, 40, 8, "loops", id="self-loops"),
         pytest.param(2, 6, 50, 8, "repeats", id="repeated-edges"),
         pytest.param(1, 20, 44, 24, "random", id="batch-of-1"),
         pytest.param(2, gm.MAX_N, gm.MAX_E, 8, "random", id="limits")]


@pytest.mark.parametrize("b,n,e,d,kind", CASES)
def test_plain_forward_matches_the_explicit_path(b, n, e, d, kind):
    edges, mask = _graph(b, n, e, kind, seed=n)
    x = _inputs(b, n, e, d, seed=e)
    got = gm.gated_message_fwd_plain(*x, edges, mask)
    want = _explicit(*x, edges, mask)
    for a, w in zip(got, want):
        assert a.dtype == torch.float64 and a.shape == w.shape
        assert _rel(a, w) <= 1e-12
    if kind == "isolated":
        assert (got[0][:, n - 1] == 0).all()


@pytest.mark.parametrize("use", ["both", "agg", "e"])
@pytest.mark.parametrize("b,n,e,d,kind", CASES)
def test_plain_backward_matches_autograd_through_the_explicit_path(
        b, n, e, d, kind, use):
    """The backward kernel's algorithm, from the inputs alone, against
    autograd through the explicit path; an unused output's gradient is
    None (the explicit path's autograd gets zeros), and without ``g_agg``
    ``dbh`` is None where the explicit path's is zero."""
    edges, mask = _graph(b, n, e, kind, seed=n + 1)
    x = _inputs(b, n, e, d, seed=e + 1)
    g = torch.Generator().manual_seed(7)
    g_agg = None if use == "e" else torch.randn(
        b, n, d, generator=g, dtype=torch.float64)
    g_e = None if use == "agg" else torch.randn(
        b, e, d, generator=g, dtype=torch.float64)
    got = gm.gated_message_bwd_plain(g_agg, g_e, *x, edges, mask)
    want = _explicit_grads(x, edges, mask, g_agg, g_e)
    for name, a, w in zip(("ddh", "deh", "dce", "dbh"), got, want):
        if a is None:
            assert name == "dbh" and g_agg is None and not w.any()
            continue
        assert a.shape == w.shape, name
        assert _rel(a, w) <= 1e-12, name


def test_masked_slots_change_no_real_output():
    """Other indices and values at the masked slots: the same ``agg`` bits,
    the same ``e`` at the real slots, and with no gradient at the masked
    slots' ``e`` the same input gradients but at their ``ce``."""
    b, n, e, d = 3, 10, 40, 8
    edges, mask = _graph(b, n, e, seed=3)
    dh, eh, ce, bh = _inputs(b, n, e, d, seed=4)
    off = mask == 0
    g = torch.Generator().manual_seed(5)
    edges2 = torch.where(off[:, None], torch.randint(
        0, n, edges.shape, generator=g, dtype=torch.int32), edges)
    ce2 = torch.where(off[..., None], ce * 7.0 + 3.0, ce)
    a1, e1 = gm.gated_message_fwd_plain(dh, eh, ce, bh, edges, mask)
    a2, e2 = gm.gated_message_fwd_plain(dh, eh, ce2, bh, edges2, mask)
    assert torch.equal(a1, a2) and torch.equal(e1[~off], e2[~off])
    assert not torch.equal(e1[off], e2[off])
    g_agg = torch.randn(b, n, d, generator=g, dtype=torch.float64)
    g_e = torch.randn(b, e, d, generator=g, dtype=torch.float64) \
        * (~off)[..., None]
    r1 = gm.gated_message_bwd_plain(g_agg, g_e, dh, eh, ce, bh, edges, mask)
    r2 = gm.gated_message_bwd_plain(g_agg, g_e, dh, eh, ce2, bh, edges2,
                                    mask)
    for k in (0, 1, 3):
        assert torch.equal(r1[k], r2[k])
    assert torch.equal(r1[2], r2[2]) and not r1[2][off].any()


def test_kernel_path_gradcheck_f64():
    """``GatedMessageKernel`` (its wrappers return the plain versions on
    CPU tensors) against finite differences, both outputs used."""
    edges, mask = _graph(2, 5, 14, "loops", seed=2)
    x = [t.requires_grad_(True) for t in _inputs(2, 5, 14, 8, seed=3)]
    assert torch.autograd.gradcheck(
        lambda *a: gm.GatedMessageKernel.apply(*a, edges, mask), x)


@pytest.mark.parametrize("args,ok", [
    ((80, 176, 384, torch.bfloat16), True),
    ((80, 176, 384, torch.float32), True),
    ((gm.MAX_N, gm.MAX_E, 8, torch.bfloat16), True),
    ((1, 1, 8, torch.float32), True),
    ((80, 176, 384, torch.float64), False),
    ((80, 176, 384, torch.float16), False),
    ((gm.MAX_N + 1, 176, 384, torch.bfloat16), False),
    ((80, gm.MAX_E + 1, 384, torch.bfloat16), False),
    ((80, 176, 380, torch.bfloat16), False),
    ((80, 176, 4, torch.bfloat16), False),
    ((0, 176, 384, torch.bfloat16), False),
    ((80, 0, 384, torch.bfloat16), False)])
def test_kernels_support_limits(args, ok):
    assert gm.kernels_support(*args) is ok


def test_cpu_wrappers_return_the_plain_version():
    edges, mask = _graph(2, 8, 20, seed=6)
    x = _inputs(2, 8, 20, 16, dtype=torch.float32, seed=7)
    launches = (gm.gated_message_cuda.launches,
                gm.gated_message_cuda.launches_bf16,
                gm.gated_message_bwd_cuda.launches,
                gm.gated_message_bwd_cuda.launches_bf16)
    got = gm.gated_message_cuda(*x, edges, mask)
    want = gm.gated_message_fwd_plain(*x, edges, mask)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    g = torch.randn(2, 8, 16), torch.randn(2, 20, 16)
    got = gm.gated_message_bwd_cuda(*g, *x, edges, mask)
    want = gm.gated_message_bwd_plain(*g, *x, edges, mask)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    assert launches == (gm.gated_message_cuda.launches,
                        gm.gated_message_cuda.launches_bf16,
                        gm.gated_message_bwd_cuda.launches,
                        gm.gated_message_bwd_cuda.launches_bf16)


@pytest.mark.parametrize("grad", [False, True])
def test_cpu_calls_count_on_the_explicit_path(grad):
    """On the CPU every call takes the explicit path, in f32 and bf16 alike
    (the kernels run only on CUDA), counted under ``explicit`` with its real
    edges and slots; no kernel launch, and the snapshot reads the
    counters."""
    edges, mask = _graph(2, 8, 20, seed=8)
    for dtype in (torch.float32, torch.bfloat16):
        x = [t.requires_grad_(grad)
             for t in _inputs(2, 8, 20, 16, dtype=dtype, seed=9)]
        before = telemetry.snapshot()
        with torch.set_grad_enabled(grad):
            agg, e = gm.gated_message(*x, edges, mask.to(dtype))
            if grad:
                (agg.float().sum() + e.float().sum()).backward()
        after = telemetry.snapshot()
        was, now = before["gated_message"], after["gated_message"]
        assert {k: now[k] - was[k] for k in now} == {
            "explicit": 1, "kernel": 0, "edge_slots": 40,
            "edges": int(mask.count_nonzero())}
        for name in ("gated_message_cuda", "gated_message_bwd_cuda",
                     "gated_message_cuda_bf16",
                     "gated_message_bwd_cuda_bf16"):
            assert after["launches"][name] == before["launches"][name]


def test_benchmark_reads_the_message_roofline(monkeypatch):
    """``gps.message_roofline.train`` (``portbench/metrics/``): the least
    time of the window's message work (4 node and 2 edge tensors forward,
    7 and 3 backward, at the compute dtype's width, every layer; training
    rows both ways, validation rows forward) over the ``gps.message`` span's
    device seconds in the untraced epochs; nothing without the span or
    where the units are not the window's epochs."""
    sys.path.insert(0, REPO)
    from portbench.harness.flops import HBM_BYTES_PER_S
    from portbench.harness.spec import Spec

    read = Spec(REPO).reader("gps.message_roofline.train")
    config = {"model": {"hidden_size": 384, "num_hidden_layers": 10},
              "budget": [80, 176], "numerics": "bf16"}
    counters = {"window_s": 2.0, "epochs": 2, "train_rows": 2 * 3072,
                "eval_rows": 2 * 1024}
    node, edge = 1024 * 80 * 384 * 2, 1024 * 176 * 384 * 2
    fwd, bwd = 4 * node + 2 * edge, 7 * node + 3 * edge
    assert fwd == 528_482_304 and bwd == 855_638_016
    least = 10 * 2 * (3 * (fwd + bwd) + fwd) / HBM_BYTES_PER_S
    r = types.SimpleNamespace(counters=counters, config=config)
    for spans, want in (({"gps.message": 0.3}, 100.0 * least / 0.6),
                        ({"graphormer.attention": 0.3}, None)):
        reg = telemetry.Registry()
        monkeypatch.setattr(telemetry, "unprofiled_tail", reg.unprofiled_tail)
        for profiled in (True, False, False):
            for kind in ("train_epoch", "evaluate"):
                with reg.unit(kind) as rec:
                    rec.profiled = profiled
                    if kind == "train_epoch":
                        rec.device.update(spans)
                    else:
                        rec.device.update({k: 0.0 for k in spans})
        assert read(r) == (want if want is None else pytest.approx(want))
        assert read(types.SimpleNamespace(
            counters=dict(counters, epochs=3), config=config)) is None


# ---- on the card ------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(got, exact, dtype):
    """Elementwise against the f64 sum: a bf16 output within 2^-7 of its
    value (bf16 keeps 8 significant bits, so rounding moves a value by up
    to 2^-8 of itself; twice that) plus 1e-5 of the output's largest
    magnitude (the f32 sums, over lists of up to ~130 terms, a few ulps
    each of their largest term); an f32 output within 1e-6 of its value
    plus the same 1e-5."""
    got, exact = got.double(), exact.double()
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-6
    tol = rel * exact.abs() + 1e-5 * exact.abs().max()
    return bool(((got - exact).abs() <= tol).all())


# b, n, e, d, kind
CARD = [pytest.param(1024, 80, 176, 384, "random", id="cell-1024-80-176-384"),
        pytest.param(3, 21, 40, 24, "isolated", id="ragged-21-40-24"),
        pytest.param(2, 9, 30, 72, "loops", id="self-loops-d72"),
        pytest.param(2, 6, 50, 8, "repeats", id="repeated-edges-d8"),
        pytest.param(1, gm.MAX_N, gm.MAX_E, 64, "random", id="limits-b1")]


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("b,n,e,d,kind", CARD)
def test_kernels_on_the_card(cuda, b, n, e, d, kind, dtype):
    """The forward kernel's ``e`` is the explicit path's, bit for bit;
    ``agg`` and the four input gradients are within :func:`_close` of an
    f64 sum of the same inputs; a second run gives the same bits; other
    indices and values at the masked slots change no real output."""
    edges, mask = _graph(b, n, e, kind, seed=n, device=cuda)
    mask = mask.to(dtype)
    x = _inputs(b, n, e, d, dtype=dtype, seed=e, device=cuda)
    gen = torch.Generator(cuda).manual_seed(1)
    g_agg = torch.randn(b, n, d, generator=gen, device=cuda).to(dtype)
    g_e = torch.randn(b, e, d, generator=gen, device=cuda).to(dtype)
    fwd = [gm.gated_message_cuda(*x, edges, mask) for _ in range(2)]
    bwd = [gm.gated_message_bwd_cuda(g_agg, g_e, *x, edges, mask)
           for _ in range(2)]
    want_e = _explicit(*x, edges, mask)[1]
    x64 = [t.double() for t in x]
    exact = gm.gated_message_fwd_plain(*x64, edges, mask.double())[:1] \
        + gm.gated_message_bwd_plain(g_agg.double(), g_e.double(), *x64,
                                     edges, mask.double())
    torch.cuda.synchronize()
    assert torch.equal(fwd[0][1], want_e)
    for name, got, w in zip(("agg", "ddh", "deh", "dce", "dbh"),
                            fwd[0][:1] + bwd[0], exact):
        assert got.dtype == dtype and got.shape == w.shape, name
        assert _close(got, w, dtype), name
    for a, c in zip(fwd[0] + bwd[0], fwd[1] + bwd[1]):
        assert torch.equal(a, c)
    # masked slots: other indices and values, no gradient at their e
    off = mask == 0
    edges2 = torch.where(off[:, None], torch.randint(
        0, n, edges.shape, device=cuda, dtype=torch.int32), edges)
    ce2 = torch.where(off[..., None], x[2] * 7 + 3, x[2])
    g_e = torch.where(off[..., None], 0, g_e)
    x2 = (x[0], x[1], ce2, x[3])
    a1, e1 = fwd[0]
    a2, e2 = gm.gated_message_cuda(*x2, edges2, mask)
    r1 = gm.gated_message_bwd_cuda(g_agg, g_e, *x, edges, mask)
    r2 = gm.gated_message_bwd_cuda(g_agg, g_e, *x2, edges2, mask)
    torch.cuda.synchronize()
    assert torch.equal(a1, a2) and torch.equal(e1[~off], e2[~off])
    for a, c in zip(r1, r2):
        assert torch.equal(a, c)


@pytest.mark.card
def test_gps_training_step_through_the_kernels(cuda, monkeypatch):
    """One f32 training step of a small ``GPSNet`` (TF32 off) through the
    kernels against the same step through the explicit path: the loss
    within 1e-6 and each parameter's gradient within 1e-4 of its norm (the
    two sum in other orders; a bias that a batch norm cancels has a
    gradient of round-off, held to the median's norm).  The kernel step
    is 2 layers' forward and backward launches, counted under ``kernel``
    with no explicit call."""
    from mgat_graphsage_torch.models.zoo import GPSNet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    model = GPSNet(dim=64, layers=2, heads=4, ffn_dim=64).to(cuda).train()
    b, n, e = 6, 19, 44
    edges, mask = _graph(b, n, e, seed=12, device=cuda)
    gen = torch.Generator().manual_seed(3)
    sizes = edges.max(dim=2).values.max(dim=1).values + 1
    node_mask = (torch.arange(n, device=cuda)[None] < sizes[:, None]).float()
    nodes = torch.randn(b, n, 35, generator=gen).to(cuda) * node_mask[..., None]
    types_ = torch.randint(1, 5, (b, e), generator=gen).to(cuda) \
        * (mask > 0).long()
    rwse = torch.rand(b, n, 16, generator=gen).to(cuda)

    def step():
        model.zero_grad()
        out = model(nodes, node_mask, edges, mask.float(), types_, rwse,
                    torch.Generator(cuda).manual_seed(0))
        loss = out.float().square().mean()
        loss.backward()
        return float(loss), {k: p.grad.clone()
                             for k, p in model.named_parameters()
                             if p.grad is not None}

    before = gm.counts()
    launches = (gm.gated_message_cuda.launches,
                gm.gated_message_bwd_cuda.launches)
    loss, grads = step()
    mid = gm.counts()
    assert mid["kernel"] - before["kernel"] == 2
    assert mid["explicit"] == before["explicit"]
    assert gm.gated_message_cuda.launches - launches[0] == 2
    assert gm.gated_message_bwd_cuda.launches - launches[1] == 2
    monkeypatch.setattr(gm, "kernels_support", lambda *a: False)
    want_loss, want = step()
    assert gm.counts()["explicit"] - mid["explicit"] == 2
    assert abs(loss - want_loss) <= 1e-6 * abs(want_loss)
    med = torch.tensor([float(g.norm()) for g in want.values()]).median()
    for k, g in want.items():
        assert float((grads[k] - g).norm()) \
            <= 1e-4 * max(float(g.norm()), float(med)), k
