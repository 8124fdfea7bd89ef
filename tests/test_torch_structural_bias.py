"""The graph transformer's structural bias kernels
(``csrc/structural_bias.cu``) and their plain version
(``ops/structural_bias.py``).

On the CPU: the plain version of the forward kernel against the explicit
path (``models/layers.py::StructuralBias`` on the CPU) bit for bit, and of
the backward kernel (the output's gradient summed by table row) against
autograd through the explicit path, for molecules padded to n of 33, 80,
81 and 128, a batch of 1, unreachable and padded pairs, distances past the
5 hops and past n, and a distance table of 8 rows, so that the clamp to
its row S - 2 engages; a ``gradcheck`` of the kernel path's
``autograd.Function`` in f64; the support check's limits; the kernel
wrappers returning the plain version on CPU tensors; and the path
counters.

On the card (marked ``card``; they skip without CUDA): the forward kernel
against the explicit path bit for bit at the training cell's shape (B =
1024, H = 32, n = 80) and at small ragged ones, the backward within f32
rounding of an f64 sum and the same bits on a second run, and a
Graphormer training step whose bias goes through the kernels.  This file
imports no JAX, so on the card it runs without the suite's
``conftest.py``::

    python3 -m pytest --noconftest -q tests/test_torch_structural_bias.py
"""

import os
import sys
import types

import pytest
import torch

from mgat_graphsage_torch.models import layers
from mgat_graphsage_torch.models.layers import StructuralBias
from mgat_graphsage_torch.ops import structural_bias as sb
from mgat_graphsage_torch.utils import telemetry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _structure(b, n, hops=5, maxd=None, seed=0, device="cpu"):
    """int8 ``spd [b, n, n]`` and ``path_types [b, n, n, hops]``: molecules
    of 1 to n atoms (the first n), padded with -1; inside a molecule
    distances 0 (the diagonal) to ``maxd`` (n - 1 by default), 5% of the
    pairs unreachable (-1, as a salt's), and bond types 1-4 on the first
    ``min(d, hops)`` hops of a path, 0 after."""
    g = torch.Generator().manual_seed(seed)
    maxd = n - 1 if maxd is None else maxd
    sizes = torch.randint(1, n + 1, (b,), generator=g)
    sizes[0] = n
    d = torch.randint(0, maxd + 1, (b, n, n), generator=g)
    d = torch.where(torch.rand(b, n, n, generator=g) < 0.05, -1, d)
    d[:, torch.arange(n), torch.arange(n)] = 0
    inside = torch.arange(n)[None, :] < sizes[:, None]
    d = torch.where(inside[:, :, None] & inside[:, None, :], d, -1)
    t = torch.randint(1, 5, (b, n, n, hops), generator=g)
    t = torch.where(torch.arange(hops) < d.clamp_min(0)[..., None], t, 0)
    return d.to(torch.int8).to(device), t.to(torch.int8).to(device)


def _tables(module):
    """The module's f32 tables as the kernels take them: ``spatial``,
    ``virtual`` and the ``[hops, 5, H]`` edge table, detached leaves."""
    h = module.heads
    emb = torch.cat([module.spatial.weight.new_zeros(1, h),
                     module.edge_type.weight.float()])
    table = torch.einsum("th,mhk->mtk", emb, module.edge_hop.weight.float())
    return [t.detach().clone().requires_grad_(True) for t in (
        module.spatial.weight.float(), module.virtual_distance.weight.float(),
        table)]


# b, n, heads, num_spatial, largest distance
CASES = [pytest.param(2, 33, 4, 512, None, id="n33"),
         pytest.param(2, 80, 32, 512, None, id="n80-h32"),
         pytest.param(3, 81, 32, 512, None, id="n81-h32"),
         pytest.param(1, 128, 8, 512, None, id="n128-batch-of-1"),
         pytest.param(2, 40, 4, 8, None, id="spatial-rows-8-clamped"),
         pytest.param(2, 20, 4, 512, 100, id="distances-past-n")]


@pytest.mark.parametrize("b,n,h,s,maxd", CASES)
def test_plain_forward_is_the_explicit_path_bit_for_bit(b, n, h, s, maxd):
    """The forward kernel's algorithm (per pair: its distance row, its hop
    terms added in order, divided by the hop count) gives the explicit
    ``StructuralBias`` forward's f32 values to the bit."""
    spd, types = _structure(b, n, maxd=maxd)
    module = StructuralBias(h, num_spatial=s)
    want = module(spd, types)
    got = sb.structural_bias_fwd_plain(spd, types, *_tables(module))
    assert want.shape == (b, h, n + 1, n + 1) and want.dtype == torch.float32
    assert torch.equal(got, want)


@pytest.mark.parametrize("b,n,h,s,maxd", CASES)
def test_plain_backward_matches_autograd_through_the_explicit_path(
        b, n, h, s, maxd):
    """The backward kernel's algorithm (the output's gradient summed by
    table row) against autograd through the explicit path, in f32: each
    table's gradient within 1e-5 of its norm (the two sum the same f32
    terms, up to ~13K a row here, in other orders: each within ~1e-6 of an
    f64 sum).  The type-0 rows, the padding type's constant zero, get no
    gradient on the kernel path; autograd's sums for them go nowhere in the
    module (``test_module_gradients_match_through_both_paths``)."""
    spd, types = _structure(b, n, maxd=maxd, seed=1)
    spatial, virtual, table = _tables(StructuralBias(h, num_spatial=s))
    g = torch.randn(b, h, n + 1, n + 1,
                    generator=torch.Generator().manual_seed(2))
    sb.structural_bias_explicit(spd, types, spatial, virtual,
                                table).backward(g)
    d_spatial, d_virtual, d_table = sb.structural_bias_bwd_plain(
        g, spd, types, s)
    assert d_spatial.shape == (s, h) and d_virtual.shape == (1, h)
    assert d_table.shape == (5, 5, h)
    assert _rel(d_spatial, spatial.grad) <= 1e-5
    assert _rel(d_virtual, virtual.grad) <= 1e-5
    assert _rel(d_table[:, 1:], table.grad[:, 1:]) <= 1e-5
    assert (d_table[:, 0] == 0).all()


def test_module_gradients_match_through_both_paths(monkeypatch):
    """``StructuralBias`` in training with its bias through the kernel
    path's ``autograd.Function`` (on the CPU, the plain version of both
    kernels) gives every table's gradient, ``edge_type`` and ``edge_hop``
    through the torch product that forms the edge table, within 1e-5 of
    the explicit path's (other f32 summation orders)."""
    spd, types = _structure(3, 30, seed=3)
    module = StructuralBias(8, num_spatial=16)
    g = torch.randn(3, 8, 31, 31, generator=torch.Generator().manual_seed(4))
    grads = []
    for kernel in (False, True):
        if kernel:
            monkeypatch.setattr(layers, "structural_bias",
                                sb.StructuralBiasKernel.apply)
        module.zero_grad()
        module(spd, types).backward(g)
        grads.append({k: p.grad.clone()
                      for k, p in module.named_parameters()})
    assert set(grads[0]) == {"spatial.weight", "virtual_distance.weight",
                             "edge_type.weight", "edge_hop.weight"}
    for k in grads[0]:
        assert _rel(grads[1][k], grads[0][k]) <= 1e-5, k


def test_kernel_path_gradcheck_f64():
    """The kernel path's ``autograd.Function`` (the plain version on the
    CPU) against finite differences in f64, with unreachable, padded and
    clamped distances; the edge table's type-0 rows are the constant zero
    the module gives them."""
    spd, types = _structure(2, 7, maxd=9, seed=5)
    g = torch.Generator().manual_seed(6)
    leaves = [torch.randn(*shape, generator=g, dtype=torch.float64,
                          requires_grad=True)
              for shape in ((6, 3), (1, 3), (5, 4, 3))]

    def bias(spatial, virtual, bonds):
        table = torch.cat([bonds.new_zeros(5, 1, 3), bonds], dim=1)
        return sb.StructuralBiasKernel.apply(spd, types, spatial, virtual,
                                             table)

    assert torch.autograd.gradcheck(bias, leaves)


def _support_args(n=80, hops=5, h=32, s=512, dt=torch.int8,
                  ft=torch.float32, rows=5):
    spd = torch.zeros(2, n, n, dtype=dt)
    types = torch.zeros(2, n, n, hops, dtype=dt)
    return spd, types, torch.zeros(s, h, dtype=ft), torch.zeros(
        hops, rows, h, dtype=ft)


@pytest.mark.parametrize("kw,ok", [
    ({}, True), ({"n": 1}, True), ({"n": 128}, True), ({"hops": 1}, True),
    ({"h": 1}, True), ({"s": 2}, True),
    ({"n": 129}, False), ({"h": 33}, False), ({"hops": 6}, False),
    ({"s": 1}, False), ({"dt": torch.int64}, False),
    ({"ft": torch.float64}, False), ({"rows": 4}, False)],
    ids=lambda v: str(v))
def test_kernels_support_limits(kw, ok):
    """The kernels take int8 structure at n <= 128, hops <= 5, at most 32
    heads, a distance table of at least 2 rows and f32 tables with 5
    bond-type rows; the explicit path takes the rest (and every CPU
    tensor)."""
    assert sb.kernels_support(*_support_args(**kw)) is ok


def test_cpu_wrappers_return_the_plain_version():
    """The kernel wrappers on CPU tensors are the plain version, and
    launch nothing."""
    spd, types = _structure(2, 9, seed=7)
    tables = _tables(StructuralBias(4, num_spatial=12))
    launches = (sb.structural_bias_cuda.launches,
                sb.structural_bias_bwd_cuda.launches)
    out = sb.structural_bias_cuda(spd, types, *tables)
    assert torch.equal(out, sb.structural_bias_fwd_plain(spd, types,
                                                         *tables))
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(8))
    for got, want in zip(sb.structural_bias_bwd_cuda(g, spd, types, 12),
                         sb.structural_bias_bwd_plain(g, spd, types, 12)):
        assert torch.equal(got, want)
    assert launches == (sb.structural_bias_cuda.launches,
                        sb.structural_bias_bwd_cuda.launches)


@pytest.mark.parametrize("grad", [False, True])
def test_cpu_builds_count_on_the_explicit_path(grad):
    """On the CPU a call the kernels take still runs the explicit path:
    ``/health``'s ``structural_bias`` counts it under ``explicit``, the
    ``kernel`` count and the wrappers' launches do not move, and the
    backward opens no ``graphormer.bias_grad`` span."""
    spd, types = _structure(2, 9, seed=9)
    module = StructuralBias(4)
    before = telemetry.snapshot()
    with torch.set_grad_enabled(grad):
        out = module(spd, types)
    if grad:
        out.sum().backward()
    after = telemetry.snapshot()
    was, now = before["structural_bias"], after["structural_bias"]
    assert {p: now[p] - was[p] for p in now} == {"explicit": 1, "kernel": 0}
    for name in ("structural_bias_cuda", "structural_bias_bwd_cuda"):
        assert after["launches"][name] == before["launches"][name]
    assert "graphormer.bias_grad" not in after["device_spans"]


def test_benchmark_reads_the_backward_span(monkeypatch):
    """``graphormer.bias_grad_share.train`` (``portbench/metrics/``) sums
    the ``graphormer.bias_grad`` device span over the training epochs that
    closed after the newest profiled one, over the window (the validation
    pass has no backward); it reads nothing where their number is not the
    window's epochs, or where the epochs hold no such span (a program
    whose bias backward is autograd's)."""
    sys.path.insert(0, REPO)
    from portbench.harness.spec import Spec

    read = Spec(REPO).reader("graphormer.bias_grad_share.train")
    r = types.SimpleNamespace(counters={"window_s": 2.0, "epochs": 2})
    for spans, want in (({"graphormer.bias_grad": 0.02,
                          "graphormer.bias": 0.01}, 100.0 * 0.04 / 2.0),
                        ({"graphormer.bias": 0.01}, None)):
        reg = telemetry.Registry()
        monkeypatch.setattr(telemetry, "unprofiled_tail", reg.unprofiled_tail)
        for profiled in (True, False, False):
            for kind in ("train_epoch", "evaluate"):
                with reg.unit(kind) as rec:
                    rec.profiled = profiled
                    rec.device.update(spans if kind == "train_epoch"
                                      else {"graphormer.bias": 0.005})
        assert read(r) == (want if want is None else pytest.approx(want))
        assert read(types.SimpleNamespace(
            counters={"window_s": 2.0, "epochs": 3})) is None


# ---- on the card ------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# b, n, heads, num_spatial, largest distance
CARD = [pytest.param(1024, 80, 32, 512, 30, id="cell-b1024-n80-h32"),
        pytest.param(3, 21, 5, 512, None, id="n21-h5-ragged"),
        pytest.param(1, 128, 32, 512, None, id="n128-batch-of-1"),
        pytest.param(2, 40, 4, 8, None, id="spatial-rows-8-clamped"),
        pytest.param(2, 20, 7, 512, 100, id="distances-past-n")]


@pytest.mark.card
@pytest.mark.parametrize("b,n,h,s,maxd", CARD)
def test_kernels_on_the_card(cuda, b, n, h, s, maxd):
    """The forward kernel gives the explicit path's bits on the card; the
    backward is within 1e-5 of each table's norm of the f64 sums (f32 sums
    of up to ~5,000 terms a warp, then a block's 4 warps and ~260 blocks'
    partials, against an exact f64 sum), and a second run gives the same
    bits (no atomics where every distance is below n)."""
    spd, types = _structure(b, n, maxd=maxd, seed=n, device=cuda)
    tables = [t.detach().to(cuda)
              for t in _tables(StructuralBias(h, num_spatial=s))]
    out = sb.structural_bias_cuda(spd, types, *tables)
    want = sb.structural_bias_explicit(spd, types, *tables)
    g = torch.randn(out.shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(1))
    runs = [sb.structural_bias_bwd_cuda(g, spd, types, s) for _ in range(2)]
    exact = sb.structural_bias_bwd_plain(g.double(), spd, types, s)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    for name, got, w in zip(("spatial", "virtual", "table"), runs[0],
                            exact):
        assert got.dtype == torch.float32 and got.shape == w.shape, name
        assert _rel(got, w) <= 1e-5, name
    assert (runs[0][2][:, 0] == 0).all()
    if maxd is None or maxd < n:
        for a, c in zip(*runs):
            assert torch.equal(a, c)


@pytest.mark.card
def test_graphormer_training_builds_the_bias_with_the_kernels(cuda):
    """A bf16 ``GraphormerNet`` training step on the card builds its bias
    with one forward and one backward kernel launch, counted under
    ``kernel`` with no explicit build, inside a ``graphormer.bias_grad``
    span; its evaluation is one forward launch."""
    from mgat_graphsage_torch.models.zoo import GraphormerNet

    model = GraphormerNet(dim=96, layers=2, heads=4, ffn_dim=96).to(
        cuda, torch.bfloat16).train()
    spd, types = _structure(8, 17, seed=11, device=cuda)
    nodes = torch.randn(8, 17, 35, device=cuda, dtype=torch.bfloat16)
    node_mask = (spd[:, 0] >= 0).to(torch.bfloat16)
    degree = torch.randint(0, 4, (8, 17), dtype=torch.int8, device=cuda)
    before = sb.counts()
    fwd, bwd = (sb.structural_bias_cuda.launches,
                sb.structural_bias_bwd_cuda.launches)
    with telemetry.unit("train_epoch") as rec:
        out = model(nodes, node_mask, degree, spd, types,
                    torch.Generator(cuda).manual_seed(0))
        out.float().square().sum().backward()
        torch.cuda.synchronize()
    model.eval()
    with torch.no_grad():
        model(nodes, node_mask, degree, spd, types)
    torch.cuda.synchronize()
    after = sb.counts()
    assert {p: after[p] - before[p] for p in after} == {
        "explicit": 0, "kernel": 2}
    assert sb.structural_bias_cuda.launches - fwd == 2
    assert sb.structural_bias_bwd_cuda.launches - bwd == 1
    assert rec.device["graphormer.bias_grad"] > 0
    assert model.bias.spatial.weight.grad.abs().sum() > 0
    assert torch.isfinite(model.bias.edge_hop.weight.grad).all()
