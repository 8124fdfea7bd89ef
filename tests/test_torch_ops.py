"""The port's graph ops, the plain versions of its adjacency and attention
kernels (forward and backward) and the attention ``autograd.Function``
against the reference package's JAX functions, on the CPU.

The Pallas kernels run in interpret mode, as in tests/test_pallas.py.  The
CUDA kernels themselves are held against these plain versions on the card
by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mgat_graphsage_tpu.ops import graph as jgraph
from mgat_graphsage_tpu.ops.pallas_adjacency import dense_adjacency_pallas
from mgat_graphsage_tpu.ops.pallas_attention import fused_masked_attention

from mgat_graphsage_torch.ops import (
    attention_bwd_cuda,
    attention_bwd_plain,
    attention_plain,
    dense_adjacency,
    dense_adjacency_cuda,
    dense_adjacency_plain,
    fused_masked_attention_cuda,
    masked_softmax,
    segment_max_pool,
    segment_mean_pool,
    segment_sum_pool,
)
from mgat_graphsage_torch.ops import fused_masked_attention as torch_fused
from mgat_graphsage_torch.ops.attention import kernels_support


def _edges(b=8, n=16, e=40, seed=0, frac=False):
    """Padded COO batch with duplicate edges, masked padding pointing at
    node 0, and an all-masked molecule (row 2)."""
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, size=(b, 2, e)).astype(np.int32)
    mask = np.zeros((b, e), np.float32)
    for i in range(b):
        k = int(rng.integers(1, e + 1))
        mask[i, :k] = rng.uniform(0.1, 0.9, k) if frac else 1.0
        edges[i, :, k:] = 0
        edges[i, :, 1] = edges[i, :, 0]      # a duplicate edge
    mask[2] = 0.0
    return edges, mask


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adjacency_plain_bitwise_vs_jax(seed):
    """0/1 masks: sums of small integers are exact, so bitwise."""
    edges, mask = _edges(seed=seed)
    ours = dense_adjacency_plain(torch.from_numpy(edges),
                                 torch.from_numpy(mask), 16).numpy()
    scatter = np.asarray(jgraph.dense_adjacency(
        jnp.asarray(edges), jnp.asarray(mask), 16, use_pallas=False))
    pallas = np.asarray(dense_adjacency_pallas(
        jnp.asarray(edges), jnp.asarray(mask), 16, interpret=True))
    np.testing.assert_array_equal(ours, scatter)
    np.testing.assert_array_equal(ours, pallas)
    assert ours[2].sum() == 0.0
    assert ours.max() == 1.0


def test_adjacency_plain_fractional_masks():
    """Fractional masks: the duplicate edge's two adds may round in
    another order than XLA's scatter, so compare to 1 ulp (f32 eps)."""
    edges, mask = _edges(seed=5, frac=True)
    ours = dense_adjacency_plain(torch.from_numpy(edges),
                                 torch.from_numpy(mask), 16).numpy()
    ref = np.asarray(jgraph.dense_adjacency(
        jnp.asarray(edges), jnp.asarray(mask), 16, use_pallas=False))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1.2e-7)


def test_adjacency_wrapper_on_cpu_is_plain_and_counts_nothing():
    edges, mask = _edges(b=5, seed=3)          # B not a multiple of 8
    before = dense_adjacency_cuda.launches
    et, mt = torch.from_numpy(edges), torch.from_numpy(mask)
    out = dense_adjacency(et, mt, 16)
    np.testing.assert_array_equal(out.numpy(),
                                  dense_adjacency_plain(et, mt, 16).numpy())
    assert dense_adjacency_cuda.launches == before


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    """Only a CPU tensor takes the plain version; anything else must reach
    the kernel's checks (here: a meta tensor is refused, not computed)."""
    e = torch.zeros((8, 2, 4), dtype=torch.int32, device="meta")
    m = torch.zeros((8, 4), device="meta")
    with pytest.raises(ValueError):
        dense_adjacency_cuda(e, m, 16)
    q = torch.zeros((2, 8, 4), device="meta")
    with pytest.raises(ValueError):
        fused_masked_attention_cuda(q, q, q, torch.zeros((2, 8), device="meta"))


def _attn_inputs(b, n, f, seed, fully_masked=True):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, n, f)).astype(np.float32)
               for _ in range(3))
    mask = np.zeros((b, n), np.float32)
    for i in range(b):
        mask[i, :int(rng.integers(3, n + 1))] = 1.0
    if fully_masked:
        mask[-1] = 0.0
    return q, k, v, mask


@pytest.mark.parametrize("shape", [(4, 16, 35), (2, 128, 128)])
@pytest.mark.parametrize("residual", [True, False])
def test_attention_plain_vs_pallas_interpret(shape, residual):
    """Whole tensor, padded query rows included; f32 tolerance for the
    different summation order of the two products."""
    q, k, v, mask = _attn_inputs(*shape, seed=sum(shape))
    ours = attention_plain(*(torch.from_numpy(a) for a in (q, k, v, mask)),
                           residual=residual).numpy()
    ref = np.asarray(fused_masked_attention(
        *(jnp.asarray(a) for a in (q, k, v, mask)), residual, True))
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)
    # the fully-masked molecule gives attn = 0: out is v or 0, not NaN
    np.testing.assert_array_equal(ours[-1], v[-1] if residual else 0 * v[-1])
    wrapped = fused_masked_attention_cuda(
        *(torch.from_numpy(a) for a in (q, k, v, mask)), residual).numpy()
    np.testing.assert_array_equal(wrapped, ours)


@pytest.mark.parametrize("mask_kind", ["ragged", "empty_rows"])
def test_masked_softmax_matches_jax(mask_kind):
    rng = np.random.default_rng(11)
    s = rng.standard_normal((3, 7, 9)).astype(np.float32) * 4
    m = (rng.uniform(size=(3, 7, 9)) > 0.4).astype(np.float32)
    if mask_kind == "empty_rows":
        m[:, 2] = 0.0
    ours = masked_softmax(torch.from_numpy(s), torch.from_numpy(m)).numpy()
    ref = np.asarray(jgraph.masked_softmax(jnp.asarray(s), jnp.asarray(m)))
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=1e-6)
    assert np.isfinite(ours).all()


@pytest.mark.parametrize("pool", ["max", "mean", "sum"])
def test_pools_match_jax(pool):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 11, 6)).astype(np.float32)
    m = np.zeros((5, 11), np.float32)
    for i, k in enumerate((11, 3, 0, 7, 1)):
        m[i, :k] = 1.0
    ours = {"max": segment_max_pool, "mean": segment_mean_pool,
            "sum": segment_sum_pool}[pool](torch.from_numpy(x),
                                           torch.from_numpy(m)).numpy()
    ref = np.asarray(getattr(jgraph, f"segment_{pool}_pool")(
        jnp.asarray(x), jnp.asarray(m)))
    # max is exact; mean/sum are f32 sums over <= 11 terms
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=1e-6)


# ---- attention backward (kernel 3's plain version and the Function) ------

@pytest.mark.parametrize("shape", [(4, 16, 35), (3, 24, 8), (2, 128, 35)])
@pytest.mark.parametrize("residual", [True, False])
def test_attention_bwd_plain_vs_pallas_vjp(shape, residual):
    """Mixed padding and a fully-masked molecule: the explicit formula
    against ``jax.vjp`` of the Pallas kernel in interpret mode and against
    torch autograd through the plain forward; f32 tolerance (sums of
    N * F terms in another order)."""
    import jax

    q, k, v, mask = _attn_inputs(*shape, seed=7 + sum(shape))
    g = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    tq, tk, tv, tm, tg = (torch.from_numpy(a) for a in (q, k, v, mask, g))
    ours = attention_bwd_plain(tq, tk, tv, tm, tg, residual)
    _, vjp = jax.vjp(lambda a, b, c: fused_masked_attention(
        a, b, c, jnp.asarray(mask), residual, True),
        *(jnp.asarray(a) for a in (q, k, v)))
    ref = vjp(jnp.asarray(g))
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    attention_plain(*leaves, tm, residual).backward(tg)
    for o, r, leaf in zip(ours, ref, leaves):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=2e-5,
                                   rtol=2e-5)
        np.testing.assert_allclose(o.numpy(), leaf.grad.numpy(), atol=2e-5,
                                   rtol=2e-5)
    # the fully-masked molecule: no gradient through attention, no NaN
    assert np.isfinite(np.concatenate([o.numpy().ravel() for o in ours])).all()
    np.testing.assert_array_equal(ours[0][-1].numpy(), 0.0)
    np.testing.assert_array_equal(ours[1][-1].numpy(), 0.0)


def test_fused_attention_function_on_cpu_uses_plain_versions():
    """The autograd.Function: plain forward and plain backward on the CPU,
    no gradient for the mask, no launch counted."""
    q, k, v, mask = _attn_inputs(3, 12, 6, seed=2)
    g = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)
    tq, tk, tv, tm, tg = (torch.from_numpy(a) for a in (q, k, v, mask, g))
    before = (fused_masked_attention_cuda.launches,
              attention_bwd_cuda.launches)
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    tm = tm.clone().requires_grad_(True)
    out = torch_fused(*leaves, tm, True)
    np.testing.assert_array_equal(
        out.detach().numpy(), attention_plain(tq, tk, tv, tm.detach()).numpy())
    out.backward(tg)
    for leaf, want in zip(leaves, attention_bwd_plain(tq, tk, tv,
                                                      tm.detach(), tg)):
        np.testing.assert_array_equal(leaf.grad.numpy(), want.numpy())
    assert tm.grad is None
    assert (fused_masked_attention_cuda.launches,
            attention_bwd_cuda.launches) == before


def test_attention_gate_by_shape():
    """N <= 128 and F <= 128 within the backward's shared memory: the
    backward's layout (row stride F rounded up to 4, attn and dscores
    [N4][N8]) keeps the limits N <= 128 at F = 35 and N <= 84 at F = 128."""
    assert kernels_support(80, 35) and kernels_support(128, 35)
    assert kernels_support(84, 128) and not kernels_support(85, 128)
    assert not kernels_support(129, 35) and not kernels_support(160, 35)
    assert not kernels_support(16, 129)


@pytest.mark.parametrize("n,routed", [(16, True), (136, False)])
def test_gat_layer_routes_by_the_gate(monkeypatch, n, routed):
    """ModifiedGATLayer asks the gate with the shapes before any launch:
    through the kernels' Function up to the limit, the plain path past it
    (the reference layer does the same past its kernel's N = 512)."""
    from mgat_graphsage_torch.models import layers

    calls = []

    def spy(*a):
        calls.append(a[0].shape)
        return torch_fused(*a)

    monkeypatch.setattr(layers, "fused_masked_attention", spy)
    layer = layers.ModifiedGATLayer(35, 35)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, n, 35)).astype(np.float32))
    m = torch.ones(2, n)
    m[1, n // 2:] = 0.0
    out = layer(x, m)
    assert out.shape == (2, n, 35) and torch.isfinite(out).all()
    assert bool(calls) == routed


def test_adjacency_routes_past_its_limit_without_a_launch(monkeypatch):
    """The kernel has no N limit any more: past the old one (238) the
    adjacency still goes through the kernel's wrapper, which on the CPU
    returns the plain scatter version and launches nothing."""
    from mgat_graphsage_torch.ops import graph

    calls = []

    def spy(*a):
        calls.append(a[2])
        return dense_adjacency_cuda(*a)

    monkeypatch.setattr(graph, "dense_adjacency_cuda", spy)
    edges, mask = _edges(b=3, n=16, seed=4)
    before = dense_adjacency_cuda.launches
    out = graph.dense_adjacency(torch.from_numpy(edges),
                                torch.from_numpy(mask), 240)
    assert out.shape == (3, 240, 240)
    np.testing.assert_array_equal(out[:, :16, :16].numpy(),
                                  dense_adjacency_plain(
                                      torch.from_numpy(edges),
                                      torch.from_numpy(mask), 16).numpy())
    assert out[:, 16:].sum() == 0 and out[:, :, 16:].sum() == 0
    graph.dense_adjacency(torch.from_numpy(edges), torch.from_numpy(mask), 16)
    assert calls == [240, 16]
    assert dense_adjacency_cuda.launches == before


def _ascending_sum(edges, mask, n):
    """numpy: each cell's masks added one at a time in ascending edge
    order, in f32, then clamped to 1; out-of-range edges dropped."""
    b, _, e = edges.shape
    adj = np.zeros((b, n, n), np.float32)
    for i in range(b):
        for j in range(e):
            s, d = edges[i, 0, j], edges[i, 1, j]
            if 0 <= s < n and 0 <= d < n:
                adj[i, d, s] = np.float32(adj[i, d, s] + mask[i, j])
    return np.minimum(adj, np.float32(1.0))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("b", [1, 5])
def test_adjacency_plain_sums_in_ascending_edge_order(seed, b):
    """Fractional masks with many duplicates per cell (N = 6, E = 128) and
    out-of-range indices: the plain version equals the ascending-order
    sum bit for bit, the order the CUDA kernel sums in."""
    rng = np.random.default_rng(100 + seed)
    n, e = 6, 128
    edges = rng.integers(-1, n + 1, size=(b, 2, e)).astype(np.int32)
    mask = rng.uniform(0.001, 0.2, size=(b, e)).astype(np.float32)
    want = _ascending_sum(edges, mask, n)
    got = dense_adjacency_plain(torch.from_numpy(edges),
                                torch.from_numpy(mask), n).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    rev = _ascending_sum(edges[:, :, ::-1], mask[:, ::-1], n)
    assert (rev != want).any()     # the case tells the orders apart


def test_adjacency_at_n300_on_cpu_is_plain_with_no_limit():
    """N = 300, past the old shared-memory limit: ``dense_adjacency`` on
    the CPU returns the plain version and counts no launch, and neither
    ``ops.graph`` nor ``ops.adjacency`` keeps an N limit."""
    from mgat_graphsage_torch.ops import adjacency, graph

    edges, mask = _edges(b=3, n=300, e=700, seed=6, frac=True)
    et, mt = torch.from_numpy(edges), torch.from_numpy(mask)
    before = dense_adjacency_cuda.launches
    out = dense_adjacency(et, mt, 300)
    assert out.shape == (3, 300, 300)
    np.testing.assert_array_equal(out.numpy(),
                                  dense_adjacency_plain(et, mt, 300).numpy())
    assert dense_adjacency_cuda.launches == before
    assert not hasattr(graph, "MAX_NODES")
    assert not hasattr(adjacency, "MAX_NODES")


def test_ptxas_report_names_each_kernel_and_its_registers():
    """The build keeps nvcc's ptxas output; the report names each kernel
    (a template's integer argument included) with its registers and
    spills, and is empty for a source this process did not build."""
    from mgat_graphsage_torch.ops import _build

    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__3333f5"
        "28_16_attention_bwd_cu_02f4085027masked_attention_bwd_kernelILi5EE"
        "EvPKfS2_S2_S2_S2_PfS3_S3_iiifi' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 118 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__0fc71fc8"
        "_10_cnn_dy3_cu_6d91793d14cnn_dy3_kernelEPKfS1_S1_Pfiiiii' for "
        "'sm_90a'",
        "    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 255 registers, used 1 barriers"])
    try:
        _build.BUILD_LOGS["probe"] = log
        assert _build.ptxas_report("probe") == [
            "masked_attention_bwd_kernel<5>: 118 registers, 0 bytes spilled",
            "cnn_dy3_kernel: 255 registers, 8 bytes spilled"]
    finally:
        del _build.BUILD_LOGS["probe"]
    assert _build.ptxas_report("probe") == []
