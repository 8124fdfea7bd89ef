"""The port's graph ops and the plain versions of its two kernels against
the reference package's JAX functions, on the CPU.

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
