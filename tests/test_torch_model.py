"""The port's layers and hybrid model against the reference package's flax
modules, on the CPU, with weights carried over by ``params_from_jax``.

Inputs come from a numpy seed; weights from a JAX ``init``.  Tolerance:
f32, for the different summation order of the products (largest sum: the
CNN fc1 at 64 * 128 = 8192 terms).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mgat_graphsage_tpu.models import layers as jlayers
from mgat_graphsage_tpu.models import zoo as jzoo
from mgat_graphsage_tpu.ops.graph import dense_adjacency as jdense

from mgat_graphsage_torch.models import (
    HybridModel,
    cnn_fc1_pos_major_to_torch,
    cnn_fc1_torch_to_pos_major,
    kl_loss,
    params_from_jax,
    params_to_jax,
)

TOL = dict(atol=2e-5, rtol=2e-5)


def _batch(b=4, n=12, f=35, e=24, fp_dim=64, seed=0):
    rng = np.random.default_rng(seed)
    nodes = (rng.uniform(size=(b, n, f)) > 0.7).astype(np.float32)
    node_mask = np.zeros((b, n), np.float32)
    edges = np.zeros((b, 2, e), np.int32)
    edge_mask = np.zeros((b, e), np.float32)
    for i in range(b):
        k = int(rng.integers(3, n + 1))
        node_mask[i, :k] = 1.0
        nodes[i, k:] = 0.0
        ne = int(rng.integers(1, e + 1))
        edges[i, :, :ne] = rng.integers(0, k, size=(2, ne))
        edge_mask[i, :ne] = 1.0
    fp = (rng.uniform(size=(b, fp_dim)) > 0.8).astype(np.float32)
    return nodes, edges, node_mask, edge_mask, fp


def _pair(**kw):
    """(flax module, numpy params, port module with those params)."""
    jm = jzoo.HybridModel(fp_dim=64, cnn_fc_hidden=16, combined_hidden=32,
                          **kw)
    nodes, edges, nm, em, fp = _batch()
    adj = jdense(jnp.asarray(edges), jnp.asarray(em), nodes.shape[1])
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), nodes, adj, nm,
                                    fp)["params"])
    tm = HybridModel(fp_dim=64, cnn_fc_hidden=16, combined_hidden=32, **kw)
    tm.load_state_dict(params_from_jax(params), strict=True)
    return jm, params, tm.eval()


@pytest.mark.parametrize("kw", [
    {},                                          # flagship
    {"residual": False},
    {"dual_pool": True},
    {"flat_attention": True},
], ids=["flagship", "no_residual", "dual_pool", "flat"])
def test_hybrid_forward_and_kl_match_flax(kw):
    jm, params, tm = _pair(**kw)
    for seed in (1, 2):
        nodes, edges, nm, em, fp = _batch(seed=seed)
        adj = jdense(jnp.asarray(edges), jnp.asarray(em), nodes.shape[1])
        jpred, jlat = jm.apply({"params": params}, nodes, adj, nm, fp)
        with torch.no_grad():
            tpred, tlat = tm(torch.from_numpy(nodes),
                             torch.from_numpy(np.array(adj)),
                             torch.from_numpy(nm), torch.from_numpy(fp))
        np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred), **TOL)
        np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), **TOL)
        smask = np.array([1, 1, 1, 0], np.float32)
        for sm in (None, smask):
            jk = jzoo.kl_loss(jlat, None if sm is None else jnp.asarray(sm))
            tk = kl_loss(tlat, None if sm is None else torch.from_numpy(sm))
            np.testing.assert_allclose(tk.item(), float(jk), rtol=1e-4,
                                       atol=1e-4)


@pytest.mark.parametrize("residual", [False, True], ids=["model2", "model3"])
def test_graph_branch_alone_matches_flax(residual):
    """The ``gat_graphsage`` model of the model2/model3 presets (dual pool,
    no fingerprint branch), through ``build_model`` as the predictor
    builds it."""
    from mgat_graphsage_tpu.train.config import get_config as jget_config
    from mgat_graphsage_tpu.train.trainer import build_model as jbuild
    from mgat_graphsage_torch.models import build_model
    from mgat_graphsage_torch.train import get_config

    preset = "model3" if residual else "model2"
    jm = jbuild(jget_config(preset))
    nodes, edges, nm, em, _ = _batch(seed=3)
    adj = jdense(jnp.asarray(edges), jnp.asarray(em), nodes.shape[1])
    params = jax.device_get(jm.init(jax.random.PRNGKey(1), nodes, adj,
                                    nm)["params"])
    tm = build_model(get_config(preset)).eval()
    tm.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        ours = tm(torch.from_numpy(nodes), torch.from_numpy(np.array(adj)),
                  torch.from_numpy(nm)).numpy()
    ref = np.asarray(jm.apply({"params": params}, nodes, adj, nm))
    np.testing.assert_allclose(ours, ref, **TOL)


def test_params_round_trip_is_exact():
    _, params, tm = _pair()
    back = params_to_jax(tm)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        b = flat_b[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b)


def test_fc1_permutation_helpers_match_reference():
    rng = np.random.default_rng(0)
    k = rng.standard_normal((8 * 128, 5)).astype(np.float32)
    for ours, ref in ((cnn_fc1_torch_to_pos_major,
                       jlayers.cnn_fc1_torch_to_pos_major),
                      (cnn_fc1_pos_major_to_torch,
                       jlayers.cnn_fc1_pos_major_to_torch)):
        np.testing.assert_array_equal(ours(k), np.asarray(ref(k)))
        np.testing.assert_array_equal(ours(torch.from_numpy(k)).numpy(),
                                      np.asarray(ref(k)))


def test_gat10_is_ported_and_matches_flax():
    """``attention="gat10"`` (a 10-head GATConv, the model1 ablation's
    graph layer) builds, and the hybrid around it matches the flax model
    forward, latent included."""
    jm, params, tm = _pair(attention="gat10")
    assert tm.gat_graphsage.conv1.att_src.shape == (1, 10, 35)
    for seed in (1, 2):
        nodes, edges, nm, em, fp = _batch(seed=seed)
        adj = jdense(jnp.asarray(edges), jnp.asarray(em), nodes.shape[1])
        jpred, jlat = jm.apply({"params": params}, nodes, adj, nm, fp)
        with torch.no_grad():
            tpred, tlat = tm(torch.from_numpy(nodes),
                             torch.from_numpy(np.array(adj)),
                             torch.from_numpy(nm), torch.from_numpy(fp))
        np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred), **TOL)
        np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), **TOL)
