"""The port's multi-GPU path (``parallel/``, ``Trainer(mesh=...)``) on the
CPU: gloo process groups of 2 and 4 ranks (``tests/torch_mesh_worker.py``)
against the port's 1-process run and against the JAX package's mesh run.

The reference holds its mesh to its single-device run: losses and
``val_mse`` within rel 1e-4 / abs 1e-5 (``tests/test_mesh_parity.py``),
both processes' losses within rel 1e-6 (``tests/test_distributed.py``).
The port is held to the same, predictions within 1e-4.  Data: the
reference's 16 SMILES, batch 8.  The ranks run while this process
computes the 1-process runs; PyTorch runs on one thread everywhere.
"""

import contextlib
import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from mgat_graphsage_torch.data import MolecularDataset
from mgat_graphsage_torch.models import (
    TorchLinear,
    build_model,
    params_from_jax,
)
from mgat_graphsage_torch.parallel import (
    Mesh,
    all_reduce_sum,
    copy_to_group,
    gather_columns,
    host_row_slice,
    make_mesh,
    param_shardings,
    shard_batch,
    shard_state,
)
from mgat_graphsage_torch.train import (
    PRESETS,
    Trainer,
    get_config,
    save_checkpoint,
)
from mgat_graphsage_torch.train.optim import hash_noise16, sr_to_bf16

import torch_mesh_worker as worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# "jax_model" turns dropout off for the rest of the ranks' run
TWO_RANKS = ["collectives", "graphsage_data", "gin_data", "gin_grad",
             "flagship_model",
             "flagship_data_pallas", "flagship_no_kl_share",
             "factored_model", "gat_gcn_model", "model1_model",
             "morgan2048_model", "ecfp2048_grad", "ecfp2048_save",
             "jax_model", "jax_grad", "jax_gat_gcn_grad", "cli"]
TIMEOUT = 420


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


class _Ranks:
    """``world`` worker processes running ``scenarios`` in turn."""

    def __init__(self, world, scenarios, out):
        self.out, self.world = str(out), world
        port = str(_free_port())
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self.procs = [subprocess.Popen(
            [sys.executable, worker.__file__, str(r), str(world), port,
             self.out] + scenarios, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
            for r in range(world)]
        self.done = False

    def wait(self):
        if not self.done:
            for p in self.procs:
                try:
                    out, err = p.communicate(timeout=TIMEOUT)
                except subprocess.TimeoutExpired:
                    for q in self.procs:
                        q.kill()
                    raise
                assert p.returncode == 0, f"rank failed:\n{out}\n{err[-4000:]}"
            self.done = True
        return self

    def result(self, name):
        """The scenario's JSON from every rank."""
        self.wait()
        return [json.load(open(os.path.join(self.out, f"{name}.{r}.json")))
                for r in range(self.world)]


@contextlib.contextmanager
def _jax_without_dropout():
    """flax's ``Dropout`` as the identity inside the block (the packages
    draw their masks differently)."""
    import flax.linen as fnn

    class _NoDropout(fnn.Module):
        rate: float = 0.0
        deterministic: bool = True

        @fnn.compact
        def __call__(self, inputs, deterministic=None, rng=None):
            return inputs

    saved = fnn.Dropout
    fnn.Dropout = _NoDropout
    try:
        yield
    finally:
        fnn.Dropout = saved


def _jax_trainer(preset, fp, devices, out, init_name):
    """The JAX ``Trainer`` of ``preset`` on ``devices`` at model=2 (batch
    8 on the reference's 16 SMILES), its initial state, and its initial
    weights written as a light checkpoint of the port."""
    import jax

    from mgat_graphsage_tpu.data import MolecularDataset as JDataset
    from mgat_graphsage_tpu.parallel import make_mesh as jmake_mesh
    from mgat_graphsage_tpu.train import Trainer as JTrainer
    from mgat_graphsage_tpu.train import get_config as jget_config

    cfg = jget_config(preset, epochs=1, batch_size=8, eval_batch_size=8)
    ds = JDataset(worker.SMILES, worker.TARGETS,
                  fit_scaler=cfg.scale_targets, fingerprint=fp,
                  max_nodes=16, max_edges=32, verbose=False)
    jt = JTrainer(cfg, ds, ds, mesh=jmake_mesh(jax.devices()[:devices],
                                               model_parallel=2))
    st = jt.init_state()
    params = jax.tree_util.tree_map(np.array, jax.device_get(st.params))
    save_checkpoint(os.path.join(out, init_name), params_from_jax(params),
                    {}, 0)
    return jt, st, params, ds, cfg


def _jax_init(out):
    """The JAX trainer's initial flagship weights as a light checkpoint of
    the port; the JAX package's mesh run (data=4 x model=2 over 8 virtual
    devices, dropout off) from them, one epoch; and the gradient of the
    first step's loss in the JAX package, on the global batch.  Then
    gat_gcn's on 2 devices at model=2: its initial weights, where its
    ``fc_g1`` kernel lies, and its first step's gradients."""
    import jax

    with _jax_without_dropout():
        jt, st, params, ds, cfg = _jax_trainer("flagship", "ecfp1024", 8,
                                               out, "jax_init.pt")
        grads = params_from_jax(jax.device_get(jax.grad(
            _jax_first_loss(jt, ds, cfg))(params)))
        _, _, hist = jt.fit(state=st, verbose=False, save_best=False)
        jt, st, params, ds, cfg = _jax_trainer("gat_gcn", None, 2, out,
                                               "jax_gat_gcn_init.pt")
        gat_gcn = {"spec": st.params["fc_g1"]["kernel"].sharding.spec,
                   "grads": params_from_jax(jax.device_get(jax.grad(
                       _jax_first_loss(jt, ds, cfg))(params)))}
    return hist, grads, gat_gcn


def _jax_first_loss(jt, ds, cfg):
    """The JAX package's loss of the first batch of epoch 0 (masked MSE,
    + kl_lambda * KL for the hybrid), as a function of the parameters."""
    import jax.numpy as jnp

    from mgat_graphsage_tpu.models.zoo import kl_loss as jkl_loss
    from mgat_graphsage_tpu.ops.graph import dense_adjacency as jdense

    perm, smask = jt._epoch_indices(len(ds), cfg.batch_size,
                                    np.random.default_rng(cfg.seed))
    idx, sm = perm[0], jnp.asarray(smask[0])
    b = {k: jnp.asarray(getattr(ds, k)[idx]) for k in
         ("nodes", "edges", "node_mask", "edge_mask", "fp", "y")}

    def loss(p):
        adj = jdense(b["edges"], b["edge_mask"], b["nodes"].shape[1])
        args = (b["nodes"], adj, b["node_mask"] * sm[:, None])
        if cfg.is_hybrid:
            pred, latent = jt.model.apply({"params": p}, *args, b["fp"])
        else:
            pred, latent = jt.model.apply({"params": p}, *args), None
        err = (pred.reshape(-1) - b["y"]) ** 2
        mse = (err * sm).sum() / jnp.maximum(sm.sum(), 1.0)
        if latent is None:
            return mse
        return mse + cfg.kl_lambda * jkl_loss(latent, sm)

    return loss


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 4-rank round trip and the 2-rank scenarios, started at once;
    the JAX run first, since the 2 ranks start from its weights."""
    out4 = tmp_path_factory.mktemp("four")
    four = _Ranks(4, ["round_trip", "sr_model"], out4)
    out2 = tmp_path_factory.mktemp("two")
    jax_hist, jax_grads, jax_gat_gcn = _jax_init(str(out2))
    two = _Ranks(2, TWO_RANKS, out2)
    yield {"two": two, "four": four, "jax": jax_hist,
           "jax_grads": jax_grads, "jax_gat_gcn": jax_gat_gcn,
           "out2": str(out2), "out4": str(out4)}
    for group in (two, four):
        for p in group.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    # the full-width ecfp2048 checkpoint and gradients take ~2 GB
    for out in (out2, out4):
        shutil.rmtree(out, ignore_errors=True)


def _one_process(scenario, **over):
    """The port's 1-process run of a worker scenario (or overrides)."""
    preset, fp, kw, _ = worker.RUNS[scenario]
    cfg = get_config(preset, batch_size=8, eval_batch_size=8,
                     **{**kw, **over})
    ds = worker.dataset(cfg, fp)
    t = Trainer(cfg, ds, ds, device="cpu")
    final, _, hist = t.fit(verbose=False, save_best=False)
    return t, final, hist, t.evaluate(final)["pred"]


def _hold(mesh_runs, hist, pred, rtol=1e-4, atol=1e-5):
    """Both ranks report the same losses (rel 1e-6), and they are the
    1-process run's: losses and ``val_mse`` within rel 1e-4 / abs 1e-5,
    predictions within 1e-4."""
    r0 = mesh_runs[0]
    for other in mesh_runs[1:]:
        for a, b in zip(r0["history"], other["history"]):
            assert a["train_loss"] == pytest.approx(b["train_loss"],
                                                    rel=1e-6)
    assert len(r0["history"]) == len(hist)
    for got, want in zip(r0["history"], hist):
        for key in ("train_loss", "val_mse", "original_mse"):
            assert got[key] == pytest.approx(want[key], rel=rtol, abs=atol), \
                (key, got, want)
    np.testing.assert_allclose(np.asarray(r0["pred"]), pred, atol=1e-4,
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,pc", [(961, 4), (10, 3), (7, 8), (3000, 2)])
def test_host_row_slice_partitions_exactly(n, pc):
    slices = [host_row_slice(n, pi, pc) for pi in range(pc)]
    covered = []
    for start, stop in slices:
        covered.extend(range(start, stop))
    assert covered == list(range(n)), (n, pc, slices)
    sizes = [b - a for a, b in slices]
    assert max(sizes) - min(sizes) <= 1


def test_param_shardings_split_fc1_rows_only():
    """The reference's rule in the port's layout: only the flagship's CNN
    fc1 (weight ``[256, 131072]``, and its bias) is split, on dim 0; a
    data-only mesh splits nothing.  ``shard_state`` keeps this rank's
    rows and tells the CNN branch its columns."""
    model = build_model(get_config("flagship"))
    two = Mesh({"data": 1, "model": 2}, {"data": 0, "model": 1})
    dims = param_shardings(two, model)
    assert {n: d for n, d in dims.items() if d is not None} == {
        "cnn.fc1.weight": 0, "cnn.fc1.bias": 0}
    assert all(d is None for d in param_shardings(
        Mesh({"data": 2}, {"data": 1}), model).values())
    full = model.cnn.fc1.weight.detach().clone()
    shard_state(model, two)
    assert model.cnn.fc1.weight.shape == (128, 131072)
    assert torch.equal(model.cnn.fc1.weight, full[128:])
    split = model.cnn.fc1.column_split
    assert (split.offset, split.total) == (128, 256)
    assert model.cnn.fc2.column_split is None


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_every_preset_split_has_a_forward(preset, k):
    """``shard_state`` on a model=k mesh with no process group, the model
    built on the ``meta`` device: every parameter the reference's rule
    splits sits in a ``TorchLinear`` with its own ``ColumnSplit`` (the
    layer's whole width as ``total``, this rank's offset in it) and keeps
    ``[rows / k, in]``; nothing else is split.  The presets that split
    outside the CNN fc1 are named: ``model1``, ``gat_gcn``,
    ``morgan2048`` and ``ecfp2048`` (whose fc1 and fc2 differ in
    width)."""
    with torch.device("meta"):
        model = build_model(get_config(preset))
    coord = k - 1
    mesh = Mesh({"data": 1, "model": k}, {"data": 0, "model": coord},
                model_ranks=tuple(range(k)))
    dims = param_shardings(mesh, model)
    whole = {n: tuple(p.shape) for n, p in model.named_parameters()}
    split = sorted({n.rpartition(".")[0] for n, d in dims.items()
                    if d is not None})
    shard_state(model, mesh)
    params = dict(model.named_parameters())
    seen = []
    for path, layer in model.named_modules():
        if not isinstance(layer, TorchLinear):
            continue
        cs = layer.column_split
        if path not in split:
            assert cs is None, path
            continue
        rows, cols = whole[f"{path}.weight"]
        assert dims[f"{path}.weight"] == 0 and dims[f"{path}.bias"] == 0
        assert (cs.total, cs.offset) == (rows, coord * rows // k), path
        assert tuple(params[f"{path}.weight"].shape) == (rows // k, cols)
        assert tuple(params[f"{path}.bias"].shape) == (rows // k,)
        seen.append(cs)
    assert len(seen) == len(split) == len({id(cs) for cs in seen})
    want = {"model1": ["fc_g1"], "gat_gcn": ["fc_g1"],
            "morgan2048": ["cnn.fc1", "combined.fc1"],
            "ecfp2048": ["cnn.fc1", "cnn.fc2", "combined.fc1"]}
    if preset in want:
        assert split == want[preset]
    elif get_config(preset).is_hybrid:
        assert split == ["cnn.fc1"]
    else:
        assert split == []


def test_shard_state_refuses_a_layer_with_no_split_forward():
    """A parameter the rule splits in a layer that has no column-split
    forward (here ``nn.Linear``) is refused, not split."""
    model = torch.nn.Sequential(torch.nn.Linear(1024, 1024, device="meta"))
    mesh = Mesh({"data": 1, "model": 2}, {"data": 0, "model": 0},
                model_ranks=(0, 1))
    assert param_shardings(mesh, model)["0.weight"] == 0
    with pytest.raises(NotImplementedError,
                       match="0.weight would be column-split, but Linear "
                             "has no column-split forward"):
        shard_state(model, mesh)


def test_make_mesh_refuses_indivisible_and_makes_one_rank():
    with pytest.raises(ValueError, match="1 devices not divisible by "
                                         "model_parallel=2"):
        make_mesh(model_parallel=2)
    mesh = make_mesh()
    assert mesh.shape == {"data": 1} and mesh.coords == {"data": 0}
    batch = {"a": torch.arange(8)}
    assert torch.equal(shard_batch(batch, mesh)["a"], batch["a"])


def test_one_rank_collectives_are_identities():
    """Without a process group every collective is its 1-rank value,
    forward and backward."""
    x = torch.randn(3, 4, requires_grad=True)
    w = torch.randn(3, 4)
    (all_reduce_sum(x) * w).sum().backward()
    assert torch.equal(x.grad, w)
    c = torch.randn(2, 5, requires_grad=True)
    copy_to_group(c).sum().backward()
    assert torch.equal(c.grad, torch.ones(2, 5))
    cols = torch.randn(2, 3, requires_grad=True)
    out = gather_columns(cols, None, 0, 3)
    assert torch.equal(out, cols)
    out.sum().backward()
    assert torch.equal(cols.grad, torch.ones(2, 3))


@pytest.mark.parametrize("preset,fp", [("graphsage", None),
                                       ("gin", None),
                                       ("flagship", "ecfp1024")])
def test_one_rank_mesh_is_the_plain_run_bit_for_bit(preset, fp):
    """``use_mesh=True`` without a process group (a mesh of one rank)
    trains the non-mesh run bit for bit: the batch-shard context, the
    global normalisers and the gradient sum change nothing at one rank."""
    cfg = get_config(preset, epochs=1, batch_size=8, eval_batch_size=8)
    ds = MolecularDataset(worker.SMILES, worker.TARGETS,
                          fit_scaler=cfg.scale_targets, fingerprint=fp,
                          max_nodes=16, max_edges=32, verbose=False)
    _, _, h1 = Trainer(cfg, ds, ds, device="cpu").fit(verbose=False,
                                                      save_best=False)
    _, _, h2 = Trainer(cfg, ds, ds, device="cpu", use_mesh=True).fit(
        verbose=False, save_best=False)
    for a, b in zip(h1, h2):
        assert (a["train_loss"], a["val_mse"]) == (b["train_loss"],
                                                  b["val_mse"])


def test_hash_noise_offset():
    """Offset 0 is today's noise (the reference's ``_hash_noise16`` bit for
    bit); a block at an offset is that block of the whole parameter's
    noise, past 2^32 too, and so is its stochastic rounding."""
    import jax.numpy as jnp

    from mgat_graphsage_tpu.train.optim import _hash_noise16

    n, salt = 5000, 0xBEEF1234
    want = np.asarray(_hash_noise16((n,), jnp.uint32(salt)), np.int64)
    np.testing.assert_array_equal(hash_noise16(n, salt).numpy(), want)
    np.testing.assert_array_equal(
        hash_noise16(n, salt, offset=0).numpy(), want)
    np.testing.assert_array_equal(
        hash_noise16(1000, salt, offset=3000).numpy(), want[3000:4000])
    wrap = hash_noise16(10, salt, offset=(1 << 32) - 4).numpy()
    np.testing.assert_array_equal(
        wrap, np.concatenate([hash_noise16(1 << 2, salt,
                                           offset=(1 << 32) - 4).numpy(),
                              hash_noise16(6, salt).numpy()]))
    x = torch.randn(8, 64, generator=torch.Generator().manual_seed(0))
    whole = sr_to_bf16(x, salt)
    assert torch.equal(sr_to_bf16(x[4:], salt, offset=4 * 64), whole[4:])


# ---------------------------------------------------------------------------
# 2 and 4 ranks (gloo, CPU)
# ---------------------------------------------------------------------------

# ecfp2048's split parameters: cnn.fc1 [512, 262144], cnn.fc2 [2048, 512],
# combined.fc1 [512, 2049], and their biases
ECFP2048_SPLIT = [f"{layer}.{attr}" for layer in ("cnn.fc1", "cnn.fc2",
                                                  "combined.fc1")
                  for attr in ("weight", "bias")]


@pytest.mark.parametrize("scenario", ["gat_gcn_model", "model1_model",
                                      "morgan2048_model"])
def test_split_layers_model2_match_one_process(ranks, scenario):
    """model=2 beyond the CNN fc1: ``fc_g1`` [1500, 700] of gat_gcn and
    model1 (2 epochs), morgan2048's CNN fc1 and ``combined.fc1`` chained
    through the KL latent (1 epoch); within the reference's bound of the
    1-process run (rel 1e-4 / abs 1e-5), the ranks equal."""
    _, _, hist, pred = _one_process(scenario)
    runs = ranks["two"].result(scenario)
    assert runs[0]["mesh"] == {"data": 1, "model": 2}
    _hold(runs, hist, pred)


def test_ecfp2048_model2_first_gradients_match_one_process(ranks):
    """ecfp2048 at full width, its three layers split 2 ways: the first
    step's gradients, every split one gathered, within 1e-5 of each
    parameter's largest 1-process gradient (only the order of the f32
    sums differs)."""
    want = worker.first_gradients("ecfp2048", "ecfp2048",
                                  dict(epochs=1))["grad"]
    ranks["two"].wait()
    got = torch.load(os.path.join(ranks["out2"], "ecfp2048_grad.pt"))
    assert got.keys() == want.keys()
    assert tuple(got["cnn.fc1.weight"].shape) == (512, 262144)
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        err = float((got[name] - w).abs().max())
        assert err <= 1e-5 * float(w.abs().max()), (name, err)


def test_ecfp2048_model2_checkpoint_saves_whole_and_loads_split(ranks):
    """A full checkpoint saved from ecfp2048's 2-rank model=2 run after
    one step loads into a 1-process ``Trainer`` with ``cnn.fc1``,
    ``cnn.fc2``, ``combined.fc1`` and their Adam moments whole, each
    rank's rows in its place bit for bit; a fresh model=2 trainer that
    loads it holds each rank's rows of all three bit for bit.
    ``TorchAdam`` gets each split parameter's flat offset and group."""
    r = ranks["two"].result("ecfp2048_save")
    cfg = get_config("ecfp2048", epochs=1, batch_size=8, eval_batch_size=8)
    ds = worker.dataset(cfg, "ecfp2048")
    t = Trainer(cfg, ds, ds, device="cpu")
    state, _ = t.load(os.path.join(ranks["out2"], "ecfp2048.pt"))
    params = dict(state.model.named_parameters())
    assert state.step == 1
    assert tuple(params["cnn.fc1.weight"].shape) == (512, 262144)
    assert tuple(params["cnn.fc2.weight"].shape) == (2048, 512)
    assert tuple(params["combined.fc1.weight"].shape) == (512, 2049)
    for rank, d in enumerate(r):
        assert d["coords"] == {"data": 0, "model": rank}
        assert sorted(d["split"]) == sorted(ECFP2048_SPLIT)
        assert d["after"] == d["before"] and d["step"] == 1
        for name in ECFP2048_SPLIT:
            p = params[name]
            rows = p.shape[0] // 2
            assert d["local"][name] == [rows] + list(p.shape[1:])
            assert d["offsets"][name] == rank * rows * p[0].numel()
            assert d["ways"][name] == 2
            block = slice(rank * rows, (rank + 1) * rows)
            assert worker.digest(p[block]) == d["before"][name], name
            for k in ("exp_avg", "exp_avg_sq"):
                m = state.optimizer.state[p][k]
                assert m.shape == p.shape and bool(m.abs().max() > 0)
                assert worker.digest(m[block]) == \
                    d["before"][f"{name}:{k}"], (name, k)


def test_jax_gat_gcn_model2_splits_fc_g1_and_matches_port_gradients(ranks):
    """The JAX ``Trainer`` of gat_gcn on 2 virtual devices at model=2
    places ``fc_g1/kernel`` at ``P(None, "model")``, the layer the port
    splits; from its weights, dropout off on both sides, its first step's
    gradients and the port's 2-rank ones (``fc_g1`` gathered) agree to
    1e-4 of each parameter's largest JAX gradient, floored at 1e-5 of the
    model's largest."""
    from jax.sharding import PartitionSpec

    jax_run = ranks["jax_gat_gcn"]
    assert jax_run["spec"] == PartitionSpec(None, "model")
    want = jax_run["grads"]
    ranks["two"].wait()
    got = torch.load(os.path.join(ranks["out2"], "jax_gat_gcn_grad.pt"))
    assert got.keys() == want.keys()
    assert tuple(got["fc_g1.weight"].shape) == (1500, 700)
    top = max(float(g.abs().max()) for g in want.values())
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        err = float((got[name] - w).abs().max())
        assert err <= 1e-4 * max(float(w.abs().max()), 1e-5 * top), \
            (name, err)

def test_collectives_match_one_rank_values(ranks):
    r = ranks["two"].result("collectives")
    x = [np.asarray(d["x"]) for d in r]
    for d in r:
        np.testing.assert_allclose(d["y"], x[0] + x[1], rtol=1e-6)
        # each rank's output feeds every rank's loss
        np.testing.assert_array_equal(d["x_grad"],
                                      2 * np.arange(12.0).reshape(3, 4))
        np.testing.assert_array_equal(d["c_grad"], np.full((2, 5), 3.0))
        np.testing.assert_array_equal(d["full"], [[1, 1, 1, 2, 2, 2]] * 2)
        assert d["p32"] == [2.0] * 7 and d["p16"] == [3.0] * 5
        assert d["rows_a"] == list(range(10))
        assert d["rows_b"] == [i % 2 == 0 for i in range(10)]
        assert d["rows_b_dtype"] == "bool"
        assert "not divisible by model_parallel=3" in d["refused"]
        assert d["replicated"] == [[1.0] * 3] * 2 and d["is_distributed"]
    for rank, d in enumerate(r):
        np.testing.assert_array_equal(d["cols_grad"],
                                      [list(range(3 * rank, 3 * rank + 3))]
                                      * 2)
    assert [d["slice"] for d in r] == [[0, 5], [5, 10]]


def test_graphsage_data2_matches_one_process(ranks):
    _, _, hist, pred = _one_process("graphsage_data")
    runs = ranks["two"].result("graphsage_data")
    assert runs[0]["mesh"] == {"data": 2}
    _hold(runs, hist, pred)


def test_gin_data2_global_batch_norm_matches_one_process(ranks):
    """GIN's batch norms take the global batch's statistics: one epoch
    (lr 1e-4) as the 1-process one, the running buffers the same on both
    ranks; after the first step the running buffers within 1e-6 of the
    1-process ones, and the summed gradients within 1e-4 (of the largest)
    of the exact f64 gradient, the bound the 1-process f32 gradient meets
    (``test_torch_baselines.py``).  GIN's f32 gradient is ill-conditioned
    (batch-norm variances near eps): the 1-process and the 2-rank
    gradients are each ~2e-5 off the f64 one, and Adam's first steps turn
    that into loss gaps of ~1e-4 by the second epoch, so one epoch is
    compared."""
    t, _, hist, pred = _one_process("gin_data")
    runs = ranks["two"].result("gin_data")
    _hold(runs, hist, pred)
    assert runs[0]["buffers"] == runs[1]["buffers"]
    got = torch.load(os.path.join(ranks["out2"], "gin_grad.pt"))
    exact, buffers = _gin_first_step(t)
    for name, want in buffers.items():
        np.testing.assert_allclose(got["buffers"][name].numpy(),
                                   want.numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    gmax = max(float(g.abs().max()) for g in exact.values())
    for name, g in exact.items():
        err = float((got["grad"][name].double() - g).abs().max()) / gmax
        assert err < 1e-4, (name, err)


def _gin_first_step(t):
    """The first step's gradients of GIN in f64 (the model and the batch
    cast), dropout from the same generator as the f32 run; and the f32
    1-process run's buffers after that step."""
    from mgat_graphsage_torch.ops import dense_adjacency
    from mgat_graphsage_torch.train.trainer import _masked_mse

    cfg, ds = t.cfg, t.train_ds
    model = t.init_state().model.double()
    model.train()
    batch = next(t._batches(ds, cfg.batch_size,
                            np.random.default_rng(cfg.seed)))
    b = {k: v.double() if v.is_floating_point() else v
         for k, v in batch.items()}
    adj = dense_adjacency(batch["edges"], batch["edge_mask"],
                          batch["nodes"].shape[1]).double()
    node_mask = b["node_mask"] * b["sample_mask"].unsqueeze(1)
    pred = model(b["nodes"], adj, node_mask, t._dropout_generator(0))
    _masked_mse(pred, b["y"], b["sample_mask"]).backward()
    state = t.init_state()
    state.optimizer.step = lambda *a, **k: None
    t.train_step(state, batch, t._dropout_generator(0))
    return ({n: p.grad for n, p in model.named_parameters()},
            dict(state.model.named_buffers()))


def test_flagship_model2_matches_one_process(ranks):
    """fc1 split over 2 ranks (data=1, model=2); ``cnn_pallas_bwd`` asked
    for, turned off with a warning."""
    _, _, hist, pred = _one_process("flagship_model", cnn_pallas_bwd=False)
    runs = ranks["two"].result("flagship_model")
    assert runs[0]["mesh"] == {"data": 1, "model": 2}
    assert runs[0]["cnn_pallas_bwd"] is False
    assert any("cnn_pallas_bwd is turned off" in w
               for w in runs[0]["warnings"])
    _hold(runs, hist, pred)


def test_flagship_data2_with_cnn_kernels_matches_one_process(ranks):
    """data=2 keeps ``cnn_pallas_bwd``: each rank's CNN backward on its
    rows, its weight gradients summed with the rest."""
    _, _, hist, pred = _one_process("flagship_data_pallas")
    runs = ranks["two"].result("flagship_data_pallas")
    assert runs[0]["cnn_pallas_bwd"] is True and not runs[0]["warnings"]
    _hold(runs, hist, pred)
    ranks["hist_data_pallas"] = hist


def test_factored_second_moment_under_the_split_matches_one_process(ranks):
    """``adam_factored_v`` with fc1 split 2 ways: each rank's factored
    moment takes the column means over every rank's rows."""
    _, _, hist, pred = _one_process("factored_model")
    _hold(ranks["two"].result("factored_model"), hist, pred)


def test_kl_term_without_its_data_share_fails_parity(ranks):
    """Every rank adding the whole KL term multiplies its gradient by
    P_data: the parity bound above sees it."""
    hist = ranks.get("hist_data_pallas") or \
        _one_process("flagship_data_pallas")[2]
    runs = ranks["two"].result("flagship_no_kl_share")
    gaps = [abs(g["train_loss"] - w["train_loss"]) / abs(w["train_loss"])
            for g, w in zip(runs[0]["history"], hist)]
    assert max(gaps) > 1e-2, gaps


def test_sr_master_data2_model2_draws_the_single_process_noise(ranks):
    """bf16 master with stochastic rounding on 4 ranks, data=2 x model=2
    (the bf16 gradients summed in bf16 over the data axis, fc1 split 2
    ways): each block hashes its elements' unsplit indices, so the rounded
    fc1 tracks the 1-process run's (the reference's bound: < 0.15 of
    elements differ; a wrong noise stream flips ~1/3)."""
    _, final, hist, _ = _one_process("sr_model")
    runs = ranks["four"].result("sr_model")
    assert runs[0]["mesh"] == {"data": 2, "model": 2}
    for g, w in zip(runs[0]["history"], hist):
        assert g["train_loss"] == pytest.approx(w["train_loss"], rel=2e-2,
                                                abs=2e-2)
    blob = torch.load(os.path.join(ranks["out4"], "sr_model.pt"))
    got = blob["state_dict"]["cnn.fc1.weight"]
    want = final.model.cnn.fc1.weight.detach()
    assert got.shape == want.shape == (256, 131072)
    assert got.dtype == torch.bfloat16
    mismatch = float((got != want).float().mean())
    assert mismatch < 0.15, mismatch


def test_jax_mesh_epoch_matches_port_model2(ranks, monkeypatch):
    """The JAX ``Trainer`` on ``make_mesh(jax.devices()[:8],
    model_parallel=2)`` and the port's 2-rank model=2 run, from the same
    weights, dropout off on both sides, one flagship epoch: the epoch's
    train loss (both steps) within rel 1e-4, and the first step's
    gradients (summed, fc1 gathered) within 1e-4 of each parameter's
    largest JAX gradient (floored at 1e-5 of the model's largest), the
    bound ``test_torch_train.py`` holds the 1-process port to.

    ``val_mse`` after the epoch is held to the port's 1-process run from
    the same weights (rel 1e-4).  Against the JAX run it parts by ~5e-3
    at this size, and so does the port's 1-process run against JAX's
    single-device one: Adam's first step moves each parameter by ~lr
    times the sign of its gradient, and a dozen fc1 / fc2 elements whose
    gradients are rounding noise (|g| ~ 1e-9 .. 1e-6) take opposite signs
    in the two packages (ROADMAP Queue 3)."""
    from mgat_graphsage_torch.models import Dropout

    runs = ranks["two"].result("jax_model")
    for g, w in zip(runs[0]["history"], ranks["jax"]):
        assert g["train_loss"] == pytest.approx(w["train_loss"], rel=1e-4)
    got = torch.load(os.path.join(ranks["out2"], "jax_grad.pt"))
    want = ranks["jax_grads"]
    top = max(float(g.abs().max()) for g in want.values())
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        err = float((got[name] - w).abs().max())
        assert err <= 1e-4 * max(float(w.abs().max()), 1e-5 * top), \
            (name, err)
    monkeypatch.setattr(Dropout, "forward",
                        lambda self, x, generator=None: x)
    cfg = get_config("flagship", epochs=1, batch_size=8, eval_batch_size=8)
    ds = worker.dataset(cfg, "ecfp1024")
    t = Trainer(cfg, ds, ds, device="cpu")
    state, _ = t.load(os.path.join(ranks["out2"], "jax_init.pt"))
    final, _, hist = t.fit(state=state, verbose=False, save_best=False)
    _hold(runs, hist, t.evaluate(final)["pred"])


def test_checkpoint_round_trip_data2_model2(ranks):
    """4 ranks, data=2 x model=2: save mid-run (the whole fc1 gathered),
    load into a fresh trainer (each rank keeps its rows), continue: the
    third epoch is the uninterrupted run's."""
    r = ranks["four"].result("round_trip")
    assert [d["coords"] for d in r] == [
        {"data": i, "model": j} for i in range(2) for j in range(2)]
    for d in r:
        assert d["mesh"] == {"data": 2, "model": 2}
        assert d["fc1_local"] == [128, 131072]
        for full, a in zip(d["full"][:2], d["a"]):
            assert full[0] == pytest.approx(a[0], rel=1e-5)
        assert len(d["b"]) == 1
        for got, want in zip(d["b"][0], d["full"][2]):
            assert got == pytest.approx(want, rel=1e-4, abs=1e-5)
        assert d["full"][2][0] == pytest.approx(r[0]["full"][2][0],
                                                rel=1e-6)


def test_cli_distributed_model_parallel(ranks):
    """``python -m mgat_graphsage_torch.train.run --distributed
    --dist-backend gloo --model-parallel 2`` on 2 ranks: rank 0 alone
    prints, and its checkpoint holds the whole fc1."""
    r = ranks["two"].result("cli")
    assert "Training completed" in r[0]["stdout"]
    assert "Epoch    1" in r[0]["stdout"]
    assert r[1]["stdout"] == ""
    assert r[0]["fc1"] == [256, 131072]
