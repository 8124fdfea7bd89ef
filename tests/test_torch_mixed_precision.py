"""Mixed precision in the port (``compute_dtype``, ``adam_moment_dtype``,
``master_dtype``, ``remat``, ``adam_factored_v`` and bf16 serving) against
the reference package on the CPU.

Data: the first 96 molecules of the bundled train CSV (``fp_data``, as
``tests/test_mixed_precision.py`` takes them), batch 32, the ``flagship``
hybrid at full width.  Weights cross with ``models/convert.py``; where a
test compares trajectories, dropout is patched to the identity on both
sides (the two packages draw their masks from different generators).

Tolerances, and why:
- the optimizer against ``torch_adam``: parameters to rtol 1e-6 (the same
  f32 operations in the same order; the bias corrections' f32 ``pow`` may
  differ by an ulp between numpy and XLA) and stored bf16 moments within
  one bf16 ulp (a last-bit difference before the cast may cross a rounding
  boundary);
- bf16 forward, serving, and the bf16 loss against f32: the bounds of
  ``tests/test_mixed_precision.py`` (atol = rtol = 0.05 on O(1)
  predictions; 0.1 * |f32 loss| + 0.05);
- the first two bf16 train steps against the JAX ``Trainer``: losses
  within rtol 2e-3 and 2e-2, and the first step's gradients held to the
  reference's own bf16 gradient error (see the test);
- 2 bf16 epochs against the JAX ``Trainer``: the reference's own bf16
  drift bound, 0.1 * |loss| + 0.05.  Two bf16 programs that round
  different intermediates part like two runs of one program from weights
  1e-6 apart: at this lr (1e-3, losses near 12 after 3 steps) such a
  perturbation of the port's own initial weights moves its 2-epoch bf16
  losses by 0.7-3.1%, so no tighter bound separates a fault from the
  noise (``tests/bf16_drift.py`` measures both: gaps of 3.0% and 2.7%
  here, where the f32 runs agree to 2e-6);
- the hash noise and stochastic rounding: bit for bit (integer math).
"""

import json
import os

import numpy as np
import pytest
import torch
import flax.linen as fnn
import jax
import jax.numpy as jnp
import ml_dtypes

from mgat_graphsage_tpu.data import MolecularDataset as JDataset
from mgat_graphsage_tpu.data.packed import gather_batch
from mgat_graphsage_tpu.eval.predict import Predictor as JPredictor
from mgat_graphsage_tpu.train import Trainer as JTrainer
from mgat_graphsage_tpu.train import get_config as jget_config
from mgat_graphsage_tpu.train.optim import (
    _hash_noise16,
    _key_salt,
    _sr_to_bf16,
    torch_adam,
    torch_adam_sr_update,
)
from mgat_graphsage_tpu.train.trainer import _lr_schedule

from mgat_graphsage_torch.data import TRAIN_CSV, MolecularDataset, load_csv
from mgat_graphsage_torch.eval import Predictor
from mgat_graphsage_torch.models import (
    Dropout,
    adam_state_from_jax,
    adam_state_to_jax,
    params_from_jax,
)
from mgat_graphsage_torch.models.layers import TorchLinear
from mgat_graphsage_torch.train import Trainer, get_config, lr_schedule
from mgat_graphsage_torch.train.optim import (
    TorchAdam,
    hash_noise16,
    set_lr,
    sr_to_bf16,
)

N_MOL = 96
BATCH = 32


@pytest.fixture(scope="module")
def data():
    sm, y = load_csv(TRAIN_CSV)
    ds = MolecularDataset(sm[:N_MOL], y[:N_MOL], fit_scaler=True,
                          verbose=False)
    jds = JDataset(sm[:N_MOL], y[:N_MOL], fit_scaler=True,
                   fingerprint="ecfp1024", verbose=False)
    return ds, jds


class _NoDropout(fnn.Module):
    """flax stand-in for ``nn.Dropout`` that passes its input through."""
    rate: float = 0.0
    deterministic: bool = True

    @fnn.compact
    def __call__(self, inputs, deterministic=None, rng=None):
        return inputs


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(fnn, "Dropout", _NoDropout)
    monkeypatch.setattr(Dropout, "forward", lambda self, x, generator=None: x)


def _bits(a) -> np.ndarray:
    """The 16-bit patterns of a bf16 array or tensor, as int32."""
    if isinstance(a, torch.Tensor):
        return a.detach().view(torch.int16).numpy().astype(np.int32)
    return np.asarray(a).view(np.int16).astype(np.int32)


def _ulps(got, want) -> int:
    """Largest distance in bf16 ulps between two bf16 arrays of one sign
    pattern (bit patterns of same-signed values are ordered)."""
    return int(np.abs(_bits(got) - _bits(want)).max())


def _port_state(trainer, jstate):
    state = trainer.init_state()
    state.model.load_state_dict(
        params_from_jax(jax.device_get(jstate.params)), strict=True)
    return state


# ---------------------------------------------------------------------------
# 1. the optimizer (step 1)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["constant", "warmup_cosine"])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adam_matches_reference_torch_adam(moments, schedule):
    """Four updates of ``TorchAdam`` on bf16 gradients read from a working
    copy, against the reference's ``torch_adam`` on the same gradients:
    parameters to rtol 1e-6, moments within one bf16 ulp (bf16 storage)
    or rtol 1e-6 (f32), the copy equal to the new master cast to bf16."""
    kw = dict(lr=2e-3, weight_decay=1e-2, lr_schedule=schedule,
              warmup_steps=3, adam_moment_dtype=moments,
              compute_dtype="bfloat16")
    total = 8
    jsched = _lr_schedule(jget_config("flagship", **kw), total)
    sched = lr_schedule(get_config("flagship", **kw), total)
    rng = np.random.default_rng(5)
    shapes = {"a": (6, 5), "b": (7,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(ml_dtypes.bfloat16)
              for k, s in shapes.items()} for _ in range(4)]
    tx = torch_adam(jsched, weight_decay=1e-2, moment_dtype=moments)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jst = tx.init(jp)
    for g in grads:
        upd, jst = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                             jst, jp)
        jp = jax.tree_util.tree_map(lambda a, u: a + u, jp, upd)

    module = torch.nn.Module()
    for k, v in p0.items():
        module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v)))
    opt = TorchAdam(module.parameters(), lr=2e-3, weight_decay=1e-2,
                    moment_dtype=getattr(torch, moments))
    copies = [p.detach().to(torch.bfloat16) for p in module.parameters()]
    for step, g in enumerate(grads):
        for c, k in zip(copies, shapes):
            c.grad = params_from_jax({k: {"bias": g[k]}})[f"{k}.bias"]
        set_lr(opt, sched(step + 1) if callable(sched) else sched)
        opt.step(copies=copies)
    for i, k in enumerate(shapes):
        p = getattr(module, k)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=0, err_msg=k)
        assert torch.equal(copies[i], p.detach().to(torch.bfloat16)), k
        assert copies[i].grad is None
        st = opt.state[p]
        assert st["exp_avg"].dtype == getattr(torch, moments)
        for key, want in (("exp_avg", jst.mu[k]), ("exp_avg_sq", jst.nu[k])):
            if moments == "bfloat16":
                assert _ulps(st[key], want) <= 1, (k, key)
            else:
                np.testing.assert_allclose(st[key].numpy(), np.asarray(want),
                                           rtol=1e-6, err_msg=f"{k} {key}")


def _small_pair():
    from mgat_graphsage_tpu.models import zoo as jzoo
    from mgat_graphsage_torch.models import HybridModel

    kw = dict(fp_dim=64, cnn_fc_hidden=16, combined_hidden=32)
    jm = jzoo.HybridModel(**kw)
    n = 12
    params = jax.device_get(jm.init(
        jax.random.PRNGKey(0), jnp.zeros((2, n, 35)), jnp.zeros((2, n, n)),
        jnp.ones((2, n)), jnp.zeros((2, 64)))["params"])
    return params, HybridModel(**kw)


def test_bf16_moments_carry_over_unchanged_both_ways():
    """Two reference updates with bf16 moments; the state carried into
    the port's ``TorchAdam`` (through a ``state_dict`` round trip) and back
    to a reference tree: every moment bit for bit, bf16 on both sides;
    then one more update on both sides agrees as in the test above."""
    params, model = _small_pair()
    tx = torch_adam(1e-3, weight_decay=1e-4, moment_dtype="bfloat16")
    rng = np.random.default_rng(2)
    grads = [jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
        for _ in range(3)]
    jp, jst = params, tx.init(params)
    for g in grads[:2]:
        upd, jst = tx.update(g, jst, jp)
        jp = jax.device_get(jax.tree_util.tree_map(lambda a, u: a + u, jp,
                                                   upd))
    jst = jax.device_get(jst)
    model.load_state_dict(params_from_jax(jp))
    opt = TorchAdam(model.parameters(), lr=1e-3, weight_decay=1e-4,
                    moment_dtype=torch.bfloat16)
    opt.load_state_dict(adam_state_from_jax(jst, model, opt))
    reloaded = TorchAdam(model.parameters(), lr=1e-3, weight_decay=1e-4,
                         moment_dtype=torch.bfloat16)
    reloaded.load_state_dict(opt.state_dict())
    back = adam_state_to_jax(model, reloaded)
    assert int(back["count"]) == 2
    for port_tree, jax_tree in ((back["mu"], jst.mu), (back["nu"], jst.nu)):
        flat = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
        ours = jax.tree_util.tree_flatten_with_path(port_tree)[0]
        assert len(flat) == len(ours)
        for (path, a), (_, b) in zip(ours, flat):
            assert a.dtype.name == "bfloat16" == np.asarray(b).dtype.name
            np.testing.assert_array_equal(_bits(a), _bits(b),
                                          err_msg=str(path))
    upd, jst3 = tx.update(grads[2], jst, jp)
    jp3 = params_from_jax(jax.device_get(
        jax.tree_util.tree_map(lambda a, u: a + u, jp, upd)))
    for name, g in params_from_jax(grads[2]).items():
        model.get_parameter(name).grad = g
    reloaded.step()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jp3[name].numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=name)


# ---------------------------------------------------------------------------
# 2-4. bf16 compute (step 2)
# ---------------------------------------------------------------------------

def test_bf16_evaluate_matches_reference(data):
    """The port's bf16 ``Trainer.evaluate`` against the reference's on the
    same weights: atol = rtol = 0.05, the bound the reference holds its
    own bf16 forward to against f32."""
    ds, jds = data
    cfg = dict(batch_size=BATCH, compute_dtype="bfloat16")
    jt = JTrainer(jget_config("flagship", **cfg), jds, jds)
    jstate = jt.init_state()
    jev = jt.evaluate(jstate, jds)
    pt = Trainer(get_config("flagship", **cfg), ds, ds, device="cpu")
    ev = pt.evaluate(_port_state(pt, jstate))
    gap = float(np.abs(ev["pred"] - jev["pred"]).max())
    np.testing.assert_allclose(ev["pred"], jev["pred"], atol=0.05, rtol=0.05,
                               err_msg=f"max |gap| {gap}")
    assert np.abs(jev["pred"]).max() > 1e-3


def test_bf16_step_keeps_f32_state_and_close_loss(data):
    """One epoch at bf16 compute (f32 moments) against one at f32 from the
    same seed: master and moments stay f32, the loss is finite and within
    0.1 * |f32 loss| + 0.05 of the f32 one."""
    ds, _ = data
    losses = {}
    for dt in ("float32", "bfloat16"):
        cfg = get_config("flagship", batch_size=BATCH, compute_dtype=dt)
        trainer = Trainer(cfg, ds, None, device="cpu")
        state, m = trainer.train_epoch(trainer.init_state(), 0)
        losses[dt] = m["train_loss"]
        for p in state.model.parameters():
            assert p.dtype == torch.float32
            for key in ("exp_avg", "exp_avg_sq"):
                assert state.optimizer.state[p][key].dtype == torch.float32
    assert np.isfinite(losses["bfloat16"])
    assert abs(losses["bfloat16"] - losses["float32"]) \
        < 0.1 * abs(losses["float32"]) + 0.05, losses


def test_bf16_two_epochs_match_reference_trainer(data, no_dropout):
    """2 epochs of ``compute_dtype = adam_moment_dtype = "bfloat16"`` in
    both packages from the same weights and batch order: per-epoch train
    losses within 0.1 * |loss| + 0.05 (see the module docstring)."""
    ds, jds = data
    cfg = dict(epochs=2, batch_size=BATCH, compute_dtype="bfloat16",
               adam_moment_dtype="bfloat16")
    jt = JTrainer(jget_config("flagship", **cfg), jds)
    jstate = jt.init_state()
    pt = Trainer(get_config("flagship", **cfg), ds, device="cpu")
    state = _port_state(pt, jstate)
    _, _, jhist = jt.fit(state=jstate, verbose=False, save_best=False)
    final, _, hist = pt.fit(state=state, verbose=False, save_best=False)
    assert final.step == 6
    got = np.array([h["train_loss"] for h in hist])
    want = np.array([h["train_loss"] for h in jhist])
    gap = np.abs(got - want)
    assert (gap < 0.1 * np.abs(want) + 0.05).all(), \
        f"port {got} vs reference {want}: rel gap {gap / np.abs(want)}"



def test_bf16_first_steps_match_reference_trainer(data, no_dropout):
    """The first two bf16 train steps (``compute_dtype="bfloat16"``, f32
    moments) in both packages from the same weights and batches, before
    rounding differences compound (see the module docstring):

    - step losses within rtol 2e-3 at step 1 (one bf16 forward of the same
      weights: measured 2e-4) and 2e-2 at step 2 (measured 7.1e-3);
    - step 1's bf16 gradient, read from Adam's first moment
      (``m = (1 - b1) g`` after one step), against the reference's f32
      gradient, with no L2 term.  A bf16 gradient sums many rounded
      terms that cancel, so it lies 0.04-130% (relative L2, per
      parameter) from the f32 one in either package.  Per parameter the
      port's gap stays within twice the reference's bf16 gap plus 0.1
      (measured: at most 5.4 times, on a one-element bias), and summed
      over the parameters within 1.25 times the reference's sum
      (measured 0.85).  A gradient lost or halved on the way through the
      attention lies 50-100% off.
    """
    ds, jds = data
    # no L2 term, so that the first moment holds the loss gradient alone
    kw = dict(epochs=2, batch_size=BATCH, weight_decay=0.0)
    perm, smask = JTrainer._epoch_indices(
        N_MOL, BATCH, np.random.default_rng(get_config("flagship").seed))
    jlosses, grads = [], {}
    for dt in ("bfloat16", "float32"):
        jt = JTrainer(jget_config("flagship", compute_dtype=dt, **kw), jds)
        jstate = jt.init_state()
        jt._build_steps()
        jdata = jt._device_dataset(jds)
        for i in range(2 if dt == "bfloat16" else 1):
            batch = gather_batch(jdata, jnp.asarray(perm[i]),
                                 jds.fp.shape[1])
            batch["sample_mask"] = jnp.asarray(smask[i])
            jstate, m = jt._train_step(jstate, batch, jax.random.PRNGKey(i))
            if dt == "bfloat16":
                jlosses.append(float(m["loss"]))
            if i == 0:
                grads[dt] = {n: t.float() / 0.1 for n, t in params_from_jax(
                    jax.device_get(jstate.opt_state.mu)).items()}

    pt = Trainer(get_config("flagship", compute_dtype="bfloat16", **kw), ds,
                 device="cpu")
    state = _port_state(pt, jax.device_get(jt.init_state()))
    copy = pt.compute_copy(state.model)
    batches = pt._batches(ds, BATCH, np.random.default_rng(pt.cfg.seed))
    losses = []
    for i in range(2):
        losses.append(float(pt.train_step(state, next(batches), None,
                                          copy)["loss"]))
        if i == 0:
            port = {n: state.optimizer.state[p].get(
                "exp_avg", torch.zeros_like(p)) / 0.1
                for n, p in state.model.named_parameters()}
    rel = np.abs(np.array(losses) / np.array(jlosses) - 1)
    assert rel[0] < 2e-3 and rel[1] < 2e-2, (losses, jlosses, rel)

    exact = grads["float32"]

    def gap(g, n):
        return float((g[n] - exact[n]).norm() / exact[n].norm())

    # the query bias's gradient is zero by construction (the softmax over
    # keys does not see it): what either package returns for it is noise
    gaps = {n: (gap(port, n), gap(grads["bfloat16"], n)) for n in exact
            if n != "gat_graphsage.conv1.query_transform.bias"}
    worse = {n: g for n, g in gaps.items() if g[0] > 2 * g[1] + 0.1}
    total, ref = (sum(g[k] for g in gaps.values()) for k in (0, 1))
    assert not worse and total < 1.25 * ref, (
        f"bf16 gradient gaps to f32 (port, reference): {gaps}; summed "
        f"{total:.3f} vs {ref:.3f}")


def test_bf16_training_converges(data):
    cfg = get_config("flagship", epochs=4, batch_size=BATCH,
                     compute_dtype="bfloat16", adam_moment_dtype="bfloat16")
    trainer = Trainer(cfg, data[0], None, device="cpu")
    state = trainer.init_state()
    losses = []
    for e in range(cfg.epochs):
        state, m = trainer.train_epoch(state, e)
        losses.append(m["train_loss"])
    assert all(np.isfinite(v) for v in losses), losses
    assert losses[-1] < losses[0] * 0.9, losses


def test_production_preset_trains_checkpoints_resumes_and_serves(data,
                                                                 tmp_path):
    """``flagship_bf16_bs1024_wc`` (batch cut to 32): the best checkpoint
    holds the f32 master and full bf16 moments, a resumed run repeats the
    uninterrupted one exactly (dropout on), the carried copy is the master
    cast, and the checkpoint serves in bf16 with NaN for "C1CC(" and
    within 0.05 (normalised) of f32 serving."""
    ds, _ = data
    cfg = get_config("flagship_bf16_bs1024_wc", epochs=2, batch_size=BATCH)
    whole = Trainer(cfg, ds, ds, device="cpu", ckpt_dir=str(tmp_path / "a"))
    final, _, hist = whole.fit(verbose=False)
    assert cfg.batch_size == BATCH and whole._total_steps == 6
    ckpt = str(tmp_path / "a" / "best_model.pt")
    blob = torch.load(ckpt, weights_only=True)
    assert all(t.dtype == torch.float32 for t in blob["state_dict"].values())
    assert {s["exp_avg"].dtype for s in blob["optimizer"]["state"].values()} \
        == {torch.bfloat16}
    assert json.load(open(ckpt + ".json"))["config"]["compute_dtype"] \
        == "bfloat16"

    first = Trainer(cfg.replace(epochs=1), ds, ds, device="cpu")
    state, _, _ = first.fit(verbose=False, save_best=False)
    path = str(tmp_path / "ckpt_3.pt")
    first.save(path, state, {"epoch": 1})
    second = Trainer(cfg, ds, ds, device="cpu")
    resumed, _ = second.load(path)
    assert all(s["exp_avg_sq"].dtype == torch.bfloat16
               for s in resumed.optimizer.state.values())
    _, _, rest = second.fit(state=resumed, start_epoch=1, verbose=False,
                            save_best=False)
    assert rest[0]["train_loss"] == hist[1]["train_loss"]

    smiles = ds.smiles[:20] + ["C1CC("]
    bf16 = Predictor(ckpt, infer_dtype="bfloat16", device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in bf16.model.parameters())
    f32 = Predictor(ckpt, device="cpu")
    a, b = bf16(smiles), f32(smiles)
    assert np.isnan(a[-1]) and np.isnan(b[-1])
    gap = np.abs(a[:-1] - b[:-1]).max() / ds.scaler.scale_
    assert np.isfinite(a[:-1]).all() and gap < 0.05, gap


# ---------------------------------------------------------------------------
# 5. bf16 serving (step 3)
# ---------------------------------------------------------------------------

def test_bf16_predictor_matches_reference(data, tmp_path):
    """The port's ``Predictor(infer_dtype="bfloat16")`` against the
    reference's on one checkpoint's weights (a 2-step JAX run, saved by
    both packages): atol = rtol = 0.05 in normalised units, NaN in the
    same slots."""
    _, jds = data
    jcfg = jget_config("flagship", epochs=1, batch_size=48)
    jt = JTrainer(jcfg, jds, jds, ckpt_dir=str(tmp_path))
    jt.fit(verbose=False)
    jpath = str(tmp_path / "best_model.msgpack")
    port = Trainer(get_config("flagship", batch_size=48), data[0],
                   device="cpu")
    state = port.init_state()
    jstate, meta = jt.load(jpath)
    state.model.load_state_dict(params_from_jax(jax.device_get(
        jstate.params)))
    tpath = str(tmp_path / "port.pt")
    port.save(tpath, state, light=True)
    smiles = jds.smiles[:30]
    smiles = smiles[:7] + ["C1CC("] + smiles[7:]
    want = JPredictor(jpath, infer_dtype="bfloat16")(smiles)
    got = Predictor(tpath, infer_dtype="bfloat16", device="cpu")(smiles)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[7])
    keep = ~np.isnan(want)
    scale = jds.scaler.scale_
    gap = float(np.abs(got[keep] - want[keep]).max() / scale)
    np.testing.assert_allclose(got[keep] / scale, want[keep] / scale,
                               atol=0.05, rtol=0.05,
                               err_msg=f"max |gap| {gap} (normalised)")


# ---------------------------------------------------------------------------
# 6. remat (step 4)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_remat_repeats_the_plain_step_with_dropout_on(data, compute):
    """The first 3 train steps with and without ``remat``, dropout on,
    from one seed: equal losses, equal parameters, and the dropout
    generator in the same state after them (the recompute redraws the
    forward's masks and leaves the stream where the forward left it)."""
    ds, _ = data
    runs = []
    for remat in (False, True):
        cfg = get_config("flagship", batch_size=BATCH, remat=remat,
                         compute_dtype=compute)
        trainer = Trainer(cfg, ds, device="cpu")
        state = trainer.init_state()
        gen = trainer._dropout_generator(0)
        copy = trainer.compute_copy(state.model)
        losses = [trainer.train_step(state, b, gen, copy)["loss"].item()
                  for b in trainer._batches(ds, BATCH,
                                            np.random.default_rng(cfg.seed))]
        runs.append((losses, [p.detach().clone()
                              for p in state.model.parameters()],
                     gen.get_state()))
    (l0, p0, g0), (l1, p1, g1) = runs
    assert len(l0) == 3 and l0 == l1, (l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert torch.equal(g0, g1)


# ---------------------------------------------------------------------------
# 7. the bf16 master with stochastic rounding (step 5)
# ---------------------------------------------------------------------------

BIG = (1 << 24) + 4099


@pytest.mark.parametrize("salt", [0, 0x1234ABCD, 0xFFFFFFFF])
def test_hash_noise_and_sr_bitwise_equal_reference(salt):
    """Past 2**24 elements (the fc1 weight has 33.5M), the port's hash
    noise and stochastic rounding equal the reference's bit for bit."""
    want = np.asarray(_hash_noise16((BIG,), jnp.uint32(salt)))
    got = hash_noise16(BIG, salt).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    key = jax.random.PRNGKey(salt & 0x7FFFFFFF)
    x = np.random.default_rng(salt & 0xFFFF).standard_normal(
        BIG).astype(np.float32) * np.float32(3e-3)
    want = np.asarray(_sr_to_bf16(jnp.asarray(x), key))
    got = sr_to_bf16(torch.from_numpy(x), int(_key_salt(key)))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_stochastic_rounding_unbiased_and_accumulates():
    """As the reference's test: the mean of 600 roundings sits within a
    quarter of the bf16 spacing of x, and 100 updates of 1e-4 onto 1.0
    (1/39 of the spacing, lost to round-to-nearest) accumulate."""
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(64,)).astype(np.float32) * 0.01)
    acc = np.zeros(64, np.float64)
    reps = 600
    for k in range(reps):
        acc += sr_to_bf16(x, k).float().numpy().astype(np.float64)
    err = np.abs(acc / reps - x.numpy().astype(np.float64))
    spacing = np.abs(x.numpy()) * 2.0 ** -8 + 1e-12
    assert (err < 0.25 * spacing + 1e-9).all()
    cur = torch.full((1000,), 1.0, dtype=torch.bfloat16)
    for k in range(100):
        cur = sr_to_bf16(cur.float() + 1e-4, 0x9E3779B9 * (k + 1))
    mean = float(cur.float().mean())
    assert 1.005 < mean < 1.015, mean


def test_sr_update_matches_reference_on_its_salts():
    """``TorchAdam`` on bf16 parameters, given the reference's salt,
    against ``torch_adam_sr_update``: parameters within one bf16 ulp (the
    same noise on an f32 sum that may differ in its last bit), moments
    equal, and both within one ulp of the exact f32 Adam result."""
    rng = np.random.default_rng(1)
    shapes = {"a": (64, 8), "b": (8,)}
    p16 = {k: jnp.asarray(rng.normal(size=s), jnp.bfloat16)
           for k, s in shapes.items()}
    grads = {k: jnp.asarray(rng.normal(size=s), jnp.bfloat16)
             for k, s in shapes.items()}
    lr, wd = 1e-2, 1e-4
    key = jax.random.PRNGKey(3)
    tx = torch_adam(lr, weight_decay=wd, moment_dtype="bfloat16")
    want, jst = torch_adam_sr_update(grads, tx.init(p16), p16, key, lr=lr,
                                     weight_decay=wd,
                                     moment_dtype="bfloat16")
    module = torch.nn.Module()
    for k in shapes:
        t = params_from_jax({k: {"bias": np.asarray(p16[k])}})[f"{k}.bias"]
        module.register_parameter(k, torch.nn.Parameter(t))
        module.get_parameter(k).grad = params_from_jax(
            {k: {"bias": np.asarray(grads[k])}})[f"{k}.bias"]
    opt = TorchAdam(module.parameters(), lr=lr, weight_decay=wd,
                    moment_dtype=torch.bfloat16)
    opt.step(salt=int(_key_salt(key)))
    for k in shapes:
        p = module.get_parameter(k)
        assert p.dtype == torch.bfloat16
        assert _ulps(p, want[k]) <= 1, k
        np.testing.assert_array_equal(_bits(opt.state[p]["exp_avg"]),
                                      _bits(jst.mu[k]))
        np.testing.assert_array_equal(_bits(opt.state[p]["exp_avg_sq"]),
                                      _bits(jst.nu[k]))
    with pytest.raises(ValueError, match="salt"):
        opt.step()


def test_bf16_master_training_converges(data):
    cfg = get_config("flagship", epochs=4, batch_size=BATCH,
                     compute_dtype="bfloat16", adam_moment_dtype="bfloat16",
                     master_dtype="bfloat16")
    trainer = Trainer(cfg, data[0], data[0], device="cpu")
    state = trainer.init_state()
    assert all(p.dtype == torch.bfloat16 for p in state.model.parameters())
    assert trainer.compute_copy(state.model) is None
    losses = []
    for e in range(cfg.epochs):
        state, m = trainer.train_epoch(state, e)
        losses.append(m["train_loss"])
    assert all(np.isfinite(v) for v in losses), losses
    assert losses[-1] < losses[0] * 0.9, losses
    assert all(p.dtype == torch.bfloat16 for p in state.model.parameters())
    assert np.isfinite(trainer.evaluate(state)["val_mse"])


@pytest.mark.parametrize("kw", [dict(master_dtype="bfloat16"),
                                dict(master_dtype="bfloat16",
                                     compute_dtype="bfloat16",
                                     adam_factored_v=True)])
def test_invalid_bf16_master_combinations_raise(data, kw):
    with pytest.raises(ValueError, match="master_dtype"):
        Trainer(get_config("flagship", **kw), data[0], device="cpu")


# ---------------------------------------------------------------------------
# 8. the factored second moment (step 6)
# ---------------------------------------------------------------------------

def test_factored_v_matches_reference():
    """``adam_factored_v``'s update on a 2-D leaf past the size threshold
    (lowered to 100 here), with a 1-D leaf below it, against the
    reference's ``torch_adam(factored_v_min_size=100)``: 3 steps, the
    parameters to rtol 1e-6, and the state carried back as the
    reference's ``(r, c)`` pair to rtol 1e-6."""
    rng = np.random.default_rng(4)
    layer = TorchLinear(16, 12)
    kernel = rng.standard_normal((16, 12)).astype(np.float32)
    bias = rng.standard_normal(12).astype(np.float32)
    tree = {"kernel": kernel, "bias": bias}
    layer.load_state_dict(params_from_jax(tree))
    tx = torch_adam(1e-2, weight_decay=1e-3, factored_v_min_size=100)
    jp, jst = tree, tx.init(tree)
    opt = TorchAdam(layer.parameters(), lr=1e-2, weight_decay=1e-3,
                    factored_v_min_size=100)
    for _ in range(3):
        g = {"kernel": rng.standard_normal((16, 12)).astype(np.float32),
             "bias": rng.standard_normal(12).astype(np.float32)}
        upd, jst = tx.update(g, jst, jp)
        jp = jax.device_get(jax.tree_util.tree_map(lambda a, u: a + u, jp,
                                                   upd))
        for name, t in params_from_jax(g).items():
            layer.get_parameter(name).grad = t
        opt.step()
    want = params_from_jax(jp)
    for name, p in layer.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=name)
    assert "exp_avg_sq" not in opt.state[layer.weight]
    back = adam_state_to_jax(layer, opt)
    r, c = back["nu"]["kernel"]
    np.testing.assert_allclose(r, np.asarray(jst.nu["kernel"][0]), rtol=1e-6)
    np.testing.assert_allclose(c, np.asarray(jst.nu["kernel"][1]), rtol=1e-6)
    carried = adam_state_from_jax(jax.device_get(jst), layer, opt)
    np.testing.assert_array_equal(
        carried["state"][0]["exp_avg_sq_col"].numpy(),
        np.asarray(jst.nu["kernel"][0]))


def test_factored_v_trainer_factors_only_fc1(data):
    """With ``adam_factored_v`` the trainer keeps row and column factors
    for the one parameter of at least 2**20 elements (the CNN fc1 weight)
    and a full second moment for every other; the epoch's loss is
    finite."""
    ds, _ = data
    cfg = get_config("flagship", batch_size=BATCH, adam_factored_v=True)
    trainer = Trainer(cfg, ds, device="cpu")
    state, m = trainer.train_epoch(trainer.init_state(), 0)
    assert np.isfinite(m["train_loss"])
    factored = [n for n, p in state.model.named_parameters()
                if "exp_avg_sq_row" in state.optimizer.state[p]]
    assert factored == ["cnn.fc1.weight"]
    st = state.optimizer.state[state.model.cnn.fc1.weight]
    assert st["exp_avg_sq_row"].shape == (256,)
    assert st["exp_avg_sq_col"].shape == (1024 * 128,)
