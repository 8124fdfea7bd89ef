"""The port's trainer (``train/trainer.py``), optimizer, schedule,
checkpoints, Adam-state carry-over and CLI, against the reference
package's ``Trainer`` on the CPU.

Setup of the parity runs: the ``flagship`` preset at full width, the first
64 train and 32 validation molecules of the bundled CSVs, batch 32, the
same initial weights (carried over by ``params_from_jax``) and the same
batch order (``np.random.default_rng(seed + epoch)`` on both sides).  The
two packages draw dropout masks from different generators, so dropout is
patched to the identity on both sides, inside the test only.  Tolerances:
rtol 1e-4 on losses and MSEs over 2 epochs (f32 sums in another order,
compounded by 4 Adam steps); gradients to 1e-4 of each parameter's
largest gradient.
"""

import json
import os

import numpy as np
import pytest
import torch
import flax.linen as fnn
import jax
import jax.numpy as jnp

from mgat_graphsage_tpu.data import MolecularDataset as JDataset
from mgat_graphsage_tpu.models.zoo import kl_loss as jkl_loss
from mgat_graphsage_tpu.ops.graph import dense_adjacency as jdense
from mgat_graphsage_tpu.train import Trainer as JTrainer
from mgat_graphsage_tpu.train import get_config as jget_config
from mgat_graphsage_tpu.train.trainer import _lr_schedule, make_optimizer as jmake_optimizer

from mgat_graphsage_torch.data import (
    TRAIN_CSV,
    VAL_CSV,
    MolecularDataset,
    load_csv,
)
from mgat_graphsage_torch.eval import Predictor
from mgat_graphsage_torch.models import (
    Dropout,
    HybridModel,
    adam_state_from_jax,
    adam_state_to_jax,
    kl_loss,
    params_from_jax,
    params_to_jax,
)
from mgat_graphsage_torch.train import (
    Trainer,
    checkpoint_is_light,
    get_config,
    latest_checkpoint,
    lr_schedule,
    make_optimizer,
)
from mgat_graphsage_torch.parallel import make_mesh
from mgat_graphsage_torch.train.optim import set_lr
from mgat_graphsage_torch.train.run import main as run_main

RTOL = 1e-4


@pytest.fixture(scope="module")
def data():
    sm, y = load_csv(TRAIN_CSV)
    vs, vy = load_csv(VAL_CSV)
    tr = MolecularDataset(sm[:64], y[:64], fit_scaler=True, verbose=False)
    va = MolecularDataset(vs[:32], vy[:32], scaler=tr.scaler,
                          max_nodes=tr.max_nodes, max_edges=tr.max_edges,
                          verbose=False)
    jtr = JDataset(sm[:64], y[:64], fit_scaler=True, verbose=False)
    jva = JDataset(vs[:32], vy[:32], scaler=jtr.scaler,
                   max_nodes=jtr.max_nodes, max_edges=jtr.max_edges,
                   verbose=False)
    return tr, va, jtr, jva


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


def _port_state_from_jax(trainer, jstate):
    state = trainer.init_state()
    state.model.load_state_dict(
        params_from_jax(jax.device_get(jstate.params)), strict=True)
    return state


def test_trainer_matches_jax_trainer(data, no_dropout):
    """Per-epoch train loss, val MSE and original-scale MSE over 2 epochs."""
    tr, va, jtr, jva = data
    cfg = dict(epochs=2, batch_size=32)
    jt = JTrainer(jget_config("flagship", **cfg), jtr, jva)
    jstate = jt.init_state()
    pt = Trainer(get_config("flagship", **cfg), tr, va, device="cpu")
    state = _port_state_from_jax(pt, jstate)
    _, _, jhist = jt.fit(state=jstate, verbose=False, save_best=False)
    final, _, hist = pt.fit(state=state, verbose=False, save_best=False)
    assert final.step == 4
    for j, p in zip(jhist, hist):
        for key in ("train_loss", "val_mse", "original_mse"):
            np.testing.assert_allclose(p[key], j[key], rtol=RTOL,
                                       err_msg=f"epoch {j['epoch']} {key}")


def test_one_step_gradients_match_jax(data):
    """Gradients of the full loss (masked MSE + kl_lambda * KL) on the
    padded final batch of epoch 0, per parameter.  The query bias's
    gradient is zero by construction (the softmax over keys does not see
    it) and only rounding noise is left, so each parameter's scale is
    floored at 1e-5 of the largest gradient of the model."""
    tr, va, jtr, _ = data
    cfg = get_config("flagship", batch_size=48)
    jt = JTrainer(jget_config("flagship", batch_size=48), jtr)
    params = jax.device_get(jt.init_state().params)
    perm, smask = JTrainer._epoch_indices(64, 48,
                                          np.random.default_rng(cfg.seed))
    idx, sm = perm[1], smask[1]                       # 16 real + 32 padded
    batch = {k: getattr(jtr, k)[idx] for k in
             ("nodes", "edges", "node_mask", "edge_mask", "fp", "y")}

    def jloss(p):
        n = batch["nodes"].shape[1]
        adj = jdense(jnp.asarray(batch["edges"]),
                     jnp.asarray(batch["edge_mask"]), n)
        nm = jnp.asarray(batch["node_mask"]) * jnp.asarray(sm)[:, None]
        pred, latent = jt.model.apply({"params": p}, batch["nodes"], adj, nm,
                                      batch["fp"])
        err = (pred.reshape(-1) - batch["y"]) ** 2
        mse = (err * sm).sum() / max(sm.sum(), 1.0)
        return mse + cfg.kl_lambda * jkl_loss(latent, jnp.asarray(sm))

    jgrads = params_from_jax(jax.device_get(jax.grad(jloss)(params)))
    pt = Trainer(cfg, tr, device="cpu")
    state = pt.init_state()
    state.model.load_state_dict(params_from_jax(params))
    state.model.eval()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["sample_mask"] = torch.from_numpy(sm)
    pred, latent = pt._forward(state.model, tb)
    err = (pred.reshape(-1) - tb["y"]) ** 2
    mse = (err * tb["sample_mask"]).sum() / tb["sample_mask"].sum()
    (mse + cfg.kl_lambda * kl_loss(latent, tb["sample_mask"])).backward()
    top = max(float(np.abs(g.numpy()).max()) for g in jgrads.values())
    for name, p in state.model.named_parameters():
        want = jgrads[name].numpy()
        err = np.abs(p.grad.numpy() - want).max()
        assert err <= 1e-4 * max(np.abs(want).max(), 1e-5 * top), (name, err)


@pytest.mark.parametrize("schedule", ["constant", "warmup_cosine"])
def test_schedule_and_adam_match_jax(schedule):
    """The lr at every 1-based step, and three Adam + L2 steps under it."""
    kw = dict(lr=2e-3, weight_decay=1e-2, lr_schedule=schedule,
              warmup_steps=3, lr_final_ratio=0.1)
    total = 8
    jsched = _lr_schedule(jget_config("flagship", **kw), total)
    sched = lr_schedule(get_config("flagship", **kw), total)
    if schedule == "constant":
        assert sched == jsched == 2e-3
    else:
        for c in range(1, total + 3):
            np.testing.assert_allclose(sched(c), float(jsched(np.float32(c))),
                                       rtol=1e-6)

    rng = np.random.default_rng(0)
    shapes = {"a": (4, 3), "b": (5,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    tx = jmake_optimizer(jget_config("flagship", **kw), total)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jst = tx.init(jp)
    for g in grads:
        upd, jst = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jst,
                             jp)
        jp = jax.tree_util.tree_map(lambda a, u: a + u, jp, upd)

    module = torch.nn.Module()
    for k, v in p0.items():
        module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v)))
    opt = make_optimizer(get_config("flagship", **kw), module)
    for step, g in enumerate(grads):
        for k, v in g.items():
            getattr(module, k).grad = torch.from_numpy(v)
        set_lr(opt, sched(step + 1) if callable(sched) else sched)
        opt.step()
    for k in shapes:
        np.testing.assert_allclose(getattr(module, k).detach().numpy(),
                                   np.asarray(jp[k]), rtol=1e-5, atol=1e-7)


def _small_pair():
    from mgat_graphsage_tpu.models import zoo as jzoo

    kw = dict(fp_dim=64, cnn_fc_hidden=16, combined_hidden=32)
    jm = jzoo.HybridModel(**kw)
    n, e = 12, 24
    params = jax.device_get(jm.init(
        jax.random.PRNGKey(0), jnp.zeros((2, n, 35)), jnp.zeros((2, n, n)),
        jnp.ones((2, n)), jnp.zeros((2, 64)))["params"])
    return params, HybridModel(**kw)


def test_adam_state_carries_over_both_ways():
    """Two Adam steps in JAX, the state carried to the port, one more step
    on both sides: same parameters and moments; and back again."""
    params, model = _small_pair()
    cfg = jget_config("flagship")
    tx = jmake_optimizer(cfg)
    rng = np.random.default_rng(1)
    grads = [jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
        for _ in range(3)]
    jp, jst = params, tx.init(params)
    update = jax.jit(tx.update)
    states = []
    for g in grads:
        upd, jst = update(g, jst, jp)
        jp = jax.device_get(jax.tree_util.tree_map(lambda a, u: a + u, jp,
                                                   upd))
        states.append((jp, jax.device_get(jst)))

    (p2, s2), (p3, s3) = states[1], states[2]
    model.load_state_dict(params_from_jax(p2))
    opt = make_optimizer(get_config("flagship"), model)
    opt.load_state_dict(adam_state_from_jax(s2, model, opt))
    for name, g in params_from_jax(grads[2]).items():
        model.get_parameter(name).grad = g
    opt.step()
    want = params_from_jax(p3)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    back = adam_state_to_jax(model, opt)
    assert int(back["count"]) == int(s3.count) == 3
    for port_tree, jax_tree in ((back["mu"], s3.mu), (back["nu"], s3.nu),
                                (params_to_jax(model), p3)):
        for (path, a), (_, b) in zip(
                jax.tree_util.tree_flatten_with_path(port_tree)[0],
                jax.tree_util.tree_flatten_with_path(jax_tree)[0]):
            b = np.asarray(b)
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-6 * np.abs(b).max(),
                                       err_msg=str(path))


def test_checkpoints_full_resume_light_and_serving(data, tmp_path):
    """The best checkpoint is full and serves through Predictor with the
    trainer's own predictions; a run resumed from a full checkpoint
    repeats an uninterrupted one (dropout on); a light checkpoint holds
    the weights and no optimizer state."""
    tr, va, _, _ = data
    cfg = get_config("flagship", epochs=2, batch_size=32)
    whole = Trainer(cfg, tr, va, device="cpu", ckpt_dir=str(tmp_path / "a"))
    _, best, hist = whole.fit(verbose=False)
    ckpt = str(tmp_path / "a" / "best_model.pt")
    assert os.path.exists(ckpt) and not checkpoint_is_light(ckpt)
    meta = json.load(open(ckpt + ".json"))
    assert meta["config"]["name"] == "flagship" and meta["scaler"]["scale"] > 0
    served = Predictor(ckpt, device="cpu")(va.smiles)
    np.testing.assert_allclose(served, whole.evaluate(best)["pred_denorm"],
                               rtol=0, atol=1e-5)

    first = Trainer(cfg.replace(epochs=1), tr, va, device="cpu")
    state, _, _ = first.fit(verbose=False, save_best=False)
    full = str(tmp_path / "ckpt_2.pt")
    first.save(full, state, {"epoch": 1})
    second = Trainer(cfg, tr, va, device="cpu")
    resumed, meta = second.load(full)
    assert resumed.step == 2 and meta["epoch"] == 1
    assert len(resumed.optimizer.state) == len(list(
        resumed.model.parameters()))
    _, _, rest = second.fit(state=resumed, start_epoch=1, verbose=False,
                            save_best=False)
    for key in ("train_loss", "val_mse", "original_mse"):
        assert rest[0][key] == hist[1][key], key

    light = str(tmp_path / "ckpt_10.pt")
    first.save(light, state, light=True)
    assert checkpoint_is_light(light)
    assert latest_checkpoint(str(tmp_path)) == light
    restored, _ = first.load(light)
    assert restored.step == 2 and not restored.optimizer.state
    for a, b in zip(restored.model.parameters(), state.model.parameters()):
        assert torch.equal(a, b)


def test_same_seed_same_trajectory_other_seed_differs(data):
    tr, va, _, _ = data

    def run(seed):
        cfg = get_config("flagship", epochs=1, batch_size=32, seed=seed)
        state, _, hist = Trainer(cfg, tr, va, device="cpu").fit(
            verbose=False, save_best=False)
        return hist[0], state.model.combined.fc2.weight.detach().clone()

    (h1, w1), (h2, w2), (h3, w3) = run(42), run(42), run(43)
    assert h1["train_loss"] == h2["train_loss"] and torch.equal(w1, w2)
    assert h1["train_loss"] != h3["train_loss"] and not torch.equal(w1, w3)


def test_f32_train_step_holds_ieee_convolutions_in_backward(data):
    """TF32 stays off while the convolutions' gradients are computed, and
    the caller's setting is restored after the step."""
    tr, _, _, _ = data
    pt = Trainer(get_config("flagship", batch_size=16), tr, device="cpu")
    state = pt.init_state()
    seen = []
    for p in (state.model.cnn.conv1.weight, state.model.cnn.conv3.weight):
        p.register_hook(lambda g: seen.append(
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)) or g)
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        batch = next(pt._batches(tr, 16))
        pt.train_step(state, batch)
        after = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
    assert seen == [(False, False)] * 2
    assert after == (True, True)


def test_cli_limit_smoke(tmp_path, capsys):
    ckpt_dir, log = tmp_path / "ck", tmp_path / "log.jsonl"
    run_main(["--preset", "flagship", "--limit", "40", "--epochs", "1",
              "--batch-size", "16", "--device", "cpu", "--ckpt-dir",
              str(ckpt_dir), "--log", str(log)])
    out = capsys.readouterr().out
    assert "Epoch    1" in out and "Training completed" in out
    assert os.path.exists(ckpt_dir / "flagship" / "best_model.pt")
    rows = [json.loads(line) for line in open(log)]
    assert len(rows) == 1 and np.isfinite(rows[0]["train_loss"])


def test_not_ported_configs_and_flags_raise(data, monkeypatch):
    tr, va, _, _ = data
    # meshes are ported: what is refused is a mesh that cannot be made,
    # before any featurisation (one process, no process group)
    with pytest.raises(ValueError, match="not divisible by model_parallel"):
        Trainer(get_config("flagship"), tr, va, device="cpu",
                mesh=make_mesh(model_parallel=2))
    for flag, match in ((["--model-parallel", "2"], "not divisible"),
                        (["--distributed"], "coordinator")):
        with pytest.raises(ValueError, match=match):
            run_main(["--device", "cpu"] + flag)
    # every preset is offered, the fingerprint suite's included
    with pytest.raises(SystemExit) as e:
        run_main(["--preset", "maccs", "--help"])
    assert e.value.code == 0
    # no CUDA and no device given: the entry points raise, no CPU fallback
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(get_config("flagship"), tr, va)
