"""bf16 operands of the port's CNN-branch backward kernels (``ops/cnn.py``,
kernels 4 and 5 under ``compute_dtype="bfloat16"``) against the reference
package's Pallas kernels in interpret mode, against an f32 oracle, and
through the bf16 ``Trainer`` with ``cnn_pallas_bwd=True``, on the CPU.

Inputs come from a numpy seed, at the reference kernels' own gate
(``chain_shapes_supported``: B a multiple of 64, W a multiple of 32).
Tolerances, and why:

- ``dy3``: both sides sum the products in f32 and round the sum once to
  bf16, in different orders.  So an element is within one bf16 ulp, or,
  where the sum cancels so far that its ulp is below the f32 summation
  error, within that error's bound, ``2 H 2^-24 sum_h |dy w|``.  Measured
  at B=64, W=64, H=256: 99.996% of elements equal, 22 of 524,288 apart,
  all inside the bound.
- the chain's six f32 outputs: ``d2`` and ``d1`` are rounded to bf16 on
  both sides, and an f32 sum that lands on the other side of a rounding
  boundary moves its bf16 value by an ulp.  Measured: 2.4e-4 (dw2) of an
  output's largest magnitude, 1.5e-7 for dw3/db3 (no rounded operand);
  limit 2e-3.
- gradients of the bf16 tail against an f32 oracle: the reference's own
  rule (``tests/test_pallas_cnn.py:63-81``), within twice plain autograd's
  bf16 gap plus 2% of the gradient's scale.
- the first two bf16 train steps with ``cnn_pallas_bwd=True`` against the
  JAX ``Trainer`` (both through their kernels' bf16 paths): the losses'
  rtol of ``test_torch_mixed_precision.py`` (2e-3 and 2e-2).

PyTorch runs on one thread here (several test processes share the cores).
"""

import numpy as np
import pytest
import torch
import flax.linen as fnn
import jax
import jax.numpy as jnp
import ml_dtypes

from mgat_graphsage_tpu.data import MolecularDataset as JDataset
from mgat_graphsage_tpu.data.packed import gather_batch
from mgat_graphsage_tpu.ops.pallas_cnn import (
    _dy3_pallas,
    chain_shapes_supported,
    cnn_chain_bwd,
)
from mgat_graphsage_tpu.train import Trainer as JTrainer
from mgat_graphsage_tpu.train import get_config as jget_config

from mgat_graphsage_torch.data import TRAIN_CSV, MolecularDataset, load_csv
from mgat_graphsage_torch.models import CNNNet, Dropout, params_from_jax
from mgat_graphsage_torch.ops import cnn as torch_cnn
from mgat_graphsage_torch.ops.cnn import (
    cnn_chain_bwd_cuda,
    cnn_chain_bwd_plain,
    cnn_tail,
    dy3_cuda,
    dy3_plain,
)
from mgat_graphsage_torch.train import Trainer, get_config

BF16 = ml_dtypes.bfloat16
CHAIN_LIMIT = 2e-3
NAMES = ("dw3", "db3", "dw2", "db2", "dw1", "db1")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a: np.ndarray) -> torch.Tensor:
    """A numpy bf16 (or f32) array as a tensor of the same bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16)
    return t.detach().numpy()


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (next bf16 above |x|, minus |x|)."""
    a = np.abs(x.astype(np.float32))
    up = (a.view(np.int32) + 0x10000).view(np.float32)
    return up - a


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _dy3_inputs(b, w, h, seed):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((b, h)) * 0.01).astype(BF16),
            (rng.standard_normal((w * 128, h)) * 0.01).astype(BF16),
            np.maximum(rng.standard_normal((b, w, 128)), 0).astype(BF16))


@pytest.mark.parametrize("b,w", [(64, 64), (256, 64)])
def test_dy3_bf16_plain_vs_pallas_interpret(b, w):
    """bf16 dy, fc1 and y3: the plain version rounds the f32 sum once to
    bf16, as ``_dy3_kernel`` does; see the module docstring for the
    tolerance."""
    assert chain_shapes_supported(b, w)
    h = 256
    dy, fk, y3 = _dy3_inputs(b, w, h, seed=b + w)
    ref = np.asarray(_dy3_pallas(jnp.asarray(dy), jnp.asarray(fk),
                                 jnp.asarray(y3), True))
    assert ref.dtype == BF16
    args = (_t(dy), _t(fk.T), _t(y3))
    ours = dy3_plain(*args)
    assert ours.dtype == torch.bfloat16 and ours.shape == (b, w, 128)
    got = _np(ours).astype(np.float64)
    want = ref.astype(np.float64)
    gap = np.abs(got - want)
    one_ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    terms = np.abs(dy.astype(np.float64)) @ np.abs(fk.astype(np.float64)).T
    f32_bound = 2 * h * 2.0 ** -24 * terms.reshape(want.shape)
    assert (gap <= np.maximum(one_ulp, f32_bound)).all()
    assert (gap == 0).mean() >= 0.99
    assert (got[y3.astype(np.float32) <= 0] == 0).all()
    # on a CPU tensor the wrapper is its plain version, bit for bit
    assert torch.equal(dy3_cuda(*args).view(torch.int16),
                       ours.view(torch.int16))


def _chain_inputs(b, w, seed):
    rng = np.random.default_rng(seed)
    relu = lambda s: np.maximum(rng.standard_normal(s), 0)
    dy, fk, y3 = _dy3_inputs(b, w, 256, seed + 1)
    dy3 = np.asarray(_dy3_pallas(jnp.asarray(dy), jnp.asarray(fk),
                                 jnp.asarray(y3), True))
    return dict(dy3=dy3, y2=relu((b, w, 64)).astype(BF16),
                y1=relu((b, w, 32)).astype(BF16),
                fp=(rng.uniform(size=(b, w)) > 0.8).astype(BF16),
                k3=(rng.standard_normal((3, 64, 128)) * 0.05).astype(BF16),
                k2=(rng.standard_normal((3, 32, 64)) * 0.1).astype(BF16))


@pytest.mark.parametrize("b,w", [(64, 64), (64, 96)])
def test_chain_bwd_bf16_plain_vs_pallas_interpret(b, w):
    """bf16 windows and weights, f32 sums and outputs, d2 and d1 rounded
    to bf16 before their masks on both sides (the port's activations NCW
    and weights [out, in, 3], the reference's NWC and [3, in, out])."""
    a = _chain_inputs(b, w, seed=w)
    ref = cnn_chain_bwd(*(jnp.asarray(a[k]) for k in
                          ("dy3", "y2", "y1", "fp", "k3", "k2")), True)
    args = (_t(a["dy3"]), _t(a["y2"].transpose(0, 2, 1)),
            _t(a["y1"].transpose(0, 2, 1)), _t(a["fp"]),
            _t(a["k3"].transpose(2, 1, 0)), _t(a["k2"].transpose(2, 1, 0)))
    ours = cnn_chain_bwd_plain(*args)
    for name, o, r in zip(NAMES, ours, ref):
        r = np.asarray(r)
        if r.ndim == 3:
            r = r.transpose(2, 1, 0)
        assert o.dtype == torch.float32 and o.shape == r.shape, name
        assert _rel(_np(o), r) < CHAIN_LIMIT, (name, _rel(_np(o), r))
    for o, p in zip(cnn_chain_bwd_cuda(*args), ours):
        assert torch.equal(o, p)


def test_chain_bwd_bf16_rounds_the_dgrads():
    """The plain bf16 chain is the f32 chain on the bf16 values except for
    d2 and d1, which it rounds: so dw3 and db3 agree with the f32 chain to
    f32 noise, and the other four differ from it."""
    a = _chain_inputs(64, 64, seed=3)
    args = (_t(a["dy3"]), _t(a["y2"].transpose(0, 2, 1)),
            _t(a["y1"].transpose(0, 2, 1)), _t(a["fp"]),
            _t(a["k3"].transpose(2, 1, 0)), _t(a["k2"].transpose(2, 1, 0)))
    bf = cnn_chain_bwd_plain(*args)
    f32 = cnn_chain_bwd_plain(*(t.float() for t in args))
    for name, x, y in zip(NAMES, bf, f32):
        if name in ("dw3", "db3"):
            assert _rel(_np(x), _np(y)) < 1e-6, name
        else:
            assert not torch.equal(x, y), name


@pytest.mark.parametrize("fn,args", [
    (dy3_plain, lambda: (torch.zeros(2, 8, dtype=torch.bfloat16),
                         torch.zeros(8, 256), torch.zeros(2, 2, 128))),
    (dy3_cuda, lambda: (torch.zeros(2, 8, dtype=torch.float16),
                        torch.zeros(8, 256, dtype=torch.float16),
                        torch.zeros(2, 2, 128, dtype=torch.float16))),
    (cnn_chain_bwd_plain, lambda: (
        torch.zeros(1, 2, 128, dtype=torch.bfloat16),
        torch.zeros(1, 64, 2, dtype=torch.bfloat16),
        torch.zeros(1, 32, 2, dtype=torch.bfloat16),
        torch.zeros(1, 2), torch.zeros(128, 64, 3, dtype=torch.bfloat16),
        torch.zeros(64, 32, 3, dtype=torch.bfloat16))),
    (cnn_chain_bwd_cuda, lambda: (
        torch.zeros(1, 2, 128, dtype=torch.float64),
        torch.zeros(1, 64, 2, dtype=torch.float64),
        torch.zeros(1, 32, 2, dtype=torch.float64),
        torch.zeros(1, 2, dtype=torch.float64),
        torch.zeros(128, 64, 3, dtype=torch.float64),
        torch.zeros(64, 32, 3, dtype=torch.float64))),
])
def test_mixed_or_other_dtypes_raise(fn, args):
    with pytest.raises(TypeError, match="f32 or bf16"):
        fn(*args())


def _tail_args(rng, batch, width, hidden):
    """``cnn_tail``'s arguments in torch layouts, at the reference test's
    scales (``tests/test_pallas_cnn.py::_args``), rounded to bf16."""
    mk = lambda s, sc=1.0: (rng.normal(size=s) * sc).astype(BF16)
    return [mk((batch, width)), mk((32, 1, 3), 0.3), mk((32,), 0.1),
            mk((64, 32, 3), 0.1), mk((64,), 0.1), mk((128, 64, 3), 0.05),
            mk((128,), 0.1), mk((hidden, width * 128), 0.01),
            mk((hidden,), 0.1)]


def _module_out(fp, params):
    """The module path (CNNNet's conv stack, pos-major flatten, fc1) on
    ``params`` = [w1, b1, w2, b2, w3, b3, fc1_w, fc1_b]."""
    x = fp.unsqueeze(1)
    for i in range(3):
        x = torch.relu(torch.nn.functional.conv1d(
            x, params[2 * i], params[2 * i + 1], padding=1))
    return torch.nn.functional.linear(
        x.transpose(1, 2).reshape(x.shape[0], -1), params[6], params[7])


def _tail_grads(fn, params, fp, tgt):
    leaves = [p.clone().requires_grad_(True) for p in params]
    out = fn(fp, leaves).float()
    ((out - tgt) ** 2).sum().backward()
    return [p.grad for p in leaves]


def test_cnn_tail_bf16_grads_meet_the_oracle_rule():
    """The reference's rule (``tests/test_pallas_cnn.py:63-81``) on the
    port: each bf16 gradient of ``cnn_tail`` lies within twice plain
    autograd's own bf16 gap to an f32 oracle, plus 2% of the scale; the
    gradients come back in their parameters' dtype, bf16."""
    rng = np.random.default_rng(1)
    vals = [_t(v) for v in _tail_args(rng, 256, 64, 16)]
    fp, params = vals[0], vals[1:]
    tgt = torch.from_numpy(rng.normal(size=(256, 16)).astype(np.float32))
    oracle = _tail_grads(_module_out, [p.float() for p in params],
                         fp.float(), tgt)
    ad = _tail_grads(_module_out, params, fp, tgt)
    ours = _tail_grads(lambda f, p: cnn_tail(f, *p), params, fp, tgt)
    for i, (o, a, k) in enumerate(zip(oracle, ad, ours)):
        assert k.dtype == torch.bfloat16, i
        scale = o.abs().max().item() + 1e-12
        e_ad = (a.float() - o).abs().max().item()
        e_k = (k.float() - o).abs().max().item()
        assert e_k <= 2.0 * e_ad + 0.02 * scale, (i, e_k, e_ad, scale)


def test_cnnnet_bf16_pallas_route_is_the_module_forward():
    """CNNNet(pallas_bwd=True) in bf16: the module path's forward bit for
    bit, and bf16 gradients on every parameter."""
    torch.manual_seed(0)
    ref = CNNNet(32, 6, fc_hidden=8, dropout=0.0).to(torch.bfloat16)
    fused = CNNNet(32, 6, fc_hidden=8, dropout=0.0,
                   pallas_bwd=True).to(torch.bfloat16)
    fused.load_state_dict(ref.state_dict(), strict=True)
    fp = (torch.rand(5, 32) > 0.6).to(torch.bfloat16)
    a, b = ref(fp), fused(fp)
    assert torch.equal(a, b)
    b.float().square().sum().backward()
    assert all(p.grad is not None and p.grad.dtype == torch.bfloat16
               for p in fused.parameters())


# ---------------------------------------------------------------------------
# the bf16 Trainer with cnn_pallas_bwd=True
# ---------------------------------------------------------------------------

N_MOL = 128
BATCH = 64


@pytest.fixture(scope="module")
def data():
    sm, y = load_csv(TRAIN_CSV)
    ds = MolecularDataset(sm[:N_MOL], y[:N_MOL], fit_scaler=True,
                          verbose=False)
    jds = JDataset(sm[:N_MOL], y[:N_MOL], fit_scaler=True,
                   fingerprint="ecfp1024", verbose=False)
    return ds, jds


class _NoDropout(fnn.Module):
    rate: float = 0.0
    deterministic: bool = True

    @fnn.compact
    def __call__(self, inputs, deterministic=None, rng=None):
        return inputs


def test_bf16_pallas_steps_match_reference_trainer(data, monkeypatch):
    """The first two train steps of the flagship at ``compute_dtype=
    "bfloat16"`` with ``cnn_pallas_bwd=True`` at B=64, in both packages
    from the same weights and batches (the reference's kernels in
    interpret mode; dropout the identity on both sides): losses within
    rtol 2e-3 at step 1 and 2e-2 at step 2; the port's backward went
    through kernels 4-5's wrappers once a step."""
    monkeypatch.setattr(fnn, "Dropout", _NoDropout)
    monkeypatch.setattr(Dropout, "forward", lambda self, x, generator=None: x)
    ds, jds = data
    kw = dict(epochs=1, batch_size=BATCH, compute_dtype="bfloat16",
              cnn_pallas_bwd=True)
    assert chain_shapes_supported(BATCH, 1024)
    jt = JTrainer(jget_config("flagship", **kw), jds)
    jstate = jt.init_state()
    init = jax.device_get(jstate.params)
    jt._build_steps()
    jdata = jt._device_dataset(jds)
    perm, smask = JTrainer._epoch_indices(
        N_MOL, BATCH, np.random.default_rng(jt.cfg.seed))
    jlosses = []
    for i in range(2):
        batch = gather_batch(jdata, jnp.asarray(perm[i]), jds.fp.shape[1])
        batch["sample_mask"] = jnp.asarray(smask[i])
        jstate, m = jt._train_step(jstate, batch, jax.random.PRNGKey(i))
        jlosses.append(float(m["loss"]))

    calls = {"dy3": 0, "chain": 0}

    def spy(key, fn):
        def call(*a):
            calls[key] += 1
            assert all(t.dtype == torch.bfloat16 for t in a)
            return fn(*a)
        return call

    monkeypatch.setattr(torch_cnn, "dy3_cuda", spy("dy3", dy3_cuda))
    monkeypatch.setattr(torch_cnn, "cnn_chain_bwd_cuda",
                        spy("chain", cnn_chain_bwd_cuda))
    pt = Trainer(get_config("flagship", **kw), ds, device="cpu")
    state = pt.init_state()
    state.model.load_state_dict(params_from_jax(init), strict=True)
    copy = pt.compute_copy(state.model)
    batches = pt._batches(ds, BATCH, np.random.default_rng(pt.cfg.seed))
    losses = [float(pt.train_step(state, next(batches), None, copy)["loss"])
              for _ in range(2)]
    assert calls == {"dy3": 2, "chain": 2}
    rel = np.abs(np.array(losses) / np.array(jlosses) - 1)
    assert rel[0] < 2e-3 and rel[1] < 2e-2, (losses, jlosses, rel)


@pytest.mark.parametrize("preset,kw", [
    ("flagship_bf16_bs1024_wc", dict(remat=True)),
    ("flagship_bf16sr", {}),
])
def test_bf16_presets_train_with_cnn_pallas_bwd(data, monkeypatch, preset,
                                                kw):
    """Every bf16 preset trains with ``cnn_pallas_bwd=True`` (no refusal):
    under remat the forward runs twice a step and kernels 4-5 once; the
    bf16 master stays bf16.  Two finite steps at B=32."""
    calls = {"dy3": 0, "chain": 0, "tail": 0}

    def spy(key, fn):
        def call(*a):
            calls[key] += 1
            return fn(*a)
        return call

    monkeypatch.setattr(torch_cnn, "dy3_cuda", spy("dy3", dy3_cuda))
    monkeypatch.setattr(torch_cnn, "cnn_chain_bwd_cuda",
                        spy("chain", cnn_chain_bwd_cuda))
    forward = torch_cnn._CNNTail.forward
    monkeypatch.setattr(torch_cnn._CNNTail, "forward", staticmethod(
        lambda ctx, *a: (calls.__setitem__("tail", calls["tail"] + 1),
                         forward(ctx, *a))[1]))
    ds = data[0]
    cfg = get_config(preset, epochs=1, batch_size=32, cnn_pallas_bwd=True,
                     **kw)
    pt = Trainer(cfg, ds, device="cpu")
    state = pt.init_state()
    copy = pt.compute_copy(state.model)
    gen = pt._dropout_generator(0)
    batches = pt._batches(ds, 32, np.random.default_rng(cfg.seed))
    losses = [float(pt.train_step(state, next(batches), gen, copy)["loss"])
              for _ in range(2)]
    assert np.isfinite(losses).all()
    assert calls == {"dy3": 2, "chain": 2,
                     "tail": 4 if cfg.remat else 2}, calls
    narrow = cfg.master_dtype == "bfloat16"
    assert all((p.dtype == torch.bfloat16) == narrow
               for p in state.model.parameters())


def test_ptxas_report_names_the_storage_type_of_each_instance():
    """The chain kernel is one template on its storage type: the build
    report names both instances apart (``<float>``, ``<bf16>``), beside
    the bf16 dy3 kernel."""
    from mgat_graphsage_torch.ops import _build

    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__8c1f2a"
        "11_16_cnn_chain_bwd_cu_3f0e6a1220cnn_chain_bwd_kernelIfEEvPKT_S3_S3"
        "_S3_S3_S3_Pfiii' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 255 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__8c1f2a"
        "11_16_cnn_chain_bwd_cu_3f0e6a1220cnn_chain_bwd_kernelI13__nv_bfloat"
        "16EEvPKT_S4_S4_S4_S4_S4_Pfiii' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 254 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__0fc71fc8"
        "_10_cnn_dy3_cu_6d91793d19cnn_dy3_bf16_kernelEPK13__nv_bfloat16S2_S2"
        "_PS0_iii' for 'sm_90a'",
        "ptxas info    : Used 126 registers, used 1 barriers"])
    try:
        _build.BUILD_LOGS["probe_bf16"] = log
        assert _build.ptxas_report("probe_bf16") == [
            "cnn_chain_bwd_kernel<float>: 255 registers, 0 bytes spilled",
            "cnn_chain_bwd_kernel<bf16>: 254 registers, 0 bytes spilled",
            "cnn_dy3_bf16_kernel: 126 registers, 0 bytes spilled"]
    finally:
        del _build.BUILD_LOGS["probe_bf16"]


def test_bf16_entry_points_are_declared_beside_the_f32_ones():
    """Each kernel source has its bf16 entry point, with the f32 one's
    arguments, and the f32 entry point is unchanged."""
    import os

    from mgat_graphsage_torch.ops import _build

    for name, symbol in (("cnn_dy3", "cnn_dy3_bf16_launch"),
                         ("cnn_chain_bwd", "cnn_chain_bwd_bf16_launch")):
        src = open(os.path.join(_build.CSRC_DIR, name + ".cu")).read()
        assert f'extern "C" int {symbol}(' in src
        assert f'extern "C" int {_build.KERNELS[name][0]}(' in src
        assert _build.ENTRIES[symbol] == _build.KERNELS[name][1]
