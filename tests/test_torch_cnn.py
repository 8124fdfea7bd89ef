"""The port's fused CNN-branch backward (``ops/cnn.py``) against the
reference package's Pallas kernels in interpret mode and against plain
autograd, on the CPU.

Inputs come from a numpy seed.  Tolerances: f32, relative to each
output's largest magnitude; 1e-5 for ``dy3`` (sums of H terms) and 1e-4
for the weight gradients (sums over B * W positions).  The CUDA kernels
are held against these plain versions on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mgat_graphsage_tpu.ops.pallas_cnn import _dy3_pallas, cnn_chain_bwd
from mgat_graphsage_tpu.ops.pallas_cnn import cnn_tail as jax_cnn_tail

from mgat_graphsage_torch.models import CNNNet
from mgat_graphsage_torch.ops.cnn import (
    cnn_chain_bwd_cuda,
    cnn_chain_bwd_plain,
    cnn_tail,
    dy3_cuda,
    dy3_plain,
)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _chain_inputs(b, w, seed):
    """Post-ReLU activations (about half zero), a 0/1 fingerprint, and
    weights at the scale of the branch's init."""
    rng = np.random.default_rng(seed)
    relu = lambda s: np.maximum(rng.standard_normal(s), 0).astype(np.float32)
    return dict(dy3=rng.standard_normal((b, w, 128)).astype(np.float32)
                * (relu((b, w, 128)) > 0),
                y2=relu((b, w, 64)), y1=relu((b, w, 32)),
                fp=(rng.uniform(size=(b, w)) > 0.8).astype(np.float32),
                k3=(rng.standard_normal((3, 64, 128)) * 0.05).astype(np.float32),
                k2=(rng.standard_normal((3, 32, 64)) * 0.1).astype(np.float32))


@pytest.mark.parametrize("width", [64, 96])
def test_dy3_plain_vs_pallas_interpret(width):
    rng = np.random.default_rng(width)
    b, h = 64, 16
    dy = rng.standard_normal((b, h)).astype(np.float32)
    fk = (rng.standard_normal((width * 128, h)) * 0.05).astype(np.float32)
    y3 = np.maximum(rng.standard_normal((b, width, 128)), 0).astype(np.float32)
    ref = np.asarray(_dy3_pallas(jnp.asarray(dy), jnp.asarray(fk),
                                 jnp.asarray(y3), True))
    # the port keeps fc1 in torch's layout: weight [H, W*C] = kernel.T
    args = (torch.from_numpy(dy), torch.from_numpy(np.ascontiguousarray(fk.T)),
            torch.from_numpy(y3))
    ours = dy3_plain(*args).numpy()
    assert ours.shape == (b, width, 128)
    assert _rel(ours, ref) < 1e-5
    np.testing.assert_array_equal(ours[y3 <= 0], 0.0)
    np.testing.assert_array_equal(dy3_cuda(*args).numpy(), ours)


@pytest.mark.parametrize("width", [64, 96])
def test_chain_bwd_plain_vs_pallas_interpret(width):
    """B=64 at W=64 (all edge tiles at the reference's 32-wide tiling) and
    W=96 (an interior tile); the port's activations are NCW and its
    weights [out, in, 3], the reference's NWC and [3, in, out]."""
    a = _chain_inputs(64, width, seed=width + 1)
    ref = cnn_chain_bwd(*(jnp.asarray(a[k]) for k in
                          ("dy3", "y2", "y1", "fp", "k3", "k2")), True)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    args = (t(a["dy3"]), t(a["y2"].transpose(0, 2, 1)),
            t(a["y1"].transpose(0, 2, 1)), t(a["fp"]),
            t(a["k3"].transpose(2, 1, 0)), t(a["k2"].transpose(2, 1, 0)))
    ours = cnn_chain_bwd_plain(*args)
    names = ("dw3", "db3", "dw2", "db2", "dw1", "db1")
    for name, o, r in zip(names, ours, ref):
        r = np.asarray(r)
        if r.ndim == 3:                     # [3, in, out] -> [out, in, 3]
            r = r.transpose(2, 1, 0)
        assert o.shape == r.shape, name
        assert _rel(o.numpy(), r) < 1e-4, (name, _rel(o.numpy(), r))
    for o, w in zip(cnn_chain_bwd_cuda(*args), ours):
        np.testing.assert_array_equal(o.numpy(), w.numpy())


def _tail_params(rng, width, hidden):
    mk = lambda s, sc: (rng.standard_normal(s) * sc).astype(np.float32)
    return dict(w1=mk((32, 1, 3), 0.3), b1=mk((32,), 0.1),
                w2=mk((64, 32, 3), 0.1), b2=mk((64,), 0.1),
                w3=mk((128, 64, 3), 0.05), b3=mk((128,), 0.1),
                fc1_w=mk((hidden, width * 128), 0.01), fc1_b=mk((hidden,), 0.1))


def test_cnn_tail_grads_match_jax_and_autograd():
    """The port's cnn_tail: forward bitwise equal to the module path;
    parameter gradients against the reference's cnn_tail (Pallas backward
    in interpret mode) and against plain autograd of the module path."""
    rng = np.random.default_rng(5)
    b, width, hidden = 64, 64, 16
    fp = (rng.uniform(size=(b, width)) > 0.7).astype(np.float32)
    p = _tail_params(rng, width, hidden)
    g = rng.standard_normal((b, hidden)).astype(np.float32)

    leaves = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    order = ("w1", "b1", "w2", "b2", "w3", "b3", "fc1_w", "fc1_b")
    out = cnn_tail(torch.from_numpy(fp), *(leaves[k] for k in order))
    out.backward(torch.from_numpy(g))

    net = CNNNet(width, 4, fc_hidden=hidden)
    with torch.no_grad():
        for mod, (wk, bk) in zip((net.conv1, net.conv2, net.conv3, net.fc1),
                                 (("w1", "b1"), ("w2", "b2"), ("w3", "b3"),
                                  ("fc1_w", "fc1_b"))):
            mod.weight.copy_(torch.from_numpy(p[wk]))
            mod.bias.copy_(torch.from_numpy(p[bk]))
    x = torch.from_numpy(fp).unsqueeze(1)
    for conv in (net.conv1, net.conv2, net.conv3):
        x = torch.relu(conv(x))
    mod_out = net.fc1(x.transpose(1, 2).reshape(b, -1))
    np.testing.assert_array_equal(out.detach().numpy(),
                                  mod_out.detach().numpy())
    mod_out.backward(torch.from_numpy(g))
    mod_grads = dict(zip(order, (net.conv1.weight.grad, net.conv1.bias.grad,
                                 net.conv2.weight.grad, net.conv2.bias.grad,
                                 net.conv3.weight.grad, net.conv3.bias.grad,
                                 net.fc1.weight.grad, net.fc1.bias.grad)))

    # the reference: conv kernels [3, in, out], fc1 kernel [W*C, H]
    jp = [jnp.asarray(fp)]
    for k in order:
        v = p[k]
        jp.append(jnp.asarray(v.transpose(2, 1, 0) if v.ndim == 3
                              else v.T if v.ndim == 2 else v))
    _, vjp = jax.vjp(lambda *a: jax_cnn_tail(*a, True), *jp)
    ref = vjp(jnp.asarray(g))[1:]
    for k, r in zip(order, ref):
        r = np.asarray(r)
        r = r.transpose(2, 1, 0) if r.ndim == 3 else r.T if r.ndim == 2 else r
        ours = leaves[k].grad.numpy()
        assert _rel(ours, r) < 1e-4, (k, _rel(ours, r))
        assert _rel(ours, mod_grads[k].numpy()) < 1e-4, k


def test_cnn_tail_refuses_a_fingerprint_gradient():
    """No silent zeros for the fingerprint: the route raises."""
    rng = np.random.default_rng(0)
    p = {k: torch.from_numpy(v) for k, v in _tail_params(rng, 8, 4).items()}
    fp = torch.zeros(2, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="fingerprint"):
        cnn_tail(fp, *p.values())
    with torch.no_grad():
        assert cnn_tail(fp, *p.values()).shape == (2, 4)


def test_cnnnet_pallas_bwd_route_matches_module_path():
    """CNNNet(pallas_bwd=True): same parameters and state_dict keys, same
    forward bit for bit, gradients within f32 noise of the module path."""
    torch.manual_seed(0)
    ref = CNNNet(32, 6, fc_hidden=8, dropout=0.0)
    fused = CNNNet(32, 6, fc_hidden=8, dropout=0.0, pallas_bwd=True)
    fused.load_state_dict(ref.state_dict(), strict=True)
    fp = (torch.rand(5, 32) > 0.6).float()
    a, b = ref(fp), fused(fp)
    np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())
    a.square().sum().backward()
    b.square().sum().backward()
    for (n, pa), pb in zip(ref.named_parameters(), fused.parameters()):
        assert _rel(pb.grad.numpy(), pa.grad.numpy()) < 1e-5, n
