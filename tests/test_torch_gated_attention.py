"""EGT's gated attention kernels (``csrc/gated_attention.cu``) and their
plain twins (``ops/biased_attention.py``).

On the CPU: the plain twins of the forward kernel (out, ``H^`` and the two
row statistics) and of the backward kernel (the probabilities and gates
recomputed from ``lse``, one row sum ``D = rowsum(dO * out)`` for the
softmax and the scaler) against autograd through the explicit
``GatedAttention`` in f64, to 1e-12, on cases that each reach one rule:
padded keys, a molecule with no valid key, logits on both sides of the clip
and one at it, ``fixed`` 0 and 4, a keep-mask (at p = 0.5, whose ``1 / (1
- p)`` f32 holds exactly), and ``H^``'s gradient absent (the last layer);
a ``gradcheck`` of the kernel path's ``autograd.Function``; the support
check's limits; the kernel wrappers returning the plain twins on CPU
tensors without counting a launch; and the CPU taking the explicit path.

On the card (marked ``card``; they skip without CUDA): the kernels against
the plain twins and the explicit path in bf16 at ``egt_110m.train``'s
shape (B = 128, H = 32, N = 84, d = 24) and at small ragged ones, two
launches giving the same bits, the grad-free forward, and one training
step of a small bf16 ``EGTNet`` through the kernels against the explicit
path.  This file imports no JAX, so on the card it runs without the
suite's ``conftest.py``::

    python3 -m pytest --noconftest -q tests/test_torch_gated_attention.py
"""

import pytest
import torch

from mgat_graphsage_torch.ops import biased_attention as ba


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _case(b, h, n, d, seed=0, dtype=torch.float64, device="cpu",
          lonely=False, wide=False):
    """q, k, v, E, G, key_mask, keep: molecules padded to n (the first
    full), with ``lonely`` the last one with no valid key, with ``wide``
    logits spread past the clip on both sides (and one exactly at 5)."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, h, n, d, generator=g, dtype=torch.float64)
               for _ in range(3))
    if wide:
        q, k = q * 3, k * 3
        q[0, 0, 1], k[0, 0, 2] = 0.0, 0.0
        q[0, 0, 1, 0], k[0, 0, 2, 0] = 5.0 * d ** 0.5, 1.0
    bias, gate = (torch.randn(b, h, n, n, generator=g, dtype=torch.float64)
                  for _ in range(2))
    sizes = torch.randint(1, n + 1, (b,), generator=g)
    sizes[0] = n
    if lonely:
        sizes[-1] = 0
    key_mask = torch.arange(n)[None, :] < sizes[:, None]
    keep = torch.rand(b, h, n, n, generator=g) >= 0.5
    out = [t.to(dtype) for t in (q, k, v, bias, gate)] + [key_mask, keep]
    return [t.to(device) for t in out]


CASES = [pytest.param(3, 2, 9, 4, False, False, 0, True, True, id="padded"),
         pytest.param(2, 2, 7, 4, True, False, 0, False, True,
                      id="no-valid-key-row"),
         pytest.param(2, 2, 7, 4, True, False, 0, True, False,
                      id="no-valid-key-row-no-hh-grad"),
         pytest.param(2, 3, 6, 4, False, True, 0, False, True, id="clip"),
         pytest.param(2, 2, 8, 8, False, False, 4, True, True, id="fixed-4"),
         pytest.param(3, 2, 9, 4, True, True, 4, True, False,
                      id="no-hh-grad")]


@pytest.mark.parametrize("b,h,n,d,lonely,wide,fixed,dropout,use_hh", CASES)
def test_plain_twins_match_autograd(b, h, n, d, lonely, wide, fixed,
                                    dropout, use_hh):
    """The plain forward and backward twins against autograd through the
    explicit path in f64: every output and gradient to 1e-12 of its norm;
    ``H^`` on every slot, padded keys' included; a molecule with no valid
    key reads 0 and passes back only ``H^``'s gradient."""
    q, k, v, bias, gate, key_mask, keep = _case(b, h, n, d, lonely=lonely,
                                                wide=wide)
    keep, p = (keep, 0.5) if dropout else (None, 0.0)
    scale = d ** -0.5
    gen = torch.Generator().manual_seed(1)
    cot = torch.randn(b, h, n, d, generator=gen, dtype=torch.float64)
    hcot = torch.randn(b, h, n, n, generator=gen, dtype=torch.float64) \
        if use_hh else None
    if wide:
        s = torch.matmul(q, k.transpose(-1, -2)) * scale
        assert (s > 5).any() and (s < -5).any() and (s == 5.0).any()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias, gate)]
    out, hh = ba.GatedAttention.apply(*leaves, key_mask, keep, p, scale, 5.0,
                                      fixed)
    ((out * cot).sum() + ((hh * hcot).sum() if use_hh else 0.0)).backward()
    want = [out.detach(), hh.detach()] + [t.grad for t in leaves]
    o, h2, lse, gsum = ba.gated_attention_fwd_plain(
        q, k, v, bias, gate, key_mask, keep, p, scale, 5.0, fixed)
    grads = ba.gated_attention_bwd_plain(q, k, v, o, cot, hcot, bias, gate,
                                         key_mask, lse, gsum, keep, p, scale,
                                         5.0, fixed)
    names = ("out", "hh", "dq", "dk", "dv", "dE", "dG")
    for name, got, w in zip(names, [o, h2, *grads], want):
        assert got.dtype == torch.float64, name
        assert _rel(got, w) <= 1e-12, (name, _rel(got, w))
    if lonely:
        assert (o[-1] == 0).all() and torch.isinf(lse[-1]).all()
        assert (gsum[-1] == 0).all()
        for name, t in (("dv", grads[2]), ("dG", grads[4])):
            assert (t[-1] == 0).all(), name
        # H^'s gradient alone passes, into E and through the clip into s
        assert torch.equal(grads[3][-1], hcot[-1] if use_hh
                           else torch.zeros_like(grads[3][-1]))
        assert bool((grads[0][-1] != 0).any()) == use_hh


def test_kernel_path_gradcheck_f64():
    """``gradcheck`` of the kernel path's ``autograd.Function`` in f64 on
    the CPU (the plain twins): the backward is the forward's derivative in
    ``q``, ``k``, ``v``, ``E`` and ``G`` for both outputs, with padded
    keys, the scaler's fixed rows and a keep-mask."""
    q, k, v, bias, gate, key_mask, keep = _case(2, 2, 5, 3, seed=3)

    def fn(*leaves):
        return ba.GatedAttentionKernel.apply(*leaves, key_mask, keep, 0.5,
                                             0.5, 5.0, 2)

    leaves = [t.requires_grad_(True) for t in (q, k, v, bias, gate)]
    assert torch.autograd.gradcheck(fn, leaves, eps=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,h,d,dtype,ok", [
    (84, 32, 24, torch.bfloat16, True), (1, 8, 8, torch.bfloat16, True),
    (128, 8, 24, torch.bfloat16, True), (96, 16, 32, torch.bfloat16, True),
    (97, 16, 32, torch.bfloat16, False), (129, 32, 24, torch.bfloat16, False),
    (0, 32, 24, torch.bfloat16, False), (84, 4, 24, torch.bfloat16, False),
    (84, 12, 24, torch.bfloat16, False), (84, 32, 12, torch.bfloat16, False),
    (84, 32, 40, torch.bfloat16, False), (84, 32, 24, torch.float32, False),
    (84, 32, 24, torch.float16, False)])
def test_gated_kernels_support_limits(n, h, d, dtype, ok):
    """The kernels take bf16 at N <= 128, d in 8, 16, 24, 32 (not 32 past
    N = 96) and heads a multiple of 8; the explicit path takes the rest
    (and every CPU tensor)."""
    assert ba.gated_kernels_support(n, h, d, dtype) is ok


def test_each_tile_shape_is_its_own_library():
    """``csrc/gated_attention.cu`` builds one tile shape a library: the
    shape's -D macros are in the path's hash, a caller that names no shape
    is refused, and ``build_all`` leaves the source out unless given a
    ``(name, variant)`` pair."""
    from mgat_graphsage_torch.ops import _build

    cell, other = ba._variant(84, 24), ba._variant(37, 16)
    assert cell == (6, 3) and other == (4, 2)
    assert _build.library_path("gated_attention", cell) != \
        _build.library_path("gated_attention", other)
    with pytest.raises(ValueError, match="GATED_KT"):
        _build.library_path("gated_attention")
    assert "gated_attention" not in \
        _build.build_all.__defaults__[0]


def test_cpu_wrappers_return_the_plain_twins():
    """The kernel wrappers on CPU tensors are the plain twins (the
    statistics only when asked for), and count no launch."""
    q, k, v, bias, gate, key_mask, keep = _case(2, 2, 7, 8,
                                                dtype=torch.float32)
    launches = (ba.gated_attention_cuda.launches,
                ba.gated_attention_bwd_cuda.launches)
    got = ba.gated_attention_cuda(q, k, v, bias, gate, key_mask, keep, 0.5,
                                  fixed=2, stats=True)
    want = ba.gated_attention_fwd_plain(q, k, v, bias, gate, key_mask, keep,
                                        0.5, fixed=2)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert ba.gated_attention_cuda(q, k, v, bias, gate, key_mask)[2:] == (
        None, None)
    g, ghh = torch.ones_like(got[0]), torch.ones_like(got[1])
    grads = ba.gated_attention_bwd_cuda(q, k, v, got[0], g, ghh, bias, gate,
                                        key_mask, got[2], got[3], keep, 0.5,
                                        fixed=2)
    want = ba.gated_attention_bwd_plain(q, k, v, got[0], g, ghh, bias, gate,
                                        key_mask, got[2], got[3], keep, 0.5,
                                        fixed=2)
    for a, w in zip(grads, want):
        assert torch.equal(a, w)
    assert launches == (ba.gated_attention_cuda.launches,
                        ba.gated_attention_bwd_cuda.launches)


@pytest.mark.parametrize("grad", [False, True])
def test_cpu_takes_the_explicit_path(grad):
    """On the CPU a bf16 shape the kernels take still runs the explicit
    path: ``explicit`` counts the call, ``kernel`` and the launches do
    not move."""
    q, k, v, bias, gate, key_mask, _ = _case(2, 8, 9, 8,
                                             dtype=torch.bfloat16)
    assert ba.gated_kernels_support(9, 8, 8, torch.bfloat16)
    if grad:
        q.requires_grad_(True)
    before = ba.gated_counts()
    launches = (ba.gated_attention_cuda.launches,
                ba.gated_attention_bwd_cuda.launches)
    out, hh = ba.gated_attention(q, k, v, bias, gate, key_mask, fixed=1)
    assert hh.dtype == torch.float32
    if grad:
        out.float().sum().backward()
    after = ba.gated_counts()
    assert (after["explicit"] - before["explicit"],
            after["kernel"] - before["kernel"]) == (1, 0)
    assert launches == (ba.gated_attention_cuda.launches,
                        ba.gated_attention_bwd_cuda.launches)


# ---- on the card ------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _max_err(got, want) -> float:
    """Largest gap over the largest magnitude of ``want``."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _pair_layout(t):
    """A ``[B, H, N, N]`` tensor as the pair Linears give it: the permuted
    view of a contiguous ``[B, N, N, H]`` one."""
    return t.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)


def _card_case(b, h, n, d, cuda, seed):
    q, k, v, bias, gate, key_mask, keep = _case(
        b, h, n, d, seed=seed, dtype=torch.bfloat16, device=cuda,
        lonely=True)
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in (q, k, v))
    return q, k, v, _pair_layout(bias), _pair_layout(gate), key_mask, keep


CARD = [pytest.param(128, 32, 84, 24, 0.3, 4, id="cell-b128-h32-n84-d24"),
        pytest.param(3, 8, 37, 16, 0.3, 4, id="n37-d16"),
        pytest.param(2, 16, 21, 24, 0.0, 0, id="n21-d24-no-dropout"),
        pytest.param(2, 8, 1, 8, 0.0, 1, id="n1-d8"),
        pytest.param(2, 8, 94, 32, 0.1, 4, id="n94-d32"),
        pytest.param(2, 8, 128, 24, 0.1, 4, id="n128-d24"),
        pytest.param(3, 8, 99, 8, 0.2, 2, id="n99-d8")]


@pytest.mark.card
@pytest.mark.parametrize("b,h,n,d,p,fixed", CARD)
def test_kernels_match_plain_on_the_card(cuda, b, h, n, d, p, fixed):
    """Forward and backward kernels against the plain twins on the card,
    bf16 in and out, padded molecules and one with no valid key: ``out``,
    ``H^`` and the five gradients within 1e-2 of each output's largest
    magnitude (a bf16 ulp is 2^-8 of a value; the two sum the products in
    other orders, so a probability or dS may round to the neighbouring
    bf16 before its product), ``lse`` and the gate sums within 1e-5 (f32
    sums in other orders, ``expf`` against torch's ``exp``); and against
    the explicit path (f32 ``H^``, which rounds the logits to bf16 before
    the clip and ``o`` before the scaler) within 2^-6 of each norm."""
    q, k, v, bias, gate, key_mask, keep = _card_case(b, h, n, d, cuda, n + d)
    keep = keep if p else None
    gen = torch.Generator(cuda).manual_seed(1)
    g = torch.randn(b, h, n, d, device=cuda, generator=gen).bfloat16()
    ghh = _pair_layout(torch.randn(b, h, n, n, device=cuda,
                                   generator=gen).bfloat16())
    out, hh, lse, gsum = ba.gated_attention_cuda(
        q, k, v, bias, gate, key_mask, keep, p, fixed=fixed, stats=True)
    want = ba.gated_attention_fwd_plain(q, k, v, bias, gate, key_mask, keep,
                                        p, fixed=fixed)
    grads = ba.gated_attention_bwd_cuda(q, k, v, out, g, ghh, bias, gate,
                                        key_mask, lse, gsum, keep, p,
                                        fixed=fixed)
    want_g = ba.gated_attention_bwd_plain(q, k, v, out, g, ghh, bias, gate,
                                          key_mask, lse, gsum, keep, p,
                                          fixed=fixed)
    torch.cuda.synchronize()
    assert out.shape == (b, h, n, d) and hh.shape == (b, h, n, n)
    assert hh.permute(0, 2, 3, 1).is_contiguous()
    real = key_mask.any(-1)
    assert _max_err(out, want[0]) <= 1e-2
    assert _max_err(hh, want[1]) <= 1e-2
    assert _max_err(lse[real], want[2][real]) <= 1e-5
    assert torch.isinf(lse[~real]).all() and (out[~real] == 0).all()
    assert _max_err(gsum, want[3]) <= 1e-5
    for name, got, w in zip(("dq", "dk", "dv", "dE", "dG"), grads, want_g):
        assert got.shape == w.shape and got.dtype == torch.bfloat16, name
        assert torch.isfinite(got).all(), name
        assert _max_err(got, w) <= 1e-2, (name, _max_err(got, w))
    assert grads[3].permute(0, 2, 3, 1).is_contiguous()

    leaves = [t.detach().requires_grad_(True)
              for t in (q, k, v, bias, gate)]
    eo, ehh = ba.GatedAttention.apply(*leaves, key_mask, keep, p, d ** -0.5,
                                      5.0, fixed)
    torch.autograd.backward((eo, ehh), (g, ghh.float()))
    for name, got, w in zip(("out", "hh", "dq", "dk", "dv", "dE", "dG"),
                            (out, hh) + grads,
                            [eo, ehh] + [t.grad for t in leaves]):
        assert _rel(got, w) <= 2.0 ** -6, (name, _rel(got, w))


@pytest.mark.card
def test_kernels_repeat_bit_for_bit(cuda):
    """No atomics and fixed orders: two launches on the same inputs give
    the same bits, forward and backward, with and without ``H^``'s
    gradient."""
    q, k, v, bias, gate, key_mask, keep = _card_case(64, 32, 84, 24, cuda, 5)
    runs = []
    for _ in range(2):
        out, hh, lse, gsum = ba.gated_attention_cuda(
            q, k, v, bias, gate, key_mask, keep, 0.3, fixed=4, stats=True)
        runs.append((out, hh, lse, gsum)
                    + ba.gated_attention_bwd_cuda(q, k, v, out, out, hh, bias,
                                                  gate, key_mask, lse, gsum,
                                                  keep, 0.3, fixed=4)
                    + ba.gated_attention_bwd_cuda(q, k, v, out, out, None,
                                                  bias, gate, key_mask, lse,
                                                  gsum, keep, 0.3, fixed=4))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.card
def test_grad_free_forward_on_the_card(cuda):
    """Under ``no_grad`` ``gated_attention`` is one forward launch without
    a keep-mask or statistics, counted under ``kernel``; its ``out`` and
    ``H^`` are the training forward's bits without dropout."""
    q, k, v, bias, gate, key_mask, _ = _card_case(16, 32, 84, 24, cuda, 7)
    before = ba.gated_counts()
    launches = (ba.gated_attention_cuda.launches,
                ba.gated_attention_bwd_cuda.launches)
    with torch.no_grad():
        out, hh = ba.gated_attention(q, k, v, bias, gate, key_mask, fixed=4)
    want = ba.gated_attention_cuda(q, k, v, bias, gate, key_mask, fixed=4,
                                   stats=True)
    torch.cuda.synchronize()
    after = ba.gated_counts()
    assert (after["kernel"] - before["kernel"],
            after["explicit"] - before["explicit"]) == (1, 0)
    assert (ba.gated_attention_cuda.launches - launches[0],
            ba.gated_attention_bwd_cuda.launches - launches[1]) == (2, 0)
    assert torch.equal(out, want[0]) and torch.equal(hh, want[1])


@pytest.mark.card
def test_egt_training_step_through_the_kernels(cuda):
    """One training step of a small bf16 ``EGTNet`` (8 heads of 8, the
    preset's clip, virtual nodes and attention dropout) through the
    kernels against the same step on the explicit path (the kernels
    swapped out by the support check): each layer's attention is one
    forward and one backward launch, counted under ``kernel`` and none
    under ``explicit``; the loss within 1e-2 and every parameter's
    gradient within 5e-2 of its norm (bf16 rounds the two paths apart), or
    of the median parameter's for one whose gradient is under a
    thousandth of the median's (the key projection's bias, which the
    softmax cancels but for the clip, reads round-off)."""
    from mgat_graphsage_torch.models.zoo import EGTNet

    torch.manual_seed(0)
    model = EGTNet(dim=64, pair_dim=16, layers=2, heads=8,
                   ffn_dim=64).to(cuda, torch.bfloat16).train()
    b, n = 6, 20
    gen = torch.Generator().manual_seed(3)
    sizes = torch.tensor([20, 12, 5, 1, 9, 17])
    node_mask = (torch.arange(n)[None] < sizes[:, None]).to(cuda,
                                                            torch.bfloat16)
    nodes = torch.randn(b, n, 35, generator=gen).to(cuda, torch.bfloat16)
    spd = torch.randint(-1, 20, (b, n, n), generator=gen).to(cuda,
                                                              torch.int8)
    paths = torch.randint(0, 5, (b, n, n, 5), generator=gen).to(cuda,
                                                                 torch.int8)
    svd = torch.randn(b, n, 16, generator=gen).to(cuda)

    def step():
        model.zero_grad()
        out = model(nodes, node_mask, spd, paths, svd,
                    torch.Generator(cuda).manual_seed(0))
        loss = out.float().square().mean()
        loss.backward()
        torch.cuda.synchronize()
        return float(loss), {k: p.grad.clone()
                             for k, p in model.named_parameters()}

    before = ba.gated_counts()
    launches = (ba.gated_attention_cuda.launches,
                ba.gated_attention_bwd_cuda.launches)
    loss, grads = step()
    after = ba.gated_counts()
    assert (after["kernel"] - before["kernel"],
            after["explicit"] - before["explicit"]) == (2, 0)
    assert (ba.gated_attention_cuda.launches - launches[0],
            ba.gated_attention_bwd_cuda.launches - launches[1]) == (2, 2)
    support = ba.gated_kernels_support
    ba.gated_kernels_support = lambda *a: False
    try:
        want_loss, want = step()
    finally:
        ba.gated_kernels_support = support
    assert ba.gated_counts()["explicit"] - after["explicit"] == 2
    assert abs(loss - want_loss) <= 1e-2 * abs(want_loss)
    norms = {k: float(g.double().norm()) for k, g in want.items()}
    med = sorted(norms.values())[len(norms) // 2]
    for name, g in grads.items():
        gap = float((g.double() - want[name].double()).norm())
        assert gap <= 5e-2 * max(norms[name], med if norms[name] < 1e-3 * med
                                 else 0.0), (name, gap, norms[name], med)
