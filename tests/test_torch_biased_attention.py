"""The graph transformer's attention kernel (``csrc/biased_attention.cu``)
and its plain version (``ops/biased_attention.py``).

On the CPU: the plain version of the kernel's algorithm (the probabilities
recomputed from the forward's log-sum-exp, ``D = rowsum(dO * out)``)
against the explicit path, with and without a keep-mask, at N not a
multiple of 16, with padded keys and a row whose only valid key is the
graph token; a ``gradcheck`` of the kernel path's ``autograd.Function`` in
f64; the support check's limits; and the CPU taking the explicit path.

On the card (marked ``card``; they skip without CUDA): the kernels against
the plain version in bf16 at the training cell's shape (B = 1024, H = 32,
N = 81, d = 24) and at small ones, bit-for-bit repeats, and a training
layer whose attention goes through the kernels; without a bias
(``bias=None``, GraphGPS's attention), the kernels against the plain
version at GraphGPS's cell shape (B = 1024, H = 16, N = 80, d = 24) and at
small ones, and a ``GPSLayer`` in training on the kernels.

Without a bias, on the CPU: the plain twins and the explicit path with
``bias=None`` against the same with a zero bias, the two paths against
each other, and ``None`` for the bias's gradient; a molecule with no valid
key reads zeros on the explicit path too.  This file imports no JAX,
so on the card it runs without the suite's ``conftest.py``::

    python3 -m pytest --noconftest -q tests/test_torch_biased_attention.py
"""

import pytest
import torch

from mgat_graphsage_torch.ops import biased_attention as ba


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _inputs(b, h, n, d, seed=0, dtype=torch.float32, device="cpu",
            dropout=0.0, lonely=False):
    """q, k, v, bias, key_mask, keep: molecules padded to n (the first
    always full), and with ``lonely`` the last one's only valid key the
    graph token (key 0)."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, h, n, d, generator=g) for _ in range(3))
    bias = torch.randn(b, h, n, n, generator=g)
    sizes = torch.randint(1, n + 1, (b,), generator=g)
    sizes[0] = n
    if lonely:
        sizes[-1] = 1
    key_mask = torch.arange(n)[None, :] < sizes[:, None]
    keep = None
    if dropout:
        keep = torch.rand(b, h, n, n, generator=g) >= dropout
    out = [t.to(dtype) for t in (q, k, v)] + [bias, key_mask, keep]
    return [None if t is None else t.to(device) for t in out]


CASES = [pytest.param(3, 4, 21, 8, False, id="n21-padded"),
         pytest.param(2, 2, 9, 4, True, id="n9-graph-token-only-row"),
         pytest.param(2, 3, 16, 8, False, id="n16")]


@pytest.mark.parametrize("dropout", [0.0, 0.3])
@pytest.mark.parametrize("b,h,n,d,lonely", CASES)
def test_plain_algorithm_matches_explicit_path(b, h, n, d, lonely, dropout):
    """The kernel path's ``autograd.Function`` on the CPU (the plain
    version of the kernel's algorithm, forward and backward) against the
    explicit path in f32: ``out``, ``dq``, ``dk``, ``dv`` and the bias
    gradient to 1e-5 of each norm (the two sum in other orders, and the
    backward takes ``D`` from ``out`` rather than from the
    probabilities)."""
    q, k, v, bias, key_mask, keep = _inputs(b, h, n, d, dropout=dropout,
                                            lonely=lonely)
    scale = d ** -0.5
    cot = torch.randn(b, h, n, d, generator=torch.Generator().manual_seed(9))
    grads = []
    for fn in (ba.BiasedAttention, ba.BiasedAttentionKernel):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
        out = fn.apply(*leaves, key_mask, keep, dropout, scale)
        (out * cot).sum().backward()
        grads.append([out.detach()] + [t.grad for t in leaves])
    for name, got, want in zip(("out", "dq", "dk", "dv", "dbias"), *grads):
        assert torch.isfinite(got).all(), name
        assert _rel(got, want) <= 1e-5, name
    dbias = grads[1][4]
    assert (dbias * ~key_mask[:, None, None, :] == 0).all()


def test_row_without_a_valid_key_gives_zeros():
    """A molecule with no valid key (no layer makes one: the graph token
    is always valid) reads 0, lse +inf, and zero gradients."""
    q, k, v, bias, key_mask, _ = _inputs(2, 2, 5, 4)
    key_mask[1] = False
    out, lse = ba.biased_attention_fwd_plain(q, k, v, bias, key_mask)
    assert (out[1] == 0).all() and torch.isinf(lse[1]).all()
    assert torch.isfinite(out[0]).all() and torch.isfinite(lse[0]).all()
    grads = ba.biased_attention_bwd_plain(q, k, v, out, torch.ones_like(out),
                                          bias, key_mask, lse)
    for t in grads:
        assert (t[1] == 0).all() and torch.isfinite(t).all()


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_no_bias_is_a_zero_bias(dropout):
    """``bias=None`` on the plain twins and on the explicit path gives a
    zero bias's outputs to the bit, and no bias gradient (None); the
    kernel path's ``autograd.Function`` on the CPU agrees with the
    explicit path within 1e-5 of each norm, as with a bias."""
    q, k, v, _, key_mask, keep = _inputs(3, 4, 21, 8, dropout=dropout,
                                         lonely=True)
    zero = torch.zeros(3, 4, 21, 21)
    out, lse = ba.biased_attention_fwd_plain(q, k, v, None, key_mask, keep,
                                             dropout)
    want = ba.biased_attention_fwd_plain(q, k, v, zero, key_mask, keep,
                                         dropout)
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
    g = torch.randn(3, 4, 21, 8, generator=torch.Generator().manual_seed(4))
    got = ba.biased_attention_bwd_plain(q, k, v, out, g, None, key_mask, lse,
                                        keep, dropout)
    want = ba.biased_attention_bwd_plain(q, k, v, out, g, zero, key_mask,
                                         lse, keep, dropout)
    assert got[3] is None
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    grads = []
    for fn, bias in ((ba.BiasedAttention, None), (ba.BiasedAttention, zero),
                     (ba.BiasedAttentionKernel, None)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = fn.apply(*leaves, bias, key_mask, keep, dropout, 8 ** -0.5)
        (o * g).sum().backward()
        grads.append([o.detach()] + [t.grad for t in leaves])
    for a, b in zip(grads[0], grads[1]):
        assert torch.equal(a, b)
    for a, b in zip(grads[2], grads[0]):
        assert _rel(a, b) <= 1e-5


@pytest.mark.parametrize("bias", [True, False])
def test_explicit_path_reads_zeros_without_a_valid_key(bias):
    """A molecule with no valid key (a padded molecule of GraphGPS's batch)
    reads 0 and passes zero gradients on the explicit path, as on the
    kernels, and leaves the other molecules' results finite."""
    q, k, v, b, key_mask, _ = _inputs(2, 2, 5, 4)
    key_mask[1] = False
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ba.BiasedAttention.apply(*leaves, b if bias else None, key_mask,
                                   None, 0.0, 0.5)
    out.square().sum().backward()
    assert (out[1] == 0).all() and torch.isfinite(out).all()
    for t in leaves:
        assert (t.grad[1] == 0).all() and torch.isfinite(t.grad).all()


@pytest.mark.parametrize("dropout", [0.0, 0.25])
def test_kernel_path_gradcheck_f64(dropout):
    """``gradcheck`` of the kernel path's ``autograd.Function`` in f64 on
    the CPU: the plain backward (from ``lse`` and ``D``) is the forward's
    derivative in ``q``, ``k``, ``v`` and the bias, padded keys and a
    fixed keep-mask included."""
    q, k, v, bias, key_mask, keep = _inputs(2, 2, 6, 3, seed=3,
                                            dtype=torch.float64,
                                            dropout=dropout)
    leaves = [t.double().requires_grad_(True) for t in (q, k, v, bias)]

    def fn(q, k, v, bias):
        return ba.BiasedAttentionKernel.apply(q, k, v, bias, key_mask, keep,
                                              dropout, 0.5)

    assert torch.autograd.gradcheck(fn, leaves, eps=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,d,dtype,ok", [
    (81, 24, torch.bfloat16, True), (1, 8, torch.bfloat16, True),
    (128, 32, torch.bfloat16, True), (129, 24, torch.bfloat16, False),
    (0, 24, torch.bfloat16, False), (81, 12, torch.bfloat16, False),
    (81, 40, torch.bfloat16, False), (81, 64, torch.bfloat16, False),
    (81, 24, torch.float32, False), (81, 24, torch.float16, False)])
def test_kernels_support_limits(n, d, dtype, ok):
    """The kernels take bf16 at N <= 128 and d in 8, 16, 24, 32; the
    explicit path takes the rest (and every CPU tensor)."""
    assert ba.kernels_support(n, d, dtype) is ok


@pytest.mark.parametrize("grad", [False, True])
def test_cpu_takes_the_explicit_path(grad):
    """On the CPU a shape the kernels take still runs the explicit path:
    the ``kernel`` counter and the wrappers' launches do not move."""
    q, k, v, bias, key_mask, _ = _inputs(2, 2, 9, 8, dtype=torch.bfloat16)
    if grad:
        q.requires_grad_(True)
    before = ba.counts()
    launches = (ba.biased_attention_cuda.launches,
                ba.biased_attention_bwd_cuda.launches)
    out = ba.biased_attention(q, k, v, bias, key_mask)
    ba.biased_attention(q, k, v, None, key_mask)
    if grad:
        out.float().sum().backward()
    after = ba.counts()
    assert {p: after[p] - before[p] for p in after} == {
        "explicit": 2, "kernel": 0, "unbiased": 1}
    assert launches == (ba.biased_attention_cuda.launches,
                        ba.biased_attention_bwd_cuda.launches)


def test_cpu_wrappers_return_the_plain_version():
    """The kernel wrappers on CPU tensors are the plain version (the
    statistics only when asked for)."""
    q, k, v, bias, key_mask, keep = _inputs(2, 2, 7, 8, dropout=0.2)
    out, lse = ba.biased_attention_cuda(q, k, v, bias, key_mask, keep, 0.2,
                                        stats=True)
    want = ba.biased_attention_fwd_plain(q, k, v, bias, key_mask, keep, 0.2)
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
    assert ba.biased_attention_cuda(q, k, v, bias, key_mask)[1] is None
    g = torch.ones_like(out)
    grads = ba.biased_attention_bwd_cuda(q, k, v, out, g, bias, key_mask,
                                         lse, keep, 0.2)
    want = ba.biased_attention_bwd_plain(q, k, v, out, g, bias, key_mask,
                                         lse, keep, 0.2)
    for got, w in zip(grads, want):
        assert torch.equal(got, w)
    out, lse = ba.biased_attention_cuda(q, k, v, None, key_mask, keep, 0.2,
                                        stats=True)
    assert torch.equal(out, ba.biased_attention_fwd_plain(
        q, k, v, None, key_mask, keep, 0.2)[0])
    assert ba.biased_attention_bwd_cuda(q, k, v, out, g, None, key_mask, lse,
                                        keep, 0.2)[3] is None


def test_plain_bf16_rounds_where_the_kernel_does():
    """In bf16 the plain version stays within bf16 rounding of its own f32
    run (the dropped probabilities and dS rounded before their products,
    the outputs rounded once)."""
    args = _inputs(2, 4, 21, 8, dropout=0.1)
    q32, k32, v32 = args[:3]
    bf = [t.to(torch.bfloat16) for t in (q32, k32, v32)]
    exact = [t.to(torch.bfloat16).float() for t in (q32, k32, v32)]
    o16, l16 = ba.biased_attention_fwd_plain(*bf, *args[3:], p=0.1)
    o32, l32 = ba.biased_attention_fwd_plain(*exact, *args[3:], p=0.1)
    assert o16.dtype == torch.bfloat16 and l16.dtype == torch.float32
    assert _rel(o16, o32) <= 1e-2 and _rel(l16, l32) <= 1e-6


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


CARD = [pytest.param(1024, 32, 81, 24, 0.1, id="cell-b1024-h32-n81-d24"),
        pytest.param(3, 4, 21, 24, 0.1, id="n21-d24"),
        pytest.param(3, 4, 21, 24, 0.0, id="n21-d24-no-dropout"),
        pytest.param(2, 3, 1, 8, 0.0, id="n1-d8"),
        pytest.param(2, 3, 33, 16, 0.2, id="n33-d16"),
        pytest.param(2, 5, 64, 32, 0.1, id="n64-d32"),
        pytest.param(2, 2, 128, 24, 0.1, id="n128-d24"),
        pytest.param(3, 7, 97, 8, 0.1, id="n97-d8-odd-heads")]


@pytest.mark.card
@pytest.mark.parametrize("b,h,n,d,p", CARD)
def test_kernels_match_plain_on_the_card(cuda, b, h, n, d, p):
    """Forward and backward kernels against the plain version on the card,
    both bf16 in and out, with padded molecules and one whose only valid
    key is the graph token.  Tolerances: ``out``, ``dq``, ``dk``, ``dv``
    within 1e-2 of each output's largest magnitude (a bf16 ulp is 2^-8 of
    a value: the two sum the products in other orders, so a probability
    or dS may round to the neighbouring bf16 before its product); ``lse``
    and the f32 bias gradient within 1e-5 (f32 sums in other orders and
    ``expf`` against torch's ``exp``)."""
    q, k, v, bias, key_mask, keep = _inputs(
        b, h, n, d, seed=n + d, dtype=torch.bfloat16, device=cuda,
        dropout=p, lonely=True)
    out, lse = ba.biased_attention_cuda(q, k, v, bias, key_mask, keep, p,
                                        stats=True)
    want_out, want_lse = ba.biased_attention_fwd_plain(q, k, v, bias,
                                                       key_mask, keep, p)
    g = torch.randn(b, h, n, d, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(1)
                    ).to(torch.bfloat16)
    grads = ba.biased_attention_bwd_cuda(q, k, v, out, g, bias, key_mask,
                                         lse, keep, p)
    want = ba.biased_attention_bwd_plain(q, k, v, out, g, bias, key_mask,
                                         lse, keep, p)
    torch.cuda.synchronize()
    assert out.shape == (b, h, n, d) and out.dtype == torch.bfloat16
    assert _max_err(out, want_out) <= 1e-2
    assert _max_err(lse, want_lse) <= 1e-5
    for name, got, w in zip(("dq", "dk", "dv", "dbias"), grads, want):
        assert got.shape == w.shape and got.dtype == w.dtype, name
        assert torch.isfinite(got).all(), name
        assert _max_err(got, w) <= (1e-5 if name == "dbias" else 1e-2), name
    assert (grads[3] * ~key_mask[:, None, None, :] == 0).all()


@pytest.mark.card
def test_kernels_repeat_bit_for_bit(cuda):
    """No atomics and fixed orders: two launches on the same inputs give
    the same bits, forward and backward."""
    q, k, v, bias, key_mask, keep = _inputs(64, 32, 81, 24,
                                            dtype=torch.bfloat16,
                                            device=cuda, dropout=0.1)
    runs = []
    for _ in range(2):
        out, lse = ba.biased_attention_cuda(q, k, v, bias, key_mask, keep,
                                            0.1, stats=True)
        runs.append((out, lse) + ba.biased_attention_bwd_cuda(
            q, k, v, out, out, bias, key_mask, lse, keep, 0.1))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.card
def test_training_layer_runs_the_kernels(cuda):
    """A bf16 ``GraphormerLayer`` in training on the card: its attention is
    one forward and one backward launch, counted under ``kernel``, with
    no explicit or SDPA call; evaluation is one forward launch."""
    from mgat_graphsage_torch.models.layers import GraphormerLayer

    layer = GraphormerLayer(96, 4, 96).to(cuda, torch.bfloat16).train()
    x = torch.randn(8, 17, 96, device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    bias = torch.randn(8, 4, 17, 17, device=cuda, requires_grad=True)
    key_mask = torch.ones(8, 17, dtype=torch.bool, device=cuda)
    key_mask[3, 9:] = False
    before = ba.counts()
    fwd, bwd = (ba.biased_attention_cuda.launches,
                ba.biased_attention_bwd_cuda.launches)
    layer(x, bias, key_mask, torch.Generator(cuda).manual_seed(0)
          ).float().square().sum().backward()
    layer.eval()
    with torch.no_grad():
        layer(x, bias, key_mask)
    torch.cuda.synchronize()
    after = ba.counts()
    assert {p: after[p] - before[p] for p in after} == {
        "explicit": 0, "kernel": 2, "unbiased": 0}
    assert ba.biased_attention_cuda.launches - fwd == 2
    assert ba.biased_attention_bwd_cuda.launches - bwd == 1
    assert torch.isfinite(bias.grad).all() and torch.isfinite(x.grad).all()


GPS_CARD = [pytest.param(1024, 16, 80, 24, 0.1, id="gps-b1024-h16-n80-d24"),
            pytest.param(3, 4, 21, 24, 0.0, id="n21-d24-no-dropout"),
            pytest.param(2, 3, 1, 8, 0.0, id="n1-d8"),
            pytest.param(2, 5, 64, 32, 0.1, id="n64-d32"),
            pytest.param(2, 2, 128, 24, 0.1, id="n128-d24")]


@pytest.mark.card
@pytest.mark.parametrize("b,h,n,d,p", GPS_CARD)
def test_kernels_without_a_bias_match_plain_on_the_card(cuda, b, h, n, d, p):
    """The kernels with ``bias=None`` against the plain version with
    ``bias=None`` on the card, forward with and without the statistics
    and backward, with a molecule that has no valid key (a padded row of
    GraphGPS's batch): the tolerances of
    :func:`test_kernels_match_plain_on_the_card`, no bias gradient, and
    the grad-free forward the same bits as the one with statistics."""
    q, k, v, _, key_mask, keep = _inputs(
        b, h, n, d, seed=n + d + 1, dtype=torch.bfloat16, device=cuda,
        dropout=p)
    key_mask[-1] = False
    out, lse = ba.biased_attention_cuda(q, k, v, None, key_mask, keep, p,
                                        stats=True)
    free = ba.biased_attention_cuda(q, k, v, None, key_mask, keep, p)[0]
    want_out, want_lse = ba.biased_attention_fwd_plain(q, k, v, None,
                                                       key_mask, keep, p)
    g = torch.randn(b, h, n, d, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(2)
                    ).to(torch.bfloat16)
    grads = ba.biased_attention_bwd_cuda(q, k, v, out, g, None, key_mask,
                                         lse, keep, p)
    want = ba.biased_attention_bwd_plain(q, k, v, out, g, None, key_mask,
                                         lse, keep, p)
    torch.cuda.synchronize()
    assert torch.equal(free, out)
    assert _max_err(out, want_out) <= 1e-2
    assert _max_err(lse[:-1], want_lse[:-1]) <= 1e-5
    assert (out[-1] == 0).all() and torch.isinf(lse[-1]).all()
    assert grads[3] is None and want[3] is None
    for name, got, w in zip(("dq", "dk", "dv"), grads[:3], want[:3]):
        assert torch.isfinite(got).all(), name
        assert _max_err(got, w) <= 1e-2, name
        assert (got[-1] == 0).all(), name


@pytest.mark.card
def test_gps_layer_runs_the_kernels_without_a_bias(cuda):
    """A bf16 ``GPSLayer`` in training on the card: its attention is one
    forward and one backward launch with no bias, counted under
    ``kernel`` and ``unbiased``, with no explicit call."""
    from mgat_graphsage_torch.models.layers import GPSLayer

    layer = GPSLayer(48, 2, 96).to(cuda, torch.bfloat16).train()
    b, n, e = 4, 9, 16
    x = torch.randn(b, n, 48, device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    ea = torch.randn(b, e, 48, device=cuda, dtype=torch.bfloat16)
    edges = torch.randint(0, n, (b, 2, e), device=cuda)
    node_mask = torch.ones(b, n, device=cuda, dtype=torch.bfloat16)
    edge_mask = torch.ones(b, e, device=cuda, dtype=torch.bfloat16)
    before = ba.counts()
    fwd, bwd = (ba.biased_attention_cuda.launches,
                ba.biased_attention_bwd_cuda.launches)
    h, ea2 = layer(x, ea, edges, node_mask, edge_mask,
                   torch.Generator(cuda).manual_seed(0))
    (h.float().square().sum() + ea2.float().sum()).backward()
    torch.cuda.synchronize()
    after = ba.counts()
    assert {p: after[p] - before[p] for p in after} == {
        "explicit": 0, "kernel": 1, "unbiased": 1}
    assert ba.biased_attention_cuda.launches - fwd == 1
    assert ba.biased_attention_bwd_cuda.launches - bwd == 1
    assert torch.isfinite(x.grad).all()
