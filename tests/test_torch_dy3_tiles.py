"""The tile algebra of the bf16 masked fc1 input gradient (``csrc/cnn_dy3.cu``,
``cnn_dy3_bf16_kernel``), walked in plain torch on the CPU and held against
``ops/cnn.py::dy3_plain``.

The kernel runs only on the card.  What can go wrong off it is its index
arithmetic, so this file evaluates the kernel's own constants and integer
helpers, parsed from the source (``kChunkM``, ``kConsumers``,
``kDyStages``, ``kY3Stages``, ``tile_cols``, ``smem_boxes``,
``block_items``, ``first_chunk``, ``last_chunk``, ``tile_offset``,
``frag_row``, ``frag_col``: C integer expressions, read here as Python):

- the persistent schedule: every (column tile, molecule chunk) exactly
  once over the blocks and the two consumer groups, each group arriving
  once an item on the slab's barrier, each ring stage read by one group
  only (so its parity waits see every phase);
- the 128-byte swizzle of a staged tile: TMA's pattern, a bijection, and
  the epilogue's and wgmma's accesses free of bank conflicts;
- the accumulator fragment map of the epilogue, covering the staging tile
  exactly once;
- the kernel's chunked walk (zero-filled rows past B and H, k-steps of 16
  summed in f32, rounded once, masked, rows and columns past the tensor
  dropped) against the plain version under the card's rule: one bf16 ulp,
  or the f32 summation bound ``2 H 2^-24 sum_h |dy w|``, and equal on
  >= 99% of elements (``chip_smoke.py::check_dy3_bf16``).

PyTorch runs on one thread here.
"""

import os
import re

import numpy as np
import pytest
import torch

from mgat_graphsage_torch.ops import _build
from mgat_graphsage_torch.ops import cnn as torch_cnn

SMEM_LIMIT = 232448          # a block's shared memory on the H100
H100_SMS = 132


def _source():
    with open(os.path.join(_build.CSRC_DIR, "cnn_dy3.cu")) as fh:
        return fh.read()


def _py(expr):
    """A C integer expression on non-negative ints as Python: ``/`` is
    floor division, and one top-level ``a ? b : c`` a conditional."""
    expr = " ".join(expr.split()).replace("/", "//")
    depth, q = 0, None
    for i, ch in enumerate(expr):
        depth += ch == "("
        depth -= ch == ")"
        if depth == 0 and ch == "?" and q is None:
            q = i
        elif depth == 0 and ch == ":" and q is not None:
            return f"(({expr[q + 1:i]}) if ({expr[:q]}) else ({expr[i + 1:]}))"
    return expr


def _kernel():
    """The bf16 kernel's constants and helpers, from the source."""
    src = _source()
    src = src[src.index("// ---- bf16 kernel 4b"):]
    ns = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", src,
                                 re.M):
        ns[name] = eval(_py(expr), dict(ns))
    for m in re.finditer(r"^(?:__host__ __device__ )?(?:constexpr )?int "
                         r"(\w+)\(([^)]*)\) \{\s*return (.*?);\s*\}", src,
                         re.M | re.S):
        args = ", ".join(a.split()[-1] for a in m.group(2).split(","))
        exec(f"def {m.group(1)}({args}):\n    return {_py(m.group(3))}", ns)
    return ns


K = _kernel()
HELPERS = ("tile_cols", "smem_boxes", "block_items",
           "first_chunk", "last_chunk", "tile_offset", "frag_row",
           "frag_col")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_the_helpers_are_parsed():
    assert all(callable(K.get(name)) for name in HELPERS)
    assert K["kChunkM"] == 64            # one wgmma M
    assert K["kBox"] * 2 == 128          # a box row is the swizzle's 128 B
    assert K["kBoxBytes"] == 64 * 128
    assert K["kThreadsBf16"] == 128 * (K["kConsumers"] + 1)
    assert K["kMaxH"] == torch_cnn._DY3_MAX_H_BF16


@pytest.mark.parametrize("h", [8, 64, 72, 256, 264, 512])
def test_shared_memory_fits_at_every_h_the_wrapper_takes(h):
    """The launcher's bytes (1 KB to align the swizzle's pattern, the
    boxes, the barriers) fit a block, the slab is 64 KB at the most, and
    the tile is a wgmma width made of whole 64-column boxes."""
    bn = K["tile_cols"](h)
    nkb = -(-h // 64)
    smem = (1024 + K["smem_boxes"](bn, nkb) * K["kBoxBytes"]
            + 8 * (2 + 2 * K["kDyStages"] + 2 * K["kY3Stages"]))
    assert smem <= SMEM_LIMIT
    assert nkb * (bn // 64) * K["kBoxBytes"] <= 64 * 1024
    assert bn in (64, 128)


def schedule(b, w, sms=H100_SMS, h=256):
    """The kernel's walk at batch ``b``, width ``w``: the chunks each
    consumer group takes, as ((column tile, molecule chunk), group, dy
    stage, y3 stage); and per (block, item) the groups that arrive on the
    slab's empty barrier."""
    bn = K["tile_cols"](h)
    items = -(-(w * 128) // bn)
    nch = -(-b // K["kChunkM"])
    grid = min(items, sms)
    ncons, ys = K["kConsumers"], K["kY3Stages"]
    taken, arrivals = [], {}
    for block in range(grid):
        g = 0
        for it in range(K["block_items"](items, grid, block)):
            tile = block + it * grid
            for wg in range(ncons):
                first = K["first_chunk"](g, wg)
                last = K["last_chunk"](first, g + nch)
                mine = list(range(first, g + nch, ncons))
                assert (last == mine[-1]) if mine else last == -1
                arrivals.setdefault((block, it), []).append(wg)
                taken += [((tile, gc - g), wg, gc % K["kDyStages"], gc % ys)
                          for gc in mine]
            g += nch
    return taken, arrivals, items, nch


@pytest.mark.parametrize("w", [1, 3, 1024])
@pytest.mark.parametrize("b", [1, 63, 64, 65, 952, 1024, 1025])
def test_persistent_schedule_takes_every_chunk_once(b, w):
    taken, arrivals, items, nch = schedule(b, w)
    chunks = [c for c, _, _, _ in taken]
    assert len(chunks) == len(set(chunks)) == items * nch
    assert set(chunks) == {(t, j) for t in range(items) for j in range(nch)}
    # each group arrives once an item on the slab's empty barrier
    assert all(sorted(g) == list(range(K["kConsumers"]))
               for g in arrivals.values())
    # a ring stage is read by one group only
    for ring in (2, 3):
        owner = {}
        for row in taken:
            assert owner.setdefault(row[ring], row[1]) == row[1]


def test_persistent_schedule_is_one_block_per_sm_and_even():
    """At the main path's shape (W=1024, BN=128) the 1024 column tiles go
    over the 132 SMs in 8 rounds, 7 or 8 tiles a block."""
    items = 1024 * 128 // K["tile_cols"](256)
    per = [K["block_items"](items, H100_SMS, blk) for blk in range(H100_SMS)]
    assert sum(per) == items and set(per) == {7, 8}


def _swizzle(linear):
    """TMA's 128-byte swizzle (CuTe's Swizzle<3,4,3>): 16-byte chunk bits
    4-6 take an XOR of the 128-byte row bits 7-9."""
    return linear ^ (((linear >> 7) & 7) << 4)


@pytest.mark.parametrize("bn", [64, 128])
def test_tile_offset_is_tmas_swizzle_and_a_bijection(bn):
    offs = {}
    for r in range(64):
        for c in range(bn):
            off = K["tile_offset"](r, c)
            linear = c // 64 * K["kBoxBytes"] + r * 128 + c % 64 * 2
            assert off == _swizzle(linear)
            offs[off] = (r, c)
    assert sorted(offs) == list(range(0, 64 * bn * 2, 2))


@pytest.mark.parametrize("bn", [64, 128])
def test_staged_tiles_are_read_without_bank_conflicts(bn):
    """The epilogue: each warp's 32 four-byte reads (the mask) and writes
    (the staging tile) of one accumulator pair hit 32 banks.  wgmma and
    ldmatrix: the 8 rows of an 8 x 8 tile's 16-byte row chunk lie on 8
    distinct 16-byte bank groups."""
    for warp in range(4):
        for i in range(0, bn // 2, 2):
            banks = {K["tile_offset"](K["frag_row"](warp, lane, i),
                                      K["frag_col"](lane, i)) // 4 % 32
                     for lane in range(32)}
            assert len(banks) == 32
    for r0 in range(0, 64, 8):
        for c in range(0, bn, 8):
            groups = {K["tile_offset"](r0 + r, c) // 16 % 8
                      for r in range(8)}
            assert len(groups) == 8


@pytest.mark.parametrize("bn", [64, 128])
def test_fragment_map_covers_the_staging_tile_once(bn):
    """The accumulator of the 128 threads of a group (bn / 2 floats each)
    lands on each element of the 64 x bn staging tile exactly once, and
    each thread's pairs (i, i + 1) are neighbours in a row."""
    seen = {}
    for warp in range(4):
        for lane in range(32):
            for i in range(bn // 2):
                rc = (K["frag_row"](warp, lane, i), K["frag_col"](lane, i))
                assert rc not in seen
                seen[rc] = (warp, lane, i)
                if i % 2:
                    assert rc == (K["frag_row"](warp, lane, i - 1),
                                  K["frag_col"](lane, i - 1) + 1)
    assert set(seen) == {(r, c) for r in range(64) for c in range(bn)}


def kernel_walk(dy, w, y3):
    """The kernel's walk on bf16 ``dy [B, H]``, ``w [H, K]``, ``y3 [B, K]``:
    tiles of 64 molecules and tile_cols(H) columns with the rows past B and
    H zero-filled (TMA's out-of-range fill), k-steps of 16 summed in f32,
    rounded once to bf16, masked by y3 > 0; rows and columns past the
    tensor dropped (TMA's store)."""
    b, h = dy.shape
    k = w.shape[1]
    bn, m = K["tile_cols"](h), K["kChunkM"]
    nch, items = -(-b // m), -(-k // bn)
    hp = -(-h // 64) * 64
    dyp = torch.zeros(nch * m, hp)
    dyp[:b, :h] = dy.float()
    wp = torch.zeros(hp, items * bn)
    wp[:h, :k] = w.float()
    yp = torch.zeros(nch * m, items * bn)
    yp[:b, :k] = y3.float()
    out = torch.zeros(nch * m, items * bn, dtype=torch.bfloat16)
    for t in range(items):
        slab = wp[:, t * bn:(t + 1) * bn]
        for j in range(nch):
            rows = slice(j * m, (j + 1) * m)
            acc = torch.zeros(m, bn)
            for ks in range(0, -(-h // 16) * 16, 16):
                acc += dyp[rows, ks:ks + 16] @ slab[ks:ks + 16]
            mask = yp[rows, t * bn:(t + 1) * bn] > 0
            out[rows, t * bn:(t + 1) * bn] = torch.where(
                mask, acc, 0.0).to(torch.bfloat16)
    return out[:b, :k]


def _bf16_ulp(x):
    a = x.abs().float()
    return (a.view(torch.int32) + 0x10000).view(torch.float32) - a


@pytest.mark.parametrize("b,w,h", [(1, 1, 256), (63, 1, 256), (64, 3, 256),
                                   (65, 37, 256), (129, 2, 256),
                                   (1025, 1, 256), (65, 3, 512),
                                   (3, 5, 72)])
def test_chunked_walk_meets_the_cards_rule(b, w, h):
    """At ragged (B, W, H) (a chunk short, one past, BN = 64 at H = 512,
    H not a multiple of 64), the walk against the plain version: each
    element within one bf16 ulp or the f32 summation bound, >= 99% equal,
    and zero wherever y3 <= 0."""
    rng = np.random.default_rng(1000 * b + w + h)

    def bf(a):
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)

    dy = bf(rng.standard_normal((b, h)) * 0.01)
    fw = bf(rng.standard_normal((h, w * 128)) * 0.01)
    y3 = bf(np.maximum(rng.standard_normal((b, w, 128)), 0))
    want = torch_cnn.dy3_plain(dy, fw, y3)
    got = kernel_walk(dy, fw, y3.view(b, -1)).view(want.shape)
    g, p = got.float(), want.float()
    gap = (g - p).abs()
    ulp = _bf16_ulp(torch.maximum(g.abs(), p.abs()))
    bound = 2 * h * 2.0 ** -24 * (dy.float().abs() @ fw.float().abs()
                                  ).view(want.shape)
    assert not (gap > torch.maximum(ulp, bound)).any()
    assert float((gap == 0).float().mean()) >= 0.99
    assert not got[y3 <= 0].float().any()
