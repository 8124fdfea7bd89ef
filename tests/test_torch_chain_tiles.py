"""The tile algebra of the bf16 conv-chain kernel (``csrc/cnn_chain_bwd.cu``,
``cnn_chain_bwd_bf16_kernel``), walked in plain torch on the CPU and held
against ``ops/cnn.py::cnn_chain_bwd_plain``.

The kernel runs only on the card.  Its index arithmetic is what can go
wrong at the edges of a tile, so this file repeats it tile by tile with the
kernel's own constants (tile width ``kBTW``, the row origins ``kBD3Lo``,
``kBD2Lo``, ``kBWinLo``, parsed from the source):

- the staged d3 rows from ``w0 - kBD3Lo``, and the y2, y1, fp windows
  from ``w0 - kBWinLo``, zero outside ``[0, W)``;
- each wgrad on the core positions ``p`` of the tile with the pos-major
  operand shifted, ``dw[k] = sum_p d[p - k + 1] x[p]``, a shifted row
  outside the core read as zero, and the two terms at ``p = w0 - 1``
  (tap 0) and ``p = w0 + TW`` (tap 2) added apart;
- d2 over rows from ``w0 - kBD2Lo`` (of which the TW + 2 rows ``w0 - 1 ..
  w0 + TW`` are kept), from the d3 rows shifted by ``1 - k`` and clamped
  into the stage; rounded to bf16, then masked by y2 > 0;
- d1 on the core from the shifted d2 rows, rounded, masked; dw1 and db1
  from it and the fp window; db3 and db2 over the core rows only.

The limit is the one the card's check uses, 2e-3 of each output's largest
magnitude (``chip_smoke.py``, ``tests/test_torch_cnn_bf16.py``): both sides
round d2 and d1 to bf16 from f32 sums taken in other orders.  PyTorch runs
on one thread here.
"""

import os
import re

import numpy as np
import pytest
import torch

from mgat_graphsage_torch.ops import _build
from mgat_graphsage_torch.ops.cnn import cnn_chain_bwd_plain

LIMIT = 2e-3
NAMES = ("dw3", "db3", "dw2", "db2", "dw1", "db1")


def _constants():
    with open(os.path.join(_build.CSRC_DIR, "cnn_chain_bwd.cu")) as fh:
        src = fh.read()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                src).group(1))
            for name in ("kBTW", "kBD3Lo", "kBD2Lo", "kBWinLo")}


K = _constants()
TW = K["kBTW"]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(x, lo, hi):
    """Rows ``lo .. hi-1`` of ``x [W, C]``, zero outside ``[0, W)``."""
    out = torch.zeros(hi - lo, x.shape[1])
    a, b = max(lo, 0), min(hi, x.shape[0])
    if a < b:
        out[a - lo:b - lo] = x[a:b]
    return out


def _take(x, idx, n):
    """``x[idx]`` for an index tensor that must lie in ``[0, n)``."""
    assert int(idx.min()) >= 0 and int(idx.max()) < n, (idx.min(), idx.max())
    return x[idx]


def _round(x):
    return x.to(torch.bfloat16).float()


def kernel_walk(dy3, y2, y1, fp, w3, w2, edges=True, zero_halo=True,
                core_bias=True):
    """The kernel's tile walk on f32 copies of bf16 values: ``dy3 [B, W,
    128]``, ``y2 [B, 64, W]``, ``y1 [B, 32, W]``, ``fp [B, W]``, ``w3
    [128, 64, 3]``, ``w2 [64, 32, 3]`` -> the six f32 outputs in torch
    layouts.  The flags switch one edge rule off, to show that each is
    needed: the wgrads' two edge terms, the zero rows outside the core,
    and the bias sums over the core rows only."""
    d3lo, d2lo, winlo = K["kBD3Lo"], K["kBD2Lo"], K["kBWinLo"]
    p3, p2, win = TW + 2 * d3lo, TW + 2 * d2lo, TW + 2 * winlo
    b_, w_ = fp.shape
    w3t, w2t = w3.permute(2, 1, 0), w2.permute(2, 1, 0)    # [k][i][o]
    dw3, dw2 = torch.zeros(3, 128, 64), torch.zeros(3, 64, 32)
    dw1, db1 = torch.zeros(32, 3), torch.zeros(32)
    db3, db2 = torch.zeros(128), torch.zeros(64)
    core = torch.arange(TW)
    for b in range(b_):
        for w0 in range(0, w_, TW):
            d3s = _rows(dy3[b], w0 - d3lo, w0 - d3lo + p3)         # [s][o]
            wins = _rows(torch.cat([y2[b], y1[b], fp[b][None]]).t(),
                         w0 - winlo, w0 - winlo + win).t()         # [c][p]
            y2s, y1s, fps = wins[:64], wins[64:96], wins[96]

            def wgrad(acc, d, lo, x):
                # acc[k] += sum over core p of d[p - k + 1] x[p]: the
                # pos-major rows shifted, the ones outside the core zero
                xc = x[:, winlo + core]
                for k in range(3):
                    s = core + 1 - k + lo
                    a = _take(d, s, d.shape[0]).clone()
                    if zero_halo:
                        a[(s == lo - 1) | (s == lo + TW)] = 0
                    acc[k] += a.t() @ xc.t()
                if edges:
                    acc[0] += torch.outer(d[lo], x[:, winlo - 1])
                    acc[2] += torch.outer(d[lo + TW - 1], x[:, winlo + TW])

            def bias(d, lo):
                return d[lo:lo + TW].sum(0) if core_bias else \
                    d[lo - 1:lo + TW + 1].sum(0)

            wgrad(dw3, d3s, d3lo, y2s)
            db3 += bias(d3s, d3lo)
            # d2, transposed: channels x rows w0 - d2lo + r
            r = torch.arange(p2)
            acc = torch.zeros(64, p2)
            for k in range(3):
                s = (r + d3lo - d2lo + 1 - k).clamp(0, p3 - 1)
                acc += w3t[k] @ d3s[s].t()
            keep = (r >= d2lo - 1) & (r <= d2lo + TW)
            mask = _take(y2s.t(), r - d2lo + winlo, win).t() > 0
            d2s = torch.where(keep & mask, _round(acc), 0.0).t()   # [r][o]
            wgrad(dw2, d2s, d2lo, y1s)
            db2 += bias(d2s, d2lo)
            # d1 on the core, transposed; dw1 and db1 from it
            acc = torch.zeros(32, TW)
            for k in range(3):
                acc += w2t[k] @ _take(d2s, core + 1 - k + d2lo, p2).t()
            d1 = torch.where(y1s[:, winlo + core] > 0, _round(acc), 0.0)
            for k in range(3):
                dw1[:, k] += d1 @ fps[winlo + core - 1 + k]
            db1 += d1.sum(1)
    return (dw3.permute(1, 2, 0), db3, dw2.permute(1, 2, 0), db2,
            dw1.unsqueeze(1), db1)


def _inputs(b, w, seed):
    rng = np.random.default_rng(seed)

    def bf(a):
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)

    relu = lambda *s: np.maximum(rng.standard_normal(s), 0)
    return (bf(relu(b, w, 128) * 0.1), bf(relu(b, 64, w)), bf(relu(b, 32, w)),
            bf(rng.uniform(size=(b, w)) > 0.8),
            bf(rng.standard_normal((128, 64, 3)) * 0.05),
            bf(rng.standard_normal((64, 32, 3)) * 0.1))


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def test_the_halos_cover_the_taps():
    """The staged rows reach the two d3 rows each side that d2's halo
    needs, the d2 rows the one each side that d1 needs, the windows d2's
    rows, in 16-byte chunks; the tile is whole d1 column tiles."""
    assert TW % 32 == 0
    assert K["kBD3Lo"] >= 2 and K["kBD2Lo"] >= 1
    assert K["kBWinLo"] >= K["kBD2Lo"] and K["kBWinLo"] % 8 == 0


@pytest.mark.parametrize("b,w", [(1, 1), (3, 5), (1, TW - 1), (3, TW + 1),
                                 (3, 37), (1, 100), (2, 2 * TW + 3),
                                 (1, 2 * TW)])
def test_tile_walk_matches_the_plain_chain(b, w):
    """The kernel's per-tile walk, at ragged (B, W) (W below, at and past a
    tile, W % 8 != 0, a last tile of one position), against the plain
    version: each output within LIMIT of its largest magnitude."""
    args = _inputs(b, w, seed=100 * b + w)
    want = cnn_chain_bwd_plain(*args)
    got = kernel_walk(*(t.float() for t in args))
    for name, g, p in zip(NAMES, got, want):
        assert g.shape == p.shape, name
        assert _rel(g, p) < LIMIT, (name, _rel(g, p))


def test_tile_walk_is_exact_where_nothing_is_rounded():
    """dw3 and db3 take no rounded operand: the walk gives them to f32
    summation noise, so an error in a shift or a halo shows far above
    it."""
    args = _inputs(2, TW + 9, seed=7)
    want = cnn_chain_bwd_plain(*args)
    got = kernel_walk(*(t.float() for t in args))
    for name, g, p in zip(NAMES[:2], got[:2], want[:2]):
        assert _rel(g, p) < 1e-5, (name, _rel(g, p))


@pytest.mark.parametrize("rule,outputs", [
    ("edges", ("dw3", "dw2")), ("zero_halo", ("dw3", "dw2")),
    ("core_bias", ("db3", "db2"))])
def test_each_edge_rule_is_needed(rule, outputs):
    """With one edge rule switched off, the walk leaves the limit on the
    outputs that rule shapes: the comparison above sees a halo or shift
    error of one position a tile."""
    args = _inputs(2, 2 * TW, seed=11)
    want = dict(zip(NAMES, cnn_chain_bwd_plain(*args)))
    got = dict(zip(NAMES, kernel_walk(*(t.float() for t in args),
                                      **{rule: False})))
    for name in outputs:
        assert _rel(got[name], want[name]) > LIMIT, (rule, name)
