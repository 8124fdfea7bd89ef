"""``kernel_phases.py`` builds its cut-down kernel copies from the committed
sources by string edits; these tests make every copy here, without
``nvcc``, so that an edit to a kernel that breaks a cut marker fails on the
CPU and not on the card.  They also hold the conv-chain wrapper's tile
width to the kernel's."""

import importlib.util
import os
import re

import pytest

from mgat_graphsage_torch.ops import _build
from mgat_graphsage_torch.ops import cnn as torch_cnn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_spec = importlib.util.spec_from_file_location(
    "kernel_phases", os.path.join(REPO, "kernel_phases.py"))
kernel_phases = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kernel_phases)

# every copy kernel_phases.py times: (name, kernel source)
COPIES = [
    ("k3 full", "attention_bwd"),
    ("k3 load only", "attention_bwd"),
    ("k3 load + phase A", "attention_bwd"),
    ("k3 load + phase A, no softmax", "attention_bwd"),
    ("k4 full", "cnn_dy3"),
    ("k4 no stores", "cnn_dy3"),
    ("k4 FMAs only", "cnn_dy3"),
    ("k5 full", "cnn_chain_bwd"),
    ("k5 staging only", "cnn_chain_bwd"),
    ("k5 staging + dw3, db3", "cnn_chain_bwd"),
    ("k5 staging + level 3", "cnn_chain_bwd"),
    ("k5 staging + level 3 + dw2", "cnn_chain_bwd"),
    ("k5 no refills", "cnn_chain_bwd"),
]


def _source(kernel):
    with open(os.path.join(_build.CSRC_DIR, kernel + ".cu")) as fh:
        return fh.read()


def test_kernel_phases_lists_exactly_these_copies():
    assert list(kernel_phases.variants()) == [name for name, _ in COPIES]


@pytest.mark.parametrize("name,kernel", COPIES)
def test_kernel_phases_builds_each_copy(name, kernel):
    """Each copy is its kernel's committed source, cut (or not, for the
    full kernel) at a marker that is still there, with its entry point."""
    got_kernel, src = kernel_phases.variants()[name]
    assert got_kernel == kernel
    symbol, _ = _build.KERNELS[kernel]
    assert f'extern "C" int {symbol}(' in src
    full = _source(kernel)
    if name.endswith(" full"):
        assert src == full
    else:
        assert src != full and len(src) > len(full) // 2


def test_cut_copies_of_one_kernel_all_differ():
    by_kernel = {}
    for kernel, src in kernel_phases.variants().values():
        by_kernel.setdefault(kernel, []).append(src)
    for kernel, srcs in by_kernel.items():
        assert len(set(srcs)) == len(srcs), kernel


def test_cut_raises_when_the_marker_is_gone():
    with pytest.raises(ValueError, match="kernel source changed"):
        kernel_phases.cut("int x;\n", "  // ---- level 3:", "")


def test_chain_wrapper_tile_width_matches_the_kernel():
    """``ops/cnn.py`` sizes the grid from ``_TILE_W``; the kernel walks
    tiles of ``kTW`` positions.  The two must agree."""
    m = re.search(r"constexpr int kTW = (\d+);", _source("cnn_chain_bwd"))
    assert m is not None
    assert int(m.group(1)) == torch_cnn._TILE_W
