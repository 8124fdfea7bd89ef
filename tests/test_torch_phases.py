"""``kernel_phases.py`` builds its cut-down kernel copies from the committed
sources by string edits; these tests make every copy here, without
``nvcc``, so that an edit to a kernel that breaks a cut marker fails on the
CPU and not on the card.  They also hold the wrappers' tile width and
shared-memory formula to the kernels', run the adjacency launcher's
row-group rule (C, evaluated here) over the shapes it takes, and check
that a build follows the
kernels' shared headers (``csrc/attention_common.cuh``,
``csrc/mma_bf16.cuh``): the library's hash covers them and the copies'
build finds them."""

import importlib.util
import os
import re
import shutil

import pytest

from mgat_graphsage_torch.ops import _build
from mgat_graphsage_torch.ops import attention as torch_attention
from mgat_graphsage_torch.ops import cnn as torch_cnn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_spec = importlib.util.spec_from_file_location(
    "kernel_phases", os.path.join(REPO, "kernel_phases.py"))
kernel_phases = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kernel_phases)

# every copy kernel_phases.py times: (name, kernel source)
COPIES = [
    ("k1 full", "adjacency"),
    ("k1 empty", "adjacency"),
    ("k1 load only", "adjacency"),
    ("k1 no write-out", "adjacency"),
    ("k1 G=1", "adjacency"),
    ("k1 G=2", "adjacency"),
    ("k1 G=3", "adjacency"),
    ("k1 G=4", "adjacency"),
    ("k1 R=1", "adjacency"),
    ("k1 R=4", "adjacency"),
    ("k1 R=8", "adjacency"),
    ("k1 no walk", "adjacency"),
    ("k2 full", "attention"),
    ("k2 empty", "attention"),
    ("k2 load only", "attention"),
    ("k2 load + scores", "attention"),
    ("k2 load + scores + softmax", "attention"),
    ("k2 load + softmax", "attention"),
    ("k2 division per key", "attention"),
    ("k2 G=1", "attention"),
    ("k2 G=2", "attention"),
    ("k2 G=3", "attention"),
    ("k3 full", "attention_bwd"),
    ("k3 load only", "attention_bwd"),
    ("k3 load + phase A", "attention_bwd"),
    ("k3 load + phase A, no softmax", "attention_bwd"),
    ("k4 full", "cnn_dy3"),
    ("k4 no stores", "cnn_dy3"),
    ("k4 FMAs only", "cnn_dy3"),
    ("k4b full", "cnn_dy3"),
    ("k4b producer only", "cnn_dy3"),
    ("k4b no epilogue", "cnn_dy3"),
    ("k4b no store", "cnn_dy3"),
    ("k4b no mask", "cnn_dy3"),
    ("k4b BN=64", "cnn_dy3"),
    ("k4b one consumer", "cnn_dy3"),
    ("k4b y3 stages=4", "cnn_dy3"),
    ("k5 full", "cnn_chain_bwd"),
    ("k5 staging only", "cnn_chain_bwd"),
    ("k5 staging + dw3, db3", "cnn_chain_bwd"),
    ("k5 staging + level 3", "cnn_chain_bwd"),
    ("k5 staging + level 3 + dw2", "cnn_chain_bwd"),
    ("k5 no refills", "cnn_chain_bwd"),
    ("k5b full", "cnn_chain_bwd"),
    ("k5b staging only", "cnn_chain_bwd"),
    ("k5b staging + level 3", "cnn_chain_bwd"),
    ("k5b staging + level 3 + dw2", "cnn_chain_bwd"),
    ("k5b no refills", "cnn_chain_bwd"),
    ("k5b d2 core tiles only", "cnn_chain_bwd"),
    ("k5b TW=32", "cnn_chain_bwd"),
    ("k5b TW=64", "cnn_chain_bwd"),
    ("k5b TW=64 stages=3", "cnn_chain_bwd"),
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
    """Within one family of copies (``k5`` and ``k5b`` cut one source, each
    on its own kernel's markers) no two copies are the same text: every cut
    took."""
    by_family = {}
    for name, (kernel, src) in kernel_phases.variants().items():
        by_family.setdefault((kernel, name.split()[0]), []).append(src)
    for family, srcs in by_family.items():
        assert len(set(srcs)) == len(srcs), family


def test_cut_raises_when_the_marker_is_gone():
    with pytest.raises(ValueError, match="kernel source changed"):
        kernel_phases.cut("int x;\n", "  // ---- level 3:", "")


@pytest.mark.parametrize("constant,attr", [("kTW", "_TILE_W"),
                                           ("kBTW", "_TILE_W_BF16")])
def test_chain_wrapper_tile_width_matches_the_kernel(constant, attr):
    """``ops/cnn.py`` sizes each dtype's grid from its own constant
    (``_TILE_W`` for f32, ``_TILE_W_BF16`` for bf16); each kernel walks
    tiles of its own width (``kTW``, ``kBTW``).  Each pair must agree."""
    m = re.search(rf"constexpr int {constant} = (\d+);",
                  _source("cnn_chain_bwd"))
    assert m is not None
    assert int(m.group(1)) == getattr(torch_cnn, attr)


@pytest.mark.parametrize("name,kernel", COPIES)
def test_each_copy_finds_the_headers_it_includes(name, kernel):
    """A copy is built from a temporary directory: every quoted include
    must resolve on the ``-I`` path that ``kernel_phases.nvcc_args`` gives
    nvcc."""
    _, src = kernel_phases.variants()[name]
    args = kernel_phases.nvcc_args("copy.cu", "copy.so")
    dirs = [args[i + 1] for i, a in enumerate(args) if a == "-I"]
    for header in re.findall(r'^\s*#\s*include\s+"([^"]+)"', src, re.M):
        assert any(os.path.isfile(os.path.join(d, header)) for d in dirs), \
            (name, header, dirs)


_KERNELS = ("attention", "attention_bwd", "cnn_dy3", "cnn_chain_bwd",
            "adjacency", "biased_attention", "structural_bias",
            "gated_message")
# each shared header, the kernels that include it, its cases' id prefix
_HEADERS = [("attention_common.cuh", ("attention", "attention_bwd"), ""),
            ("mma_bf16.cuh", ("cnn_dy3", "cnn_chain_bwd", "biased_attention"),
             "mma_bf16-")]


@pytest.mark.parametrize("header,kernel,follows", [
    pytest.param(h, k, k in users, id=f"{pre}{k}-{k in users}")
    for h, users, pre in _HEADERS for k in _KERNELS])
def test_library_path_follows_the_shared_header(tmp_path, monkeypatch,
                                                header, kernel, follows):
    """An edit to a shared header (``attention_common.cuh`` of the two
    attention kernels, ``mma_bf16.cuh`` of the two CNN kernels and the
    graph transformer's attention) gives each
    kernel that includes it a new library (no stale ``.so`` is loaded) and
    leaves the others'."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for fn in os.listdir(_build.CSRC_DIR):
        if fn.endswith((".cu", ".cuh")):
            shutil.copy(os.path.join(_build.CSRC_DIR, fn), csrc / fn)
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    before = _build.library_path(kernel)
    with open(csrc / header, "a") as fh:
        fh.write("// edited\n")
    assert (_build.library_path(kernel) != before) == follows
    headers = [os.path.basename(p) for p in _build.local_sources(kernel)]
    assert (header in headers) == follows


def _forward_launcher_constants():
    src = _source("attention")
    consts = {name: int(m.group(1)) for name in
              ("kRows", "kMaxWarps", "kSmemLimit")
              for m in [re.search(rf"constexpr \w+ {name} = (\d+);", src)]}
    body = re.search(r"int smem_floats\(int n, int fp, int tiles, "
                     r"int warps\) \{\n\s*return (.+);\n", src)
    assert body is not None
    return consts, body.group(1)


def test_forward_smem_formula_matches_the_launcher():
    """``ops/attention.py`` works out the forward's shared memory by the
    launcher's formula: the same constants, and the same value as the C
    expression (which is also Python) over the shapes it takes."""
    consts, expr = _forward_launcher_constants()
    assert consts["kRows"] == torch_attention._FWD_ROWS
    assert consts["kMaxWarps"] == torch_attention._FWD_MAX_WARPS
    assert consts["kSmemLimit"] == torch_attention._SMEM_LIMIT
    code = compile(expr, "smem_floats", "eval")
    for n in (1, 2, 3, 5, 37, 80, 84, 127, 128):
        for fp in (4, 12, 36, 100, 132):
            for tiles in (1, 2, 7, 20, 32):
                for warps in (1, 4, 10, 16):
                    assert eval(code, dict(consts, n=n, fp=fp, tiles=tiles,
                                           warps=warps)) == \
                        torch_attention._fwd_smem_floats(n, fp, tiles, warps)


@pytest.mark.parametrize("n,f", [(80, 35), (128, 35), (84, 128),
                                 (128, 128), (1, 1), (5, 3)])
def test_forward_fits_every_shape_it_takes(n, f):
    """The forward never refuses a shape ``_forward_fits`` accepts: at the
    least row-group count that fits, a block stays within 227 KB (N = F =
    128 needs two groups), and more groups never need more."""
    smem = torch_attention.forward_smem_bytes(n, f)
    assert smem <= 232448
    sizes = [torch_attention.forward_smem_bytes(n, f, g) for g in (1, 2, 3)]
    assert sizes == sorted(sizes, reverse=True)
    assert torch_attention._forward_fits(n, f)
    assert max(torch_attention.forward_smem_bytes(nn, ff)
               for nn in range(1, 129) for ff in (1, f, 128)) <= 232448


def _c_function(src, name):
    """A small integer helper of a launcher (``int name(int a, ...)``, its
    body one ``const int`` line or more and a ``return``) as a Python
    function: ``std::max``/``std::min`` become ``max``/``min`` and ``/``
    floor division, which is C's division on the non-negative ints these
    helpers take."""
    m = re.search(rf"^int {name}\(([^)]*)\) \{{\n?(.*?)\n?\}}\n", src,
                  re.M | re.S)
    assert m is not None, name
    args = [a.split()[-1] for a in m.group(1).split(",")]
    body = []
    for stmt in m.group(2).split(";"):
        stmt = stmt.strip()
        if not stmt:
            continue
        stmt = re.sub(r"std::(max|min)", r"\1", stmt).replace("/", "//")
        stmt = re.sub(r"^const int ", "", stmt)
        body.append("    " + stmt)
    code = f"def {name}({', '.join(args)}):\n" + "\n".join(body)
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr (?:int|size_t) (\w+) = (\d+);", src)}
    ns = dict(consts)
    exec(code, ns)
    return ns[name], consts


def test_adjacency_launcher_covers_every_row_within_its_block_limit():
    """``csrc/adjacency.cu``'s rule: ``row_groups`` (SMs over B, rounded,
    in 1..N), ``group_rows`` (rows of a group, with groups added until a
    block holds at most kMaxWarps warps of kRowsPerWarp rows) and
    ``warps_for``.  The Python wrapper sizes nothing itself; here the C
    helpers run over every N up to 400 and batches around the SM count:
    the grid covers each row once, no group is empty, no block passes
    kMaxWarps warps, and the rule picks the groups PERF.md reports at
    N=80 on 132 SMs: 2 groups of 40 rows at B=64, and at B=128 one group by
    the SM count, two by the block limit."""
    src = _source("adjacency")
    row_groups, consts = _c_function(src, "row_groups")
    group_rows, _ = _c_function(src, "group_rows")
    warps_for, _ = _c_function(src, "warps_for")
    assert consts["kMaxWarps"] * 32 <= 1024
    for batch in (1, 2, 3, 61, 64, 65, 100, 128, 133, 264, 300):
        for n in range(1, 401):
            rows = group_rows(n, row_groups(batch, n, 132))
            blocks = -(-n // rows)
            assert 1 <= rows <= n
            assert (blocks - 1) * rows < n <= blocks * rows
            assert 1 <= warps_for(rows) <= consts["kMaxWarps"]
    assert row_groups(64, 80, 132) == 2 and group_rows(80, 2) == 40
    assert row_groups(128, 80, 132) == 1 and group_rows(80, 1) == 40


def test_adjacency_kernel_has_no_atomics_and_no_n_limit():
    """Kernel 1 sums each cell in ascending edge order with no atomics,
    and its header states the edge count past which it reads the edges
    from global memory: kSmemLimit over 12 bytes an edge."""
    src = _source("adjacency")
    assert "atomic" not in src.lower()
    limit = int(re.search(r"constexpr size_t kSmemLimit = (\d+);",
                          src).group(1))
    assert re.search(r"size_t staged_smem\(int e\) \{ return \(size_t\)e "
                     r"\* 12; \}", src)
    assert f"E > {limit // 12:,}" in src
