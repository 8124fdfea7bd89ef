"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C entry point and is compiled on its
own into ``csrc/build/<name>-<hash>.so`` (git-ignored), at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o csrc/build/<name>-<hash>.so \
         csrc/<name>.cu

The hash covers the source, every local header it includes (a quoted
``#include`` of a file in ``csrc/``, such as ``attention_common.cuh``,
followed recursively) and the flags, so an edited source or header
rebuilds.  A source of :data:`VARIANTS` (``csrc/gated_attention.cu``) is
built into one library per variant, its ``-D`` macros among the flags
(and so in the hash), so a process compiles only what it launches.
Nothing is built when a module is imported: the wrappers in
``ops/adjacency.py``, ``ops/attention.py``, ``ops/cnn.py``,
``ops/biased_attention.py`` (the biased and the gated attention),
``ops/structural_bias.py`` and ``ops/gated_message.py`` call
:func:`load` when they first launch on a
CUDA tensor.  :func:`build_all` starts one ``nvcc`` per
source at once, for callers that want every kernel ready up front.
``nvcc`` is found through ``$CUDA_HOME``, then ``$PATH``, then the
toolkit's standard location.  A failed build raises with nvcc's output;
a build's output (ptxas's registers and spills per kernel) is kept in
:data:`BUILD_LOGS` and summarised by :func:`ptxas_report`.

:func:`hashed_path`, :func:`start_build` and :func:`finish_build` (a
content-hashed name, a per-process temporary file moved into place with
``os.replace``) also build the host featuriser (``chem/native.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["KERNELS", "ENTRIES", "VARIANTS", "BUILD_DIR", "CSRC_DIR",
           "NVCC_FLAGS", "BUILD_LOGS",
           "load", "build_all", "library_path", "local_sources",
           "ptxas_report", "hashed_path", "start_build", "finish_build"]

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.environ.get("MGAT_TORCH_BUILD_DIR",
                           os.path.join(CSRC_DIR, "build"))
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# entry point and its argtypes for every kernel source
KERNELS: Dict[str, tuple] = {
    "adjacency": ("dense_adjacency_launch",
                  [_P, _P, _P, _I, _I, _I, _P]),
    "attention": ("masked_attention_launch",
                  [_P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _I, _P]),
    "attention_bwd": ("masked_attention_bwd_launch",
                      [_P] * 8 + [_I, _I, _I, ctypes.c_float, _I, _P]),
    "cnn_dy3": ("cnn_dy3_launch", [_P, _P, _P, _P, _I, _I, _I, _P]),
    "cnn_chain_bwd": ("cnn_chain_bwd_launch", [_P] * 8 + [_I, _I, _I, _P]),
    "biased_attention": ("biased_attention_fwd_launch",
                         [_P] * 8 + [_I] * 4 + [_L] * 3 + [_F, _F, _P]),
    "structural_bias": ("structural_bias_fwd_launch",
                        [_P] * 6 + [_I] * 5 + [_P]),
    "gated_message": ("gated_message_fwd_launch",
                      [_P] * 8 + [_I] * 5 + [_P]),
    "gated_attention": ("gated_attention_fwd_launch",
                        [_P] * 11 + [_I] * 4 + [_L] * 3 + [_F] * 3
                        + [_I, _P]),
}
# further entry points of a source (bf16 variants, a backward): symbol ->
# argtypes
ENTRIES: Dict[str, list] = {
    "cnn_dy3_bf16_launch": KERNELS["cnn_dy3"][1],
    "cnn_chain_bwd_bf16_launch": KERNELS["cnn_chain_bwd"][1],
    # the backward of csrc/biased_attention.cu
    "biased_attention_bwd_launch": [_P] * 13 + [_I] * 4 + [_L] * 9
    + [_F, _F, _P],
    # the backward of csrc/structural_bias.cu: its grid, then its launches
    "structural_bias_bwd_blocks": [_I] * 5,
    "structural_bias_bwd_launch": [_P] * 7 + [_I] * 6 + [_P],
    # the backward of csrc/gated_message.cu
    "gated_message_bwd_launch": [_P] * 12 + [_I] * 5 + [_P],
    # the backward of csrc/gated_attention.cu
    "gated_attention_bwd_launch": [_P] * 17 + [_I] * 4 + [_L] * 9
    + [_F] * 3 + [_I, _P],
}

# sources built as one library per variant, each the instantiation its
# -D macros name: source -> macro names.  csrc/gated_attention.cu's tile
# shapes (KT, d / 8) take ~10 s each to compile, so a process builds only
# the shapes it launches, and every caller names the variant.
VARIANTS: Dict[str, Tuple[str, ...]] = {
    "gated_attention": ("GATED_KT", "GATED_D8"),
}

_loaded: Dict[tuple, object] = {}
BUILD_LOGS: Dict[str, str] = {}    # kernel source -> nvcc output of its builds


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's CUDA kernels")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def local_sources(name: str) -> List[str]:
    """``csrc/<name>.cu`` and the local headers it includes, recursively,
    in the order first met."""
    todo, seen = [name + ".cu"], []
    while todo:
        rel = todo.pop(0)
        if rel in seen:
            continue
        seen.append(rel)
        with open(os.path.join(CSRC_DIR, rel), "rb") as f:
            text = f.read()
        todo += [m.decode() for m in _INCLUDE.findall(text)
                 if os.path.isfile(os.path.join(CSRC_DIR, m.decode()))]
    return [os.path.join(CSRC_DIR, rel) for rel in seen]


def hashed_path(stem: str, sources: Iterable[str], flags: Iterable[str]
                ) -> str:
    """``BUILD_DIR/<stem>-<hash>.so``, the hash over the sources' bytes
    and the flags: an edited source, header or flag names a new file."""
    h = hashlib.sha1()
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:12]}.so")


def _flags(name: str, variant: Optional[Tuple[int, ...]]) -> List[str]:
    """nvcc's flags for ``name``: :data:`NVCC_FLAGS`, and for a source of
    :data:`VARIANTS` the -D macros of ``variant``, which it requires."""
    if name not in VARIANTS:
        return list(NVCC_FLAGS)
    macros = VARIANTS[name]
    if variant is None or len(variant) != len(macros):
        raise ValueError(f"csrc/{name}.cu is built one variant at a time: "
                         f"give values of {', '.join(macros)}")
    return NVCC_FLAGS + [f"-D{m}={v}" for m, v in zip(macros, variant)]


def library_path(name: str, variant: Optional[Tuple[int, ...]] = None
                 ) -> str:
    return hashed_path(name, local_sources(name), _flags(name, variant))


def start_build(cmd: List[str], out: str):
    """Start ``cmd -o <tmp>`` unless ``out`` exists; return the job for
    :func:`finish_build`, or None.  The temporary name is the process's and
    the thread's own, so builds that race (test workers, request threads)
    never write one file."""
    if os.path.exists(out):
        return None
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.Popen([*cmd, "-o", tmp], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def finish_build(job, what: str) -> str:
    """Wait for a :func:`start_build` job and move its output into place;
    return the compiler's output ("" for no job).  Raises with that output
    when the compiler fails."""
    if job is None:
        return ""
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"{what} failed (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return log


def _start(name: str, variant: Optional[Tuple[int, ...]] = None):
    """Start nvcc for ``name`` (``variant`` of it) unless its library
    exists."""
    return start_build([_nvcc(), *_flags(name, variant),
                        os.path.join(CSRC_DIR, name + ".cu")],
                       library_path(name, variant))


def _finish(name: str, job) -> None:
    if job is not None:
        log = finish_build(job, f"nvcc building csrc/{name}.cu")
        BUILD_LOGS[name] = BUILD_LOGS.get(name, "") + log


def build_all(names: Iterable = tuple(n for n in KERNELS
                                     if n not in VARIANTS)) -> List[str]:
    """Build every missing library with one ``nvcc`` each, all started
    together; return the library paths.  An entry of ``names`` is a
    source's name, or for a source of :data:`VARIANTS` a ``(name,
    variant)`` pair; by default every source but those."""
    items = [(n, None) if isinstance(n, str) else (n[0], tuple(n[1]))
             for n in names]
    jobs = [(n, _start(n, v)) for n, v in items]
    errors = []
    for n, job in jobs:
        try:
            _finish(n, job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return [library_path(n, v) for n, v in items]


def load(name: str, symbol: str = "",
         variant: Optional[Tuple[int, ...]] = None):
    """The ctypes entry point of kernel source ``name`` (``variant`` of a
    source of :data:`VARIANTS`), built if needed: its first
    (``KERNELS``), or ``symbol`` (one of ``ENTRIES``)."""
    symbol = symbol or KERNELS[name][0]
    key = (symbol, None if variant is None else tuple(variant))
    fn = _loaded.get(key)
    if fn is None:
        _finish(name, _start(name, variant))
        lib = ctypes.CDLL(library_path(name, variant))
        fn = getattr(lib, symbol)
        fn.argtypes = KERNELS[name][1] if symbol == KERNELS[name][0] \
            else ENTRIES[symbol]
        fn.restype = ctypes.c_int
        _loaded[key] = fn
    return fn


_TYPE_ARGS = {"f": "float", "13__nv_bfloat16": "bf16"}


def _demangle(symbol: str) -> str:
    """``name<N>`` of a mangled ``..._kernel`` (with its integer template
    arguments, ``name<N, M>``, or ``<float>`` / ``<bf16>`` for its storage
    type, if any); the symbol itself when no such name is in it."""
    for i in range(len(symbol)):
        for j in range(i + 1, min(i + 3, len(symbol)) + 1):
            if not symbol[i:j].isdigit():
                break
            name = symbol[j:j + int(symbol[i:j])]
            if name.endswith("_kernel") and name.isidentifier():
                rest = symbol[j + len(name):]
                arg = re.match(r"I((?:Li\d+E)+)", rest)
                if arg:
                    ints = re.findall(r"Li(\d+)E", arg.group(1))
                    return f"{name}<{', '.join(ints)}>"
                arg = re.match(r"I(f|13__nv_bfloat16)E", rest)
                return name + (f"<{_TYPE_ARGS[arg.group(1)]}>" if arg else "")
    return symbol


def ptxas_report(name: str) -> List[str]:
    """``"<kernel>: <n> registers, <s> bytes spilled"`` for each kernel
    (template instantiations included) in the build logs of ``name``;
    empty if this process did not build it."""
    out, kernel, spill = [], None, 0
    for line in BUILD_LOGS.get(name, "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = _demangle(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            out.append(f"{kernel}: {m.group(1)} registers, {spill} bytes "
                       "spilled")
    return out
