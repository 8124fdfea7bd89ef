"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C entry point and is compiled on its
own into ``csrc/build/<name>-<hash>.so`` (git-ignored), at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o csrc/build/<name>-<hash>.so \
         csrc/<name>.cu

The hash covers the source, every local header it includes (a quoted
``#include`` of a file in ``csrc/``, such as ``attention_common.cuh``,
followed recursively) and the flags, so an edited source or header
rebuilds.
Nothing is built when a module is imported: the wrappers in
``ops/adjacency.py``, ``ops/attention.py`` and ``ops/cnn.py`` call
:func:`load` when they first launch on a CUDA tensor.  :func:`build_all` starts one ``nvcc`` per
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
from typing import Dict, Iterable, List

__all__ = ["KERNELS", "BUILD_DIR", "CSRC_DIR", "NVCC_FLAGS", "BUILD_LOGS",
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
}

_loaded: Dict[str, object] = {}
BUILD_LOGS: Dict[str, str] = {}    # kernel source -> nvcc output of its build


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


def library_path(name: str) -> str:
    return hashed_path(name, local_sources(name), NVCC_FLAGS)


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


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists."""
    return start_build([_nvcc(), *NVCC_FLAGS,
                        os.path.join(CSRC_DIR, name + ".cu")],
                       library_path(name))


def _finish(name: str, job) -> None:
    if job is not None:
        BUILD_LOGS[name] = finish_build(job, f"nvcc building csrc/{name}.cu")


def build_all(names: Iterable[str] = tuple(KERNELS)) -> List[str]:
    """Build every missing library with one ``nvcc`` per source, all
    started together; return the library paths."""
    names = list(names)
    jobs = [(n, _start(n)) for n in names]
    errors = []
    for n, job in jobs:
        try:
            _finish(n, job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return [library_path(n) for n in names]


def load(name: str):
    """The ctypes entry point of kernel ``name``, built if needed."""
    fn = _loaded.get(name)
    if fn is None:
        _finish(name, _start(name))
        symbol, argtypes = KERNELS[name]
        lib = ctypes.CDLL(library_path(name))
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn


def _demangle(symbol: str) -> str:
    """``name<N>`` of a mangled ``..._kernel`` (with its integer template
    argument, if any); the symbol itself when no such name is in it."""
    for i in range(len(symbol)):
        for j in range(i + 1, min(i + 3, len(symbol)) + 1):
            if not symbol[i:j].isdigit():
                break
            name = symbol[j:j + int(symbol[i:j])]
            if name.endswith("_kernel") and name.isidentifier():
                arg = re.match(r"ILi(\d+)E", symbol[j + len(name):])
                return name + (f"<{arg.group(1)}>" if arg else "")
    return symbol


def ptxas_report(name: str) -> List[str]:
    """``"<kernel>: <n> registers, <s> bytes spilled"`` for each kernel
    (template instantiations included) in the build log of ``name``;
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
