"""ctypes binding of the native C++ featurizer (``csrc/featurizer.cpp``).

Featurisation is the host side of every serving call and dataset build.
The C++ library computes the same graphs and Morgan fingerprints as the
Python chemistry layer (``chem/smiles.py``, ``chem/featurize.py``,
``chem/fingerprints.py``), bit for bit (``tests/test_torch_native.py``),
at a multiple of its rate (``PERF.md``).

The library is built with the host ``g++`` at first use,

    g++ -O3 -shared -fPIC -std=c++17 -pthread csrc/featurizer.cpp \\
        -o csrc/build/featurizer-<hash>.so

named by a hash of the source and the flags and moved into place from a
temporary file of the building process (``ops/_build.py``), so concurrent
builds are safe.  Nothing falls back silently: a failed build or load
raises with the compiler's or the loader's message.  The Python path runs
only where a caller asks for it (``MolecularDataset(use_native=False)``)
or for a configuration the library does not cover
(``MolecularDataset._featurize_native``).  The library keeps no mutable
state, so threads may call it at once (ctypes releases the GIL).

One batch call runs its molecules on several worker threads of the
library's own: ``max(1, min(usable CPUs, n // 64))`` of them for ``n``
SMILES (:func:`worker_count`), so each worker has at least 64 molecules
(~10 ms) and a call of under 128 runs on the calling thread alone.  The
workers take blocks of 16 molecules from one shared cursor and write only
their molecules' slots, so the outputs are the same bytes for any count.
The library joins every worker before the call returns: no thread, pool
or state outlives a call, and a ``fork`` after one is safe.
``featurize_structure_native`` is the same call with, per molecule, what
the graph transformer reads beside the features (a bond type per edge,
the degrees, the shortest-path distances and the first bond types along
each path; ``chem/featurize.py::graph_structure``, bit for bit).
``featurize_batch_native`` counts its ``calls``, ``parallel_calls`` (more
than one worker), ``molecules`` and ``workers`` (summed over calls; the
workers the library reports it ran, never more than its blocks of 16),
which ``utils/telemetry.snapshot()`` reports under ``"featurize"``.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops import _build

__all__ = ["native_available", "featurize_batch_native",
           "featurize_structure_native", "get_lib",
           "usable_cpus", "worker_count", "counts", "COUNTERS", "GXX_FLAGS",
           "SOURCE"]

SOURCE = os.path.join(_build.CSRC_DIR, "featurizer.cpp")
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
# the least molecules a worker takes: ~10 ms at ~160 us a molecule, far
# above a thread's start
MIN_PER_WORKER = 64
CGROUP_CPU_MAX = "/sys/fs/cgroup/cpu.max"
COUNTERS = ("calls", "parallel_calls", "molecules", "workers")

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib = None

_P_I32 = ctypes.POINTER(ctypes.c_int32)
_P_F32 = ctypes.POINTER(ctypes.c_float)
_P_I8 = ctypes.POINTER(ctypes.c_int8)


def library_path() -> str:
    return _build.hashed_path("featurizer", [SOURCE], GXX_FLAGS)


def get_lib():
    """The loaded library, built first if needed.  Raises
    ``RuntimeError`` when ``g++`` fails (with its output) and ``OSError``
    when the library does not load."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            out = library_path()
            _build.finish_build(
                _build.start_build(["g++", *GXX_FLAGS, SOURCE], out),
                "g++ building csrc/featurizer.cpp")
            lib = ctypes.CDLL(out)
            lib.mgat_featurize_batch.restype = ctypes.c_int
            lib.mgat_featurize_batch.argtypes = [
                ctypes.c_char_p, _P_I32,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                _P_F32, _P_I32, _P_I32, _P_F32,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, _P_I32,
                ctypes.c_int,
            ]
            lib.mgat_featurize_batch_structure.restype = ctypes.c_int
            lib.mgat_featurize_batch_structure.argtypes = \
                lib.mgat_featurize_batch.argtypes + [
                    ctypes.c_int, _P_I8, _P_I8, _P_I8, _P_I8]
            _lib = lib
    return _lib


def native_available() -> bool:
    """Whether the library builds and loads here (a probe: it raises
    nothing; :func:`get_lib` says why it does not)."""
    try:
        get_lib()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(a: Optional[np.ndarray], kind):
    return None if a is None else a.ctypes.data_as(kind)


def usable_cpus() -> int:
    """The CPUs this process may run on (its affinity), or fewer where a
    cgroup v2 quota (``cpu.max``: quota and period) allows less."""
    n = len(os.sched_getaffinity(0))
    try:
        with open(CGROUP_CPU_MAX) as f:
            quota, period = f.read().split()[:2]
        if quota == "max":
            return n
        return max(1, min(n, -(-int(quota) // int(period))))
    except (OSError, ValueError, ZeroDivisionError):
        return n


def worker_count(n: int) -> int:
    """The library's workers for a call of ``n`` SMILES: every worker gets
    at least :data:`MIN_PER_WORKER` of them, and there are no more than
    :func:`usable_cpus`; 1 below ``2 * MIN_PER_WORKER``."""
    if n < 2 * MIN_PER_WORKER:
        return 1
    return min(usable_cpus(), n // MIN_PER_WORKER)


def featurize_batch_native(
    smiles_list: List[str],
    feat_dim: int,
    max_nodes: int,
    max_edges: int,
    fp_bits: int = 0,
    fp_radius: int = 2,
    use_features: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
           Optional[np.ndarray], np.ndarray]:
    """Featurise a batch of SMILES with the native library.

    Returns ``(nodes [n, max_nodes, feat_dim], edges [n, 2, max_edges],
    node_mask, edge_mask, fp [n, fp_bits] or None, status [n])`` where
    ``status[i]`` is the atom count, -1 for a SMILES that does not parse,
    -2 past ``max_nodes`` and -3 past ``max_edges``.

    The library runs the call on :func:`worker_count` threads of the
    call's size, the calling one among them, and joins them before it
    returns.  The outputs are the same bytes for any count.  Raises
    ``RuntimeError`` when the library reports a failure (a worker ran out
    of memory).
    """
    return _batch(smiles_list, feat_dim, max_nodes, max_edges, fp_bits,
                  fp_radius, use_features, 0)[:6]


def featurize_structure_native(
    smiles_list: List[str],
    feat_dim: int,
    max_nodes: int,
    max_edges: int,
    fp_bits: int = 0,
    fp_radius: int = 2,
    use_features: bool = False,
    hops: int = 5,
) -> Tuple:
    """:func:`featurize_batch_native`'s six arrays, then ``edge_types [n,
    max_edges]``, ``degree [n, max_nodes]``, ``spd [n, max_nodes,
    max_nodes]`` and ``path_types [n, max_nodes, max_nodes, hops]``, all
    int8 (``chem/featurize.py::bond_types`` and ``::graph_structure``, bit
    for bit; padding is 0, and -1 in ``spd``).  One batch call, on the same
    workers and counted alike."""
    if hops < 1:
        raise ValueError(f"hops={hops}; expected 1 or more")
    return _batch(smiles_list, feat_dim, max_nodes, max_edges, fp_bits,
                  fp_radius, use_features, hops)


def _batch(smiles_list, feat_dim, max_nodes, max_edges, fp_bits, fp_radius,
           use_features, hops):
    lib = get_lib()
    n = len(smiles_list)
    # the library reads each SMILES up to its NUL, so one holding a NUL
    # would be read cut short; it goes in empty, which fails to parse (-1)
    # as the Python parser fails on the NUL
    encoded = [b"" if "\x00" in s else s.encode("utf-8")
               for s in smiles_list]
    blob = b"\x00".join(encoded) + b"\x00"
    lengths = np.fromiter((len(e) + 1 for e in encoded), np.int64, n)
    offsets = np.zeros(n, np.int32)
    if n:
        offsets[1:] = np.cumsum(lengths)[:-1]

    nodes = np.zeros((n, max_nodes, feat_dim), np.float32)
    edges = np.zeros((n, 2, max_edges), np.int32)
    n_edges = np.zeros(n, np.int32)
    fp = np.zeros((n, fp_bits), np.float32) if fp_bits else None
    status = np.zeros(n, np.int32)
    workers = worker_count(n)
    args = [blob, _ptr(offsets, _P_I32), n, feat_dim, max_nodes, max_edges,
            _ptr(nodes, _P_F32), _ptr(edges, _P_I32), _ptr(n_edges, _P_I32),
            _ptr(fp, _P_F32), fp_bits, fp_radius, 1 if use_features else 0,
            _ptr(status, _P_I32), workers]
    extra = ()
    if hops:
        # padding as the library leaves a molecule that fails
        extra = (np.zeros((n, max_edges), np.int8),
                 np.zeros((n, max_nodes), np.int8),
                 np.full((n, max_nodes, max_nodes), -1, np.int8),
                 np.zeros((n, max_nodes, max_nodes, hops), np.int8))
        ran = lib.mgat_featurize_batch_structure(
            *args, hops, *(_ptr(a, _P_I8) for a in extra))
    else:
        ran = lib.mgat_featurize_batch(*args)
    if ran < 1:
        raise RuntimeError(
            f"the native featuriser failed on a batch of {n} SMILES "
            f"({workers} workers): code {ran}")
    with _count_lock:
        featurize_batch_native.calls += 1
        featurize_batch_native.parallel_calls += int(ran > 1)
        featurize_batch_native.molecules += n
        featurize_batch_native.workers += ran

    ok = status > 0
    node_mask = (np.arange(max_nodes) < np.where(ok, status, 0)[:, None]
                 ).astype(np.float32)
    edge_mask = (np.arange(max_edges) < np.where(ok, n_edges, 0)[:, None]
                 ).astype(np.float32)
    return (nodes, edges, node_mask, edge_mask, fp, status) + extra


def counts() -> Dict[str, int]:
    """The process's totals of :data:`COUNTERS` over the batch calls,
    read together."""
    with _count_lock:
        return {name: getattr(featurize_batch_native, name)
                for name in COUNTERS}


featurize_batch_native.calls = 0
featurize_batch_native.parallel_calls = 0
featurize_batch_native.molecules = 0
featurize_batch_native.workers = 0
