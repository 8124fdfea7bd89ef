"""The multi-process runtime of the port (``mgat_graphsage_tpu/parallel/
distributed.py`` on ``torch.distributed``): process-group start-up, the
per-host loading helpers, and the few collectives the mesh path runs.

A JAX process drives every local device; a PyTorch job is one process per
GPU.  So a job on 8 local GPUs is 8 processes here (``torchrun
--nproc-per-node 8``, or 8 launches with ``MGAT_PROCESS_ID`` 0..7), where
the reference runs one process over 8 devices.

Every collective is built from ``all_reduce`` and ``broadcast`` alone, so
each runs on NCCL and on gloo, with CUDA tensors too (gloo takes CUDA
tensors for these two only).  That is how two ranks share one card in
``chip_smoke.py``: NCCL refuses two ranks on one device.  Without an
initialised process group every collective is the identity, so the
mesh path runs in one process as it runs in many.

The batch statistics of the reference's SPMD program are global: XLA
partitions a program written for one device.  :func:`batch_shard` states,
for the span of a train step, which rows of the global batch this rank
holds and over which group the batch statistics are summed; the dropout
layers, the batch norms and the KL term read it
(:func:`current_batch_shard`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "initialize_distributed",
    "is_distributed",
    "host_row_slice",
    "global_batch_from_local",
    "all_reduce_sum",
    "copy_to_group",
    "gather_columns",
    "all_reduce_",
    "all_reduce_gradients",
    "BatchShard",
    "batch_shard",
    "current_batch_shard",
    "batch_sum",
]


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return None


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> None:
    """Start the default process group (idempotent).

    The arguments come from the caller, else from the reference's
    ``MGAT_COORDINATOR`` (``host:port``) / ``MGAT_NUM_PROCESSES`` /
    ``MGAT_PROCESS_ID``, else from torchrun's ``MASTER_ADDR`` /
    ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``: the counterpart of the
    TPU pod's auto-detection.  ``backend`` is NCCL where CUDA is
    available and gloo otherwise, unless given (gloo on CUDA tensors runs
    several ranks on one card).  Under NCCL the rank's device is
    ``cuda:{LOCAL_RANK % device_count}``, made current here."""
    if dist.is_initialized():
        return
    if coordinator_address is None:
        coordinator_address = os.environ.get("MGAT_COORDINATOR")
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("MGAT_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("MGAT_PROCESS_ID", "RANK")
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("initialize_distributed needs the coordinator's "
                         "host:port, the number of processes and this "
                         "process's id (arguments, MGAT_* or torchrun's "
                         "environment)")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device((process_id if local is None else local)
                              % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://"
                            f"{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id))


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def _rank_and_size() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_row_slice(n_rows: int,
                   process_index: Optional[int] = None,
                   process_count: Optional[int] = None) -> Tuple[int, int]:
    """This process's contiguous ``[start, stop)`` slice of a dataset with
    ``n_rows`` rows, so each process featurises only its rows.  The split
    is as even as possible; early processes take the remainder."""
    rank, size = _rank_and_size()
    pi = rank if process_index is None else process_index
    pc = size if process_count is None else process_count
    base, rem = divmod(n_rows, pc)
    start = pi * base + min(pi, rem)
    stop = start + base + (1 if pi < rem else 0)
    return start, stop


def _live(group) -> bool:
    """Whether collectives run: a process group is up (``group`` is one
    of its groups, or None for the world)."""
    return dist.is_available() and dist.is_initialized()


def _group_ranks(group) -> Sequence[int]:
    if group is None or group is dist.group.WORLD:
        return list(range(dist.get_world_size()))
    return dist.get_process_group_ranks(group)


def _comm_device() -> torch.device:
    """Where host-side data goes for a collective: the current card under
    NCCL, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_batch_from_local(mesh: Any, local: Any,
                            axis_name: str = "data") -> Any:
    """Each process passes ITS rows (a dict, list or tuple of numpy
    arrays, or one array) and gets the leaves concatenated across the
    processes of the mesh's data axis, in rank order: the global batch
    that ``make_array_from_process_local_data`` assembles in the
    reference.  The rows move by ``broadcast``, bit for bit."""
    if isinstance(local, dict):
        return {k: global_batch_from_local(mesh, v, axis_name)
                for k, v in local.items()}
    if isinstance(local, (list, tuple)):
        return type(local)(global_batch_from_local(mesh, v, axis_name)
                           for v in local)
    arr = np.ascontiguousarray(local)
    group = None if mesh is None else mesh.data_group
    if not _live(group):
        return arr
    ranks = _group_ranks(group)
    dev = _comm_device()
    me = ranks.index(dist.get_rank())
    counts = torch.zeros(len(ranks), dtype=torch.int64, device=dev)
    counts[me] = arr.shape[0]
    dist.all_reduce(counts, group=group)
    row = int(np.prod(arr.shape[1:], dtype=np.int64))
    mine = arr.reshape(arr.shape[0], row).view(np.uint8)
    parts = []
    for i, src in enumerate(ranks):
        n = int(counts[i])
        buf = (torch.from_numpy(mine.copy()).to(dev) if i == me
               else torch.empty((n, row * arr.itemsize), dtype=torch.uint8,
                                device=dev))
        dist.broadcast(buf, src=src, group=group)
        parts.append(buf.cpu().numpy())
    rows = np.concatenate(parts, axis=0)
    return rows.view(arr.dtype).reshape((-1,) + arr.shape[1:])


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """In-place SUM over ``group`` (the identity without a process
    group); returns ``t``."""
    if _live(group):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """Forward: SUM over the group.  Backward: SUM of the gradients over
    the group (each rank's output is the same sum, so each rank's input
    feeds every rank's loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(memory_format=torch.contiguous_format),
                           group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(memory_format=torch.contiguous_format),
                           ctx.group), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable SUM of ``x`` over ``group``."""
    return _AllReduceSum.apply(x, group)


class _CopyToGroup(torch.autograd.Function):
    """Megatron's ``f``: identity forward, SUM of the gradient over the
    group backward.  It stands before a column-split product whose input
    every rank of the group holds whole."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(memory_format=torch.contiguous_format),
                           ctx.group), None


def copy_to_group(x: torch.Tensor, group=None) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


class _GatherColumns(torch.autograd.Function):
    """Megatron's ``g`` for a column split: each rank writes its columns
    into a zero-filled ``[b, total]`` buffer and the buffer is summed over
    the group (one ``all_reduce``, so gloo runs it on CUDA tensors).
    Backward: this rank's columns of the gradient."""

    @staticmethod
    def forward(ctx, x, group, offset, total):
        ctx.cols = (offset, offset + x.shape[-1])
        out = x.new_zeros(x.shape[:-1] + (total,))
        out[..., offset:offset + x.shape[-1]] = x
        return all_reduce_(out, group)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.cols
        return g[..., lo:hi].contiguous(), None, None, None


def gather_columns(x: torch.Tensor, group, offset: int,
                   total: int) -> torch.Tensor:
    """``x [..., h]``, this rank's columns ``[offset, offset + h)`` of a
    ``[..., total]`` tensor -> the whole tensor on every rank of
    ``group``."""
    return _GatherColumns.apply(x, group, offset, total)


def all_reduce_gradients(tensors: Sequence[torch.Tensor], group=None,
                         bucket_elems: int = 1 << 25) -> None:
    """Sum the ``.grad`` of ``tensors`` over ``group`` in place, in
    flattened buckets of at most ``bucket_elems`` elements, one dtype a
    bucket, summed in that dtype (bf16 in bf16, as the reference sums
    them; gloo takes bf16 on the CPU and on CUDA tensors).  Every rank
    must pass its tensors in the same order, with the same gradients
    present.  A group of one rank sums nothing, so no collective
    runs."""
    if not _live(group) or dist.get_world_size(group) == 1:
        return
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        if t.grad is not None:
            by_dtype.setdefault(t.grad.dtype, []).append(t.grad)
    for grads in by_dtype.values():
        bucket, n = [], 0
        for g in grads + [None]:
            if g is not None and (not bucket or
                                  n + g.numel() <= bucket_elems):
                bucket.append(g)
                n += g.numel()
                continue
            if bucket:
                flat = all_reduce_(torch.cat([b.reshape(-1)
                                              for b in bucket]), group)
                torch._foreach_copy_(bucket, [
                    s.view_as(b) for s, b in zip(
                        flat.split([b.numel() for b in bucket]), bucket)])
            bucket, n = ([g], g.numel()) if g is not None else ([], 0)


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """This rank's rows ``[offset, offset + local rows)`` of a global batch
    of ``rows``; the batch statistics are summed over ``group``."""
    rows: int
    offset: int
    group: Any = None


_SHARD: Optional[BatchShard] = None


@contextlib.contextmanager
def batch_shard(rows: int, offset: int, group=None) -> Iterator[BatchShard]:
    """State, inside the block, that the model sees rows ``[offset, ...)``
    of a global batch of ``rows`` (see the module's docstring)."""
    global _SHARD
    prev, _SHARD = _SHARD, BatchShard(int(rows), int(offset), group)
    try:
        yield _SHARD
    finally:
        _SHARD = prev


def current_batch_shard() -> Optional[BatchShard]:
    return _SHARD


def batch_sum(t: torch.Tensor, shard: Optional[BatchShard]) -> torch.Tensor:
    """``t``, a sum over this rank's rows, summed over the shard's group
    (differentiable); ``t`` itself outside a batch shard."""
    return t if shard is None else all_reduce_sum(t, shard.group)
