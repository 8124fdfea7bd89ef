"""The device mesh of the port (``mgat_graphsage_tpu/parallel/mesh.py`` on
``torch.distributed``): data parallel, and the column split over a
``model`` axis of every layer the reference's rule splits (the big
linear layers: the CNN fc1 of the hybrids, and ``fc_g1``, a combined
``fc1`` or the CNN fc2 where they are big enough).

The reference partitions one program with GSPMD.  Here each rank runs
the step on its rows, and the trainer says where the ranks meet
(``train/trainer.py``): the batch statistics and the loss's normalisers
are summed over the data axis, the gradients are summed over it after the
backward, and each split layer gathers its columns over the model axis
(``parallel/distributed.py``).

Ranks are laid out as the reference lays out devices
(``devices.reshape(-1, model_parallel)``): rank ``r`` has data coordinate
``r // k`` and model coordinate ``r % k``.  The ``k`` ranks of one model
group hold the same rows and each holds ``1/k`` of every split layer's
output columns (and of their Adam moments, since the optimizer holds the
local parameter).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

__all__ = ["Mesh", "make_mesh", "shard_batch", "replicate",
           "data_parallel_specs", "param_shardings", "shard_state",
           "shard_rows", "gather_rows", "ColumnSplit"]


class Mesh:
    """``shape`` (``{"data": P}`` or ``{"data": P/k, "model": k}``), this
    rank's ``coords`` on each axis, and the process groups of its data
    axis (the ranks that share its model coordinate) and of its model
    axis (the ranks that share its rows).  Without a process group the
    mesh holds one rank and no group."""

    def __init__(self, shape: Dict[str, int], coords: Dict[str, int],
                 data_group: Any = None, model_group: Any = None,
                 model_ranks: Sequence[int] = (0,)):
        self.shape = dict(shape)
        self.coords = dict(coords)
        self.data_group = data_group
        self.model_group = model_group
        self.model_ranks = tuple(model_ranks)

    def __deepcopy__(self, memo):
        return self           # process groups are handles, not state

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, coords={self.coords})"


def make_mesh(model_parallel: int = 1, axis_name: str = "data") -> Mesh:
    """A mesh over every rank of the default process group (or over this
    one process where none is initialised); ``model_parallel=k`` makes it
    2-D ``(data, model)`` with k-way column splits.  Every rank must call
    it, in the same order as its other collectives."""
    up = dist.is_available() and dist.is_initialized()
    rank, size = (dist.get_rank(), dist.get_world_size()) if up else (0, 1)
    k = int(model_parallel)
    if k > 1 and size % k:
        raise ValueError(f"{size} devices not divisible by "
                         f"model_parallel={k}")
    if k <= 1:
        return Mesh({axis_name: size}, {axis_name: rank},
                    data_group=dist.group.WORLD if up else None,
                    model_ranks=(rank,))
    data_group = model_group = None
    model_ranks: Tuple[int, ...] = ()
    if up:
        # every rank creates every group, in one order
        for i in range(size // k):
            ranks = [i * k + j for j in range(k)]
            g = dist.new_group(ranks)
            if rank in ranks:
                model_group, model_ranks = g, tuple(ranks)
        for j in range(k):
            ranks = [i * k + j for i in range(size // k)]
            g = dist.new_group(ranks)
            if rank in ranks:
                data_group = g
    else:
        model_ranks = (0,)
    return Mesh({axis_name: size // k, "model": k},
                {axis_name: rank // k, "model": rank % k},
                data_group=data_group, model_group=model_group,
                model_ranks=model_ranks)


def _model_ways(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else int(mesh.shape.get("model", 1))


def param_shardings(mesh: Mesh, model: nn.Module,
                    min_elements: int = 1 << 20) -> Dict[str, Optional[int]]:
    """Parameter name -> the dimension split over the ``model`` axis, or
    None (replicated).  The reference's rule (2-D kernels of at least
    ``min_elements`` whose output dimension divides the axis are
    column-split) in the port's layout: ``nn.Linear.weight`` is ``[out,
    in]``, so the split is dim 0, and the layer's bias follows it.  In the
    flagship that is ``cnn.fc1.weight`` ``[256, 131072]`` and
    ``cnn.fc1.bias``; ``model1`` and ``gat_gcn`` split ``fc_g1`` ``[1500,
    700]`` (k = 2, 4), ``morgan2048`` also ``combined.fc1`` ``[512,
    2049]``, and ``ecfp2048`` ``cnn.fc1``, ``cnn.fc2`` ``[2048, 512]`` and
    ``combined.fc1``.  On a mesh without a model axis nothing is split."""
    k = _model_ways(mesh)
    params = dict(model.named_parameters())
    out: Dict[str, Optional[int]] = {n: None for n in params}
    if k <= 1:
        return out
    for name, p in params.items():
        if p.dim() == 2 and p.numel() >= min_elements \
                and p.shape[0] % k == 0:
            out[name] = 0
            if name.endswith(".weight"):
                bias = name[:-len("weight")] + "bias"
                if bias in params:
                    out[bias] = 0
    return out


class ColumnSplit:
    """What one layer needs to run column-split: the model axis's group,
    this rank's first output column, and the layer's whole width."""

    def __init__(self, group: Any, offset: int, total: int):
        self.group, self.offset, self.total = group, int(offset), int(total)

    def __deepcopy__(self, memo):
        return self


def shard_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block of rows of ``t`` (split on dim 0 over the model
    axis), as a new tensor."""
    k = _model_ways(mesh)
    rows = t.shape[0] // k
    lo = mesh.coords.get("model", 0) * rows
    return t[lo:lo + rows].clone()


def gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from each model rank's block of rows (dim 0), on
    every rank of the model group, bit for bit (one ``broadcast`` a
    block)."""
    k = _model_ways(mesh)
    if k <= 1:
        return t
    me = mesh.coords["model"]
    parts = []
    for j, src in enumerate(mesh.model_ranks):
        buf = t.detach().clone() if j == me else torch.empty_like(t)
        dist.broadcast(buf, src=src, group=mesh.model_group)
        parts.append(buf)
    return torch.cat(parts, 0)


def shard_state(model: nn.Module, mesh: Mesh,
                min_elements: int = 1 << 20) -> nn.Module:
    """Split ``model``'s parameters per :func:`param_shardings`, in place:
    each split parameter is replaced by this rank's rows, and every layer
    the reference's rule splits is given its own ``column_split`` (its
    width and this rank's offset in it), which its forward runs
    (``models/layers.py::TorchLinear``).  Build the optimizer after this
    call.  Identity on a mesh without a model axis.  Raises
    ``NotImplementedError`` where a parameter to split sits in a layer
    with no column-split forward."""
    k = _model_ways(mesh)
    dims = param_shardings(mesh, model, min_elements)
    for name, dim in dims.items():
        if dim is None:
            continue
        path, _, attr = name.rpartition(".")
        layer = model.get_submodule(path)
        if not hasattr(layer, "column_split"):
            raise NotImplementedError(
                f"{name} would be column-split, but {type(layer).__name__} "
                "has no column-split forward (TorchLinear has one)")
        p = getattr(layer, attr)
        if attr == "weight":
            total = p.shape[0]
            layer.column_split = ColumnSplit(
                mesh.model_group, mesh.coords["model"] * (total // k), total)
        setattr(layer, attr, nn.Parameter(shard_rows(p.detach(), mesh),
                                          requires_grad=p.requires_grad))
    return model


def replicate(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Make every parameter and buffer of ``model`` rank 0's, in place
    (one ``broadcast`` each over the world); identity without a process
    group.  The trainer draws the same weights on every rank from the
    seed, so its path does not need this."""
    if not (dist.is_available() and dist.is_initialized()):
        return model
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t.data, src=0)
    return model


def data_parallel_specs(mesh: Mesh, axis_name: str = "data"):
    """``(batch_spec, replicated_spec)`` in :func:`param_shardings`'s
    terms: a batch leaf is split on dim 0 over the data axis, a
    replicated one on none."""
    return 0, None


def shard_batch(batch: Any, mesh: Mesh, axis_name: str = "data") -> Any:
    """This rank's contiguous rows of every leaf of a global batch (a
    dict, list or tuple of tensors or arrays, or one): rows ``[d * b,
    (d + 1) * b)`` for data coordinate ``d`` and ``b = rows / P_data``."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh, axis_name) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh, axis_name) for v in batch)
    p = mesh.shape[axis_name]
    if batch.shape[0] % p:
        raise ValueError(f"a batch of {batch.shape[0]} rows does not split "
                         f"over data-axis size {p}")
    b = batch.shape[0] // p
    lo = mesh.coords[axis_name] * b
    return batch[lo:lo + b]
