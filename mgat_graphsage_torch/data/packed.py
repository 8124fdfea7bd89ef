"""Device-resident datasets and their batches, plain or in compact
storage (port of ``mgat_graphsage_tpu/data/packed.py``).

The trainer and the predictor keep the featurised dataset on the device
and gather each batch there (:func:`batches`).  ``dataset_storage=
"compact"`` packs it into the smallest exact representation and unpacks
each batch on the device:

====================  =========================  =====================
stream                plain                      compact
====================  =========================  =====================
nodes                 ``[n, N, F]`` float32      ``[n, N, F]`` int8
edges                 ``[n, 2, E]`` int32        ``[n, 2, E]`` uint8*
node_mask             ``[n, N]`` float32         ``n_atoms [n]`` int32
edge_mask             ``[n, E]`` float32         ``n_edges [n]`` int32
fp (binary)           ``[n, nbits]`` float32     ``[n, nbits/8]`` uint8
y / y_orig            ``[n]`` float32            (unchanged)
degree, spd,          int8                       (unchanged)
path_types,
edge_types
rwse, svd             ``[n, N, 16]`` float32     (unchanged)
====================  =========================  =====================

(*) uint8 when ``max_nodes <= 256``, else uint16 (held on the device as
the int16 of the same bits, which torch indexes everywhere).

The packing is exact: the node features of both featurizers are small
integers, the masks are leading ones (``data/dataset.py`` fills
``[:n_valid]``), and a binary fingerprint is bits, so the unpacked batch
equals the plain one bit for bit and training follows the same
trajectory (``tests/test_torch_packed.py``).  A non-binary fingerprint
stays float32 under the plain ``"fp"`` key; the other streams still pack.
The graph transformers' structure (Graphormer's ``degree``, ``spd``,
``path_types``, GraphGPS's ``edge_types`` and ``rwse``, EGT's ``svd``;
``data/dataset.py``) goes as it is, in both layouts.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

__all__ = ["pack_dataset", "is_packed", "to_device", "gather_batch",
           "device_dataset", "batch_indices", "batches", "packed_nbytes",
           "plain_nbytes", "STRUCTURE"]

# the graph transformers' streams, carried as they are
STRUCTURE = ("degree", "spd", "path_types", "edge_types", "rwse", "svd")


def _check_integral(a: np.ndarray, lo: int, hi: int, what: str) -> None:
    if not np.all(a == np.round(a)):
        raise ValueError(f"{what} has non-integral values; cannot pack")
    if a.min() < lo or a.max() > hi:
        raise ValueError(f"{what} values outside [{lo}, {hi}]; cannot pack")


def pack_dataset(ds) -> Dict[str, np.ndarray]:
    """``MolecularDataset`` -> compact host dict (see the module
    docstring).  Raises ``ValueError`` for node features that are not
    integers in [-128, 127], masks that are not leading ones, and edge
    indices outside ``[0, max_nodes)``."""
    _check_integral(ds.nodes, -128, 127, "node features")
    packed: Dict[str, np.ndarray] = {
        "nodes_i8": ds.nodes.astype(np.int8),
        "y": np.asarray(ds.y, np.float32),
        "y_orig": np.asarray(ds.y_orig, np.float32),
        "n_atoms": ds.node_mask.sum(axis=1).astype(np.int32),
        "n_edges": ds.edge_mask.sum(axis=1).astype(np.int32),
    }
    # counts stand for leading-ones masks only: check, so that a scattered
    # mask fails here rather than training on other masking
    for mask, counts, what in ((ds.node_mask, packed["n_atoms"], "node"),
                               (ds.edge_mask, packed["n_edges"], "edge")):
        rebuilt = (np.arange(mask.shape[1])[None, :]
                   < counts[:, None]).astype(mask.dtype)
        if not np.array_equal(np.asarray(mask), rebuilt):
            raise ValueError(
                f"{what}_mask is not leading-ones; cannot pack to counts")
    if ds.edges.min() < 0 or ds.edges.max() >= max(ds.max_nodes, 1):
        raise ValueError("edge indices outside [0, max_nodes)")
    packed["edges_p"] = ds.edges.astype(
        np.uint8 if ds.max_nodes <= 256 else np.uint16)

    fp = np.asarray(ds.fp, np.float32)
    if fp.size and np.all((fp == 0.0) | (fp == 1.0)):
        # little-endian bit order: bit j of byte k is fp[:, 8 * k + j]
        packed["fp_packed"] = np.packbits(fp.astype(np.uint8), axis=1,
                                          bitorder="little")
    else:
        packed["fp"] = fp
    packed.update({k: getattr(ds, k) for k in STRUCTURE
                   if getattr(ds, k, None) is not None})
    return packed


def is_packed(data: Dict) -> bool:
    return "nodes_i8" in data


def to_device(data: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A host dict (plain or packed) as tensors on ``device``; uint16
    edges go as the int16 of the same bits."""
    out = {}
    for k, v in data.items():
        v = np.ascontiguousarray(v)
        if v.dtype == np.uint16:
            v = v.view(np.int16)
        out[k] = torch.from_numpy(v).to(device)
    return out


def gather_batch(data: Dict[str, torch.Tensor], idx: torch.Tensor,
                 fp_dim: int) -> Dict[str, torch.Tensor]:
    """Batch ``idx`` of a device dict, plain or packed: for a packed one
    the plain layout's batch, rebuilt on the device (f32 nodes, masks and
    fingerprint, int32 edges).  ``fp_dim`` is the fingerprint's width,
    which the byte packing rounds up to a multiple of 8."""
    if not is_packed(data):
        return {k: v[idx] for k, v in data.items()}
    nodes = data["nodes_i8"][idx].float()
    edges = data["edges_p"][idx].int()
    if data["edges_p"].dtype == torch.int16:
        edges = edges & 0xFFFF
    n, e = nodes.shape[1], edges.shape[2]
    dev = nodes.device
    node_mask = (torch.arange(n, dtype=torch.int32, device=dev)[None, :]
                 < data["n_atoms"][idx][:, None]).float()
    edge_mask = (torch.arange(e, dtype=torch.int32, device=dev)[None, :]
                 < data["n_edges"][idx][:, None]).float()
    if "fp_packed" in data:
        packed = data["fp_packed"][idx]                    # [B, nbytes] u8
        shifts = torch.arange(8, dtype=torch.uint8, device=dev)
        bits = (packed[:, :, None] >> shifts) & 1
        fp = bits.reshape(packed.shape[0], -1)[:, :fp_dim].float()
    else:
        fp = data["fp"][idx]
    out = {"nodes": nodes, "edges": edges, "node_mask": node_mask,
           "edge_mask": edge_mask, "fp": fp,
           "y": data["y"][idx], "y_orig": data["y_orig"][idx]}
    out.update({k: data[k][idx] for k in STRUCTURE if k in data})
    return out


def device_dataset(ds, fields: Sequence[str], device,
                   compact: bool = False) -> Dict[str, torch.Tensor]:
    """``ds``'s ``fields`` on ``device`` as they are, or with ``compact``
    the whole dataset packed (:func:`pack_dataset`)."""
    host = pack_dataset(ds) if compact else {k: getattr(ds, k)
                                             for k in fields}
    return to_device(host, device)


def batch_indices(n: int, batch_size: int,
                  rng: Optional[np.random.Generator] = None
                  ) -> Dict[str, np.ndarray]:
    """``idx`` and ``sample_mask``, ``[n_batches, batch_size]``: one pass
    over ``n`` rows, in order or permuted by ``rng``, the final partial
    batch padded with masked copies of row 0."""
    idx = np.arange(n) if rng is None else rng.permutation(n)
    n_batches = (n + batch_size - 1) // batch_size
    pad = n_batches * batch_size - n
    mask = np.ones(n_batches * batch_size, np.float32)
    if pad:
        idx = np.concatenate([idx, np.zeros(pad, idx.dtype)])
        mask[-pad:] = 0.0
    return {"idx": idx.reshape(n_batches, batch_size).astype(np.int64),
            "sample_mask": mask.reshape(n_batches, batch_size)}


def batches(data: Dict[str, torch.Tensor], index: Dict[str, torch.Tensor],
            fp_dim: int) -> Iterator[Dict[str, torch.Tensor]]:
    """The batches of ``data`` that the rows of ``index``
    (:func:`batch_indices`, on the device) select, with their masks."""
    for i in range(index["idx"].shape[0]):
        batch = gather_batch(data, index["idx"][i], fp_dim)
        batch["sample_mask"] = index["sample_mask"][i]
        yield batch


def _nbytes(d: Dict[str, np.ndarray]) -> int:
    return int(sum(int(np.asarray(v).nbytes) for v in d.values()))


def packed_nbytes(ds) -> int:
    """Device bytes of the compact layout for ``ds``."""
    return _nbytes(pack_dataset(ds))


def plain_nbytes(ds) -> int:
    """Device bytes of the plain float32 layout for ``ds``."""
    return _nbytes({"nodes": ds.nodes, "edges": ds.edges,
                    "node_mask": ds.node_mask, "edge_mask": ds.edge_mask,
                    "fp": ds.fp, "y": ds.y, "y_orig": ds.y_orig})
