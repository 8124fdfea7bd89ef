"""Segment-ID (flat, packed layout) message-passing primitives (port of
``mgat_graphsage_tpu/ops/segment.py``).

The alternative to ``ops/graph.py``'s padded-dense layout: the nodes of a
batch packed into one ``[P, F]`` buffer with an integer segment ID per
row.  Plain PyTorch scatters and gathers; the reference's are plain
``jax.ops.segment_*``.  As there, an empty segment gives 0 for a sum or
mean and ``-inf`` for a max.
"""

from __future__ import annotations

import torch

__all__ = [
    "segment_sum", "segment_mean", "segment_max", "segment_softmax",
    "gather", "scatter_sum",
]


def _index(segment_ids: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``segment_ids [P]`` broadcast over the trailing dims of ``data``."""
    idx = segment_ids.long().view((-1,) + (1,) * (data.dim() - 1))
    return idx.expand_as(data)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add(0, segment_ids.long(), data)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    s = segment_sum(data, segment_ids, num_segments)
    cnt = segment_sum(data.new_ones(data.shape[:1]), segment_ids,
                      num_segments)
    return s / torch.clamp_min(cnt, 1.0).unsqueeze(-1)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = data.new_full((num_segments,) + tuple(data.shape[1:]),
                        float("-inf"))
    return out.scatter_reduce(0, _index(segment_ids, data), data, "amax",
                              include_self=True)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Numerically stable softmax within each segment (edge softmax)."""
    seg_max = segment_max(logits, segment_ids, num_segments)
    seg_max = torch.nan_to_num(seg_max, neginf=0.0)
    e = torch.exp(logits - seg_max[segment_ids.long()])
    denom = segment_sum(e, segment_ids, num_segments)
    return e / torch.clamp_min(denom[segment_ids.long()], 1e-16)


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x.index_select(0, idx.long())


def scatter_sum(data: torch.Tensor, idx: torch.Tensor,
                num: int) -> torch.Tensor:
    return segment_sum(data, idx, num)
