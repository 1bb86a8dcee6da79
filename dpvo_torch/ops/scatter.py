"""Segment sum / mean / softmax over dense group ids (torch_scatter
replacements).

Port of dpvo_tpu/ops/scatter.py with `index_add_` and
`scatter_reduce(amax)`; group ids are dense and precomputed by the caller.
"""
from __future__ import annotations

import torch


def segment_sum(x, ids, num_segments):
    out = torch.zeros((num_segments,) + x.shape[1:], dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, ids, x)


def segment_mean(x, ids, num_segments):
    """Per-segment mean over rows; empty segments hold 0."""
    c = segment_sum(torch.ones(x.shape[:1], dtype=x.dtype, device=x.device),
                    ids, num_segments)
    return segment_sum(x, ids, num_segments) / \
        torch.clamp(c, min=1.0)[(...,) + (None,) * (x.dim() - 1)]


def segment_max(x, ids, num_segments):
    """Per-segment max; empty segments hold -inf (jax.ops.segment_max)."""
    out = torch.full((num_segments,) + x.shape[1:], float('-inf'),
                     dtype=x.dtype, device=x.device)
    idx = ids.view((-1,) + (1,) * (x.dim() - 1)).expand_as(x)
    return out.scatter_reduce_(0, idx, x, reduce='amax', include_self=True)


def segment_softmax(x, ids, num_segments, mask=None):
    """Softmax over rows sharing a segment id (torch_scatter.scatter_softmax).

    x (E, D); ids (E,) int; mask optional (E,) bool — masked rows get weight
    zero and do not take part in their segment's normalization."""
    if mask is not None:
        x = torch.where(mask[:, None], x, float('-inf'))
    m = segment_max(x, ids, num_segments)
    m = torch.where(torch.isfinite(m), m, 0.0)
    ex = torch.exp(x - m[ids])
    if mask is not None:
        ex = torch.where(mask[:, None], ex, 0.0)
    denom = segment_sum(ex, ids, num_segments)
    return ex / torch.clamp(denom[ids], min=1e-12)
