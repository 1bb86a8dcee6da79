"""Network building blocks: f32-statistics LayerNorm, GatedResidual, SoftAgg.

Port of dpvo_tpu/models/blocks.py:17-164 (reference dpvo/blocks.py:7-118).
Linears run in the parameters' dtype (bf16 under MIXED_PRECISION, f32
accumulation on the card); LayerNorm statistics are always f32 with the
reference's eps = 1e-3.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.scatter import segment_softmax, segment_sum


class LayerNorm32(nn.LayerNorm):
    """LayerNorm whose statistics and affine run in f32, output in x's dtype."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


class GatedResidual(nn.Module):
    """x + sigmoid(gate(x)) * res(x)  (dpvo/blocks.py:15-29)."""

    def __init__(self, dim, device=None):
        super().__init__()
        self.gate = nn.Sequential(nn.Linear(dim, dim, device=device),
                                  nn.Sigmoid())
        self.res = nn.Sequential(nn.Linear(dim, dim, device=device),
                                 nn.ReLU(), nn.Linear(dim, dim, device=device))

    def forward(self, x):
        return x + self.gate(x) * self.res(x)


class SoftAgg(nn.Module):
    """Softmax-weighted aggregation by group, re-expanded to edges
    (dpvo/blocks.py:31-48): w = softmax_group(g(x)); y = sum_group(f(x) w);
    out = h(y)[group]."""

    def __init__(self, dim, device=None):
        super().__init__()
        self.f = nn.Linear(dim, dim, device=device)
        self.g = nn.Linear(dim, dim, device=device)
        self.h = nn.Linear(dim, dim, device=device)

    def forward(self, x, ids, num_segments, mask=None):
        """Segment form: x (E, D), ids (E,) dense group ids."""
        fx, gx = self.f(x), self.g(x).float()
        w = segment_softmax(gx, ids, num_segments, mask=mask)
        y = segment_sum(fx.float() * w, ids, num_segments)
        return self.h(y.to(x.dtype))[ids]

    def ij_pairs(self, x3, mask3):
        """Frame-pair groups on a pair-blocked table: x3 (GP, M, D), mask3
        (GP, M). Edge (g, m) belongs to group g, so the softmax runs over
        the M axis (in x's dtype, sums in f32, as dpvo_tpu does)."""
        GP, M, D = x3.shape
        fx, gx = self.f(x3), self.g(x3)
        keep = mask3[..., None]
        gxm = torch.where(keep, gx, float('-inf'))
        mx = gxm.amax(dim=1, keepdim=True)
        ex = torch.exp(gxm - torch.where(torch.isfinite(mx), mx, 0.0))
        ex = torch.where(keep, ex, 0.0)
        den = ex.sum(dim=1, keepdim=True, dtype=torch.float32)
        w = ex / den.clamp(min=1e-30).to(x3.dtype)
        y = (fx * w).sum(dim=1, dtype=torch.float32)               # (GP, D)
        hy = self.h(y.to(x3.dtype))
        return hy[:, None].expand(GP, M, D).reshape(GP * M, D)

    def kk_pairs(self, x3, psl, mask3, num_slots):
        """Source-patch groups on a pair-blocked table: edge (g, m) belongs
        to group (psl[g], m), psl (GP,) the source ring slot of pair g.
        Pairs whose slot is outside [0, num_slots) contribute nothing."""
        GP, M, D = x3.shape
        dt = x3.dtype
        fx, gx = self.f(x3), self.g(x3)
        ok = (psl >= 0) & (psl < num_slots)
        keep = (mask3 & ok[:, None])[..., None]
        slot = psl.clamp(0, num_slots - 1)
        neg = torch.full((), -1e30, dtype=dt, device=x3.device)
        gxm = torch.where(keep, gx, neg)
        # group max in f32: a max is a selection, so it is exact in dt
        mx = torch.full((num_slots, M, D), -1e30, dtype=torch.float32,
                        device=x3.device)
        idx = slot[:, None, None].expand(GP, M, D)
        mx = mx.scatter_reduce(0, idx, gxm.float(), reduce='amax',
                               include_self=True).to(dt)
        ex = torch.where(keep, torch.exp(gxm - mx[slot]), 0.0)
        den = torch.zeros((num_slots, M, D), dtype=torch.float32,
                          device=x3.device).index_add_(0, slot, ex.float())
        w = ex / den[slot].clamp(min=1e-30).to(dt)
        y = torch.zeros((num_slots, M, D), dtype=torch.float32,
                        device=x3.device).index_add_(0, slot,
                                                     (fx * w).float())
        hy = self.h(y.to(dt))
        return hy[slot].reshape(GP * M, D)


# ---------------------------------------------------------------------------
# gradient clamps (dpvo_tpu/models/blocks.py:176-207, reference
# dpvo/blocks.py:70-107): identity forward, clipped / zeroed backward; the
# update heads apply grad_clip while training
# ---------------------------------------------------------------------------

GRAD_CLIP = 0.1


class _GradClip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = torch.where(torch.isnan(g), 0.0, g)
        return g.clamp(-0.01, 0.01)


class _GradZero(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = torch.where(torch.isnan(g), 0.0, g)
        return torch.where(g.abs() > GRAD_CLIP, 0.0, g)


def grad_clip(x):
    """Identity; the backward turns NaN into 0, then clamps to +-0.01."""
    return _GradClip.apply(x)


def grad_zero(x):
    """Identity; the backward turns NaN into 0, then zeroes |g| > 0.1."""
    return _GradZero.apply(x)
