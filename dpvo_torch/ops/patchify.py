"""Patch extraction (gather + bilinear) and average pooling, channels-last.

Port of dpvo_tpu/ops/patchify.py. Feature maps are (H, W, C) so a gathered
pixel is one contiguous C-row; out-of-bounds taps contribute zeros, like the
reference's `within_bounds` guard (correlation_kernel.cu:17-80).
"""
from __future__ import annotations

import torch


def _gather_window(fmap, coords, radius):
    """(M, D, D, C) integer windows around floor(coords), zero outside.

    fmap (H, W, C); coords (M, 2) float [x, y]; D = 2R+2."""
    H, W, _ = fmap.shape
    D = 2 * radius + 2
    x0 = torch.floor(coords[:, 0]).long() - radius
    y0 = torch.floor(coords[:, 1]).long() - radius
    ar = torch.arange(D, device=fmap.device)
    yi = y0[:, None] + ar                                  # (M, D)
    xj = x0[:, None] + ar
    valid = ((yi[:, :, None] >= 0) & (yi[:, :, None] < H) &
             (xj[:, None, :] >= 0) & (xj[:, None, :] < W))
    win = fmap[yi.clamp(0, H - 1)[:, :, None], xj.clamp(0, W - 1)[:, None, :]]
    return win.masked_fill(~valid[..., None], 0)


def extract_patches(fmap, coords, radius, mode='bilinear'):
    """(M, P, P, C) bilinear patches, P = 2R+1, at float centroids; any
    other mode returns the raw (M, D, D, C) integer windows, D = 2R+2.

    fmap (H, W, C); coords (M, 2) float [x, y]. The weights are cast to the
    map's dtype before blending, as dpvo_tpu does."""
    win = _gather_window(fmap, coords, radius)
    if mode != 'bilinear':
        return win
    frac = coords - torch.floor(coords)
    dx = frac[:, 0][:, None, None, None].to(win.dtype)
    dy = frac[:, 1][:, None, None, None].to(win.dtype)
    d = 2 * radius + 1
    return ((1 - dy) * (1 - dx) * win[:, :d, :d] +
            (1 - dy) * dx * win[:, :d, 1:] +
            dy * (1 - dx) * win[:, 1:, :d] +
            dy * dx * win[:, 1:, 1:])


def avg_pool2d(x, k):
    """k x k average pool, stride k, channels-last (..., H, W, C)."""
    if k == 1:
        return x
    *lead, H, W, C = x.shape
    x = x.reshape(tuple(lead) + (H // k, k, W // k, k, C))
    return x.mean(dim=(-4, -2))


def pyramidify(fmap, lvls=(1, 4)):
    """Average-pool pyramid (reference dpvo/utils.py:65-74), channels-last."""
    return [avg_pool2d(fmap, k) for k in lvls]
