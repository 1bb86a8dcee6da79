"""Coordinate grids and small tensor helpers (reference dpvo/utils.py:32-87).

Port of dpvo_tpu/utils/grids.py. Functions that build tensors from plain
ints take a device (default 'cuda', as the runtimes); the others follow
their inputs.
"""
from __future__ import annotations

import torch

from ..ops.patchify import avg_pool2d, pyramidify  # noqa: F401 (re-export)


def _pixel_grid(h, w, device):
    """(h, w) x and y pixel coordinates in f32."""
    y = torch.arange(h, dtype=torch.float32, device=device)
    x = torch.arange(w, dtype=torch.float32, device=device)
    yy, xx = torch.meshgrid(y, x, indexing='ij')
    return xx, yy


def coords_grid(b, n, h, w, device='cuda'):
    """(b, n, 2, h, w) [x, y] pixel grid (reference utils.py:32-37)."""
    xx, yy = _pixel_grid(h, w, device)
    return torch.stack([xx, yy])[None, None].expand(b, n, 2, h, w)


def coords_grid_with_index(d):
    """(x, y, disparity) grid and frame index (reference utils.py:39-54).

    d (b, n, h, w) disparity. Returns (coords (b, n, 3, h, w), index
    (b, n, 1, h, w) f32)."""
    b, n, h, w = d.shape
    xx, yy = _pixel_grid(h, w, d.device)
    coords = torch.stack([xx.expand(b, n, h, w).to(d.dtype),
                          yy.expand(b, n, h, w).to(d.dtype), d], dim=2)
    index = torch.arange(n, dtype=torch.float32, device=d.device)
    return coords, index[None, :, None, None, None].expand(b, n, 1, h, w)


def flatmeshgrid(*args, indexing='ij'):
    return tuple(x.reshape(-1) for x in torch.meshgrid(*args,
                                                       indexing=indexing))


def all_pairs_exclusive(n, device='cuda'):
    """(ii, jj) over every ordered pair i != j of n frames, row-major."""
    ii, jj = flatmeshgrid(torch.arange(n, device=device),
                          torch.arange(n, device=device))
    k = ii != jj
    return ii[k], jj[k]


def set_depth(patches, depth):
    """patches (..., 3, P, P) with channel 2 set to depth (...,)."""
    d = depth.to(patches.dtype)[..., None, None, None]
    return torch.cat([patches[..., :2, :, :],
                      d.expand(patches[..., 2:, :, :].shape)], dim=-3)
