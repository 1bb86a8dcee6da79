"""K1 (csrc/corr_onepass.cu:corr_box_kernel, through
ops/corr_onepass.py:corr_two_level): the least time of one call.

Bytes: the coords, kk and jj of the nv live edges read once, the g rows
of the distinct source patches read once, each level's distinct in-map
pixels that the live edges' 8x8 integer-tap windows touch read once, the
output of all E edges written once. Operations: the 8x8-tap dots of 128
channels at both levels and the bilinear combination, for the live edges.
The bound is the larger of bytes over 3.35 TB/s and operations over 989
TFLOP/s (one NVIDIA H100 SXM, bf16 dense, the data sheet).
"""
from __future__ import annotations

import torch

from ..flops import BF16_FLOP_PER_S, HBM_BYTES_PER_S, k1_flops

R = 3


def capture(args, kwargs):
    gmap, fmap1, fmap2, coords, kk, jj = args[:6]
    return dict(coords=coords, kk=kk, jj=jj, nv=kwargs.get('nv'),
                out_elt=torch.empty(0, dtype=kwargs.get(
                    'out_dtype', torch.float32)).element_size(),
                g_elt=gmap.element_size(), f1=tuple(fmap1.shape),
                f2=tuple(fmap2.shape), f_elt=fmap1.element_size())


def _map_bytes(jj, c, shape, elt):
    """Distinct in-map pixels of (F, H, W, C) maps that the 8x8 windows
    at floor(c) - R of frames jj touch, in bytes."""
    F, H, W, C = shape
    r = torch.arange(2 * R + 2, device=c.device) - R
    x = c[..., 0].floor().long().reshape(-1, 9, 1, 1) + r
    y = c[..., 1].floor().long().reshape(-1, 9, 1, 1) + r[:, None]
    x, y = torch.broadcast_tensors(x, y)
    j = jj.long().reshape(-1, 1, 1, 1).expand_as(y)
    ok = (y >= 0) & (y < H) & (x >= 0) & (x < W) & (j >= 0) & (j < F)
    mask = torch.zeros(F * H * W, dtype=torch.bool, device=c.device)
    mask[((j * H + y) * W + x)[ok]] = True
    return int(mask.sum()) * C * elt


def seconds(rec):
    co, kk, jj = rec['coords'], rec['kk'], rec['jj']
    E = co.shape[0]
    nv = E if rec['nv'] is None else int(rec['nv'])
    co, kk, jj = co[:nv].float(), kk[:nv], jj[:nv]
    nb = (co.numel() * 4 + (kk.numel() + jj.numel()) * kk.element_size()
          + E * (2 * R + 1) ** 2 * 9 * 2 * rec['out_elt'])
    nb += int(torch.unique(kk).numel()) * 9 * rec['f1'][3] * rec['g_elt']
    nb += _map_bytes(jj, co, rec['f1'], rec['f_elt'])
    nb += _map_bytes(jj, co / 4.0, rec['f2'], rec['f_elt'])
    return max(nb / HBM_BYTES_PER_S, k1_flops(nv) / BF16_FLOP_PER_S), nv
