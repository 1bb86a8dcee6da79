"""Local patch correlation, plain PyTorch (reference altcorr kernel,
correlation_kernel.cu:83-232): for every edge e the source patch gmap[ii[e]]
(P x P x C) is dotted with the (2R+2)^2 integer-tap window of fmap[jj[e]]
around floor(coords) - R, and the four integer taps are combined bilinearly
into a (2R+1)^2 response; taps outside the image contribute 0. Output per
edge in the reference's [dx, dy, py, px] layout. A frozen copy of the
repository's plain version; maps are channels-last: gmap (Ng, P, P, C),
fmap (F, H, W, C).
"""
from __future__ import annotations

import torch

RADIUS = 3
# edges per chunk: the transient window tensor is chunk x P*P x 64 x C f32
# (~300 MB at 1024 edges, C = 128)
_CHUNK = 1024


def corr(gmap, fmap, coords, ii, jj):
    """Edge-wise local correlation at one pyramid level (radius R = 3).

    gmap (Ng, P, P, C); fmap (F, H, W, C); coords (E, P, P, 2) float, in this
    level's pixels; ii/jj (E,) int. Returns (E, 2R+1, 2R+1, P, P) float32."""
    radius, chunk = RADIUS, _CHUNK
    E, P = coords.shape[0], coords.shape[1]
    D = 2 * radius + 2
    d = 2 * radius + 1
    _, H, W, C = fmap.shape
    dev = coords.device
    rows = fmap.reshape(-1, C).float()       # one row per (frame, y, x)
    out = torch.empty((E, d, d, P, P), dtype=torch.float32, device=dev)
    ar = torch.arange(D, device=dev)
    for s in range(0, E, chunk):
        co = coords[s:s + chunk].float()
        g = gmap[ii[s:s + chunk].long()].float()                 # (n, P, P, C)
        jf = jj[s:s + chunk].long()
        xf = torch.floor(co[..., 0])
        yf = torch.floor(co[..., 1])
        yi = (yf.long() - radius)[..., None] + ar                # (n, P, P, D)
        xj = (xf.long() - radius)[..., None] + ar
        valid = ((yi[..., :, None] >= 0) & (yi[..., :, None] < H) &
                 (xj[..., None, :] >= 0) & (xj[..., None, :] < W))
        idx = ((jf[:, None, None, None, None] * H +
                yi.clamp(0, H - 1)[..., :, None]) * W +
               xj.clamp(0, W - 1)[..., None, :])                 # (n,P,P,D,D)
        win = rows.index_select(0, idx.reshape(-1)).reshape(idx.shape + (C,))
        c = torch.einsum('nijc,nijklc->nijkl', g, win)           # (n,P,P,D,D)
        c = torch.where(valid, c, 0.0)       # taps outside the image are 0
        fx = (co[..., 0] - xf)[..., None, None]
        fy = (co[..., 1] - yf)[..., None, None]
        o = ((1 - fx) * (1 - fy) * c[..., :d, :d] +
             fx * (1 - fy) * c[..., :d, 1:] +
             (1 - fx) * fy * c[..., 1:, :d] +
             fx * fy * c[..., 1:, 1:])
        # (n, py, px, dy, dx) -> reference layout (n, dx, dy, py, px)
        out[s:s + chunk] = o.permute(0, 4, 3, 1, 2)
    return out


def corr_two_level(gmap, fmap1, fmap2, coords, kk, jj, nv=None,
                   out_dtype=torch.float32):
    """Both pyramid levels: (E, 2R+1, 2R+1, P, P, 2) in `out_dtype`.

    [..., 0] is fmap1 at `coords`, [..., 1] is fmap2 at `coords / 4`
    (dpvo_tpu/runtime/device_vo.py:463 stacks them the same way). Edges at
    or past `nv` (an int or a 0-d integer tensor; None = all) are exact
    zeros: the live pairs are a prefix of the pair table."""
    E, P = coords.shape[0], coords.shape[1]
    d = 2 * RADIUS + 1
    n = E if nv is None else max(0, min(int(nv), E))
    out = torch.zeros((E, d, d, P, P, 2), dtype=out_dtype,
                      device=coords.device)
    if n:
        c1 = corr(gmap, fmap1, coords[:n], kk[:n], jj[:n])
        c2 = corr(gmap, fmap2, coords[:n] / 4.0, kk[:n], jj[:n])
        out[:n] = torch.stack([c1, c2], dim=-1).to(out_dtype)
    return out
