"""Edge-wise windowed bundle adjustment (the hybrid runtime's BA).

Port of dpvo_tpu/ba.py:bundle_adjust (reference fastba.BA,
ba_cuda.cu:232-582): per-edge residuals and closed-form Jacobians at the
patch centers, normal-equation blocks summed into a dense window-local
system, the Schur complement over the per-patch inverse depths solved by
Cholesky (ba_pairs.solve_step, shared with the pair-blocked BA). Same
gating (128 px residual, Z > 0.2, +-64 px bounds), damping and depth clamps.

The segment sums are index_add_ into an overflow segment that is dropped
(ba_pairs._seg); dpvo_tpu's one-hot matmul form of them was a TPU
workaround. t0, t1 and patch_base are host ints. The depth window starts at
patch_base clamped into the buffer (lax.dynamic_slice semantics) while the
patch slots stay relative to the unclamped patch_base, as in dpvo_tpu; pose
slots past the buffer are dropped (.at[].set(mode='drop')).
"""
from __future__ import annotations

import torch

from . import lie
from .ba_pairs import _seg, clamp_start, retract_depth, solve_step


def _linearize(poses, xy, depth, intrinsics, target, weight, ii, jj, kk,
               mask):
    """Residuals + Jacobians for every edge: r, w (E, 2) (w gated),
    Ji / Jj (E, 2, 6), Jz (E, 2); coords ~ coords0 + Ji xi_i + Jj xi_j +
    Jz dz. xy (Np, 2) patch centers, depth (Np,), intrinsics (4,)."""
    fx, fy, cx, cy = intrinsics.unbind(0)
    Gij = lie.se3_mul(poses[jj], lie.se3_inv(poses[ii]))       # (E, 7)
    tij = Gij[..., :3]

    xn = (xy[kk, 0] - cx) / fx
    yn = (xy[kk, 1] - cy) / fy
    Xi = torch.stack([xn, yn, torch.ones_like(xn), depth[kk]], dim=-1)
    Xj = lie.se3_act4(Gij, Xi)

    X, Y, Z, Wh = Xj.unbind(-1)
    big = Z >= 0.2
    d = torch.where(big, 1.0 / torch.where(big, Z, 1.0), 0.0)
    d2 = d * d
    Zs = torch.where(Z.abs() < 1e-8, 1e-8, Z)
    x1 = fx * (X / Zs) + cx
    y1 = fy * (Y / Zs) + cy

    rx = target[..., 0] - x1
    ry = target[..., 1] - y1
    in_bounds = ((torch.sqrt(rx * rx + ry * ry) < 128) & (Z > 0.2) &
                 (x1 > -64) & (y1 > -64) &
                 (x1 < 2 * cx + 64) & (y1 < 2 * cy + 64))
    gate = (in_bounds & mask).float()
    r = torch.stack([rx, ry], dim=-1)
    w = gate[..., None] * weight

    o = torch.zeros_like(X)
    Jj = torch.stack([
        fx * Wh * d, o, -fx * X * Wh * d2, -fx * X * Y * d2,
        fx * (1 + X * X * d2), -fx * Y * d,
        o, fy * Wh * d, -fy * Y * Wh * d2, -fy * (1 + Y * Y * d2),
        fy * (X * Y * d2), fy * X * d,
    ], dim=-1).reshape(X.shape + (2, 6))
    Jz = torch.stack([
        fx * (tij[..., 0] * d - tij[..., 2] * (X * d2)),
        fy * (tij[..., 1] * d - tij[..., 2] * (Y * d2)),
    ], dim=-1)
    Ji = -lie.se3_adjT(Gij[..., None, :], Jj)
    return r, w, Ji, Jj, Jz


def _gather_blocks(r, w, Ji, Jj, Jz, ii, jj, kk, t0, patch_base, W, PC):
    """Normal-equation blocks of the window: pose slots ii - t0, jj - t0 in
    [0, W), patch slots kk - patch_base in [0, PC); out-of-window terms are
    dropped. An edge whose patch slot is outside the depth window is
    dropped everywhere (its depth would be held fixed while it pulls on the
    poses). The sums are taken in r's dtype."""
    def seg(vals, ids, valid, num):
        return _seg(vals, ids, valid, num, dtype=r.dtype)

    wi = ii - t0
    wj = jj - t0
    pk = kk - patch_base
    vi = (wi >= 0) & (wi < W)
    vj = (wj >= 0) & (wj < W)
    vk = (pk >= 0) & (pk < PC)
    w = w * vk[:, None].float()

    def JtWJ(A, B):                     # (E, 2, a), (E, 2, b) -> (E, a, b)
        return torch.einsum('era,erb->eab', A * w[..., None], B)

    Bii = JtWJ(Ji, Ji)
    Bij = JtWJ(Ji, Jj)
    Bjj = JtWJ(Jj, Jj)
    B = seg(Bii, wi * W + wi, vi, W * W)
    B = B + seg(Bij, wi * W + wj, vi & vj, W * W)
    B = B + seg(Bij.transpose(-1, -2), wj * W + wi, vi & vj, W * W)
    B = B + seg(Bjj, wj * W + wj, vj, W * W)

    wJz = w * Jz
    Em = seg((Ji * wJz[..., None]).sum(1), wi * PC + pk, vi & vk, W * PC)
    Em = Em + seg((Jj * wJz[..., None]).sum(1), wj * PC + pk, vj & vk,
                  W * PC)
    C = seg((Jz * wJz).sum(-1), pk, vk, PC)
    u = seg((Jz * w * r).sum(-1), pk, vk, PC)
    wr = (w * r)[..., None]
    v = seg((Ji * wr).sum(1), wi, vi, W)
    v = v + seg((Jj * wr).sum(1), wj, vj, W)
    touched = seg((w.sum(-1) > 0).float(), pk, vk, PC)
    return B.reshape(W, W, 6, 6), Em.reshape(W, PC, 6), C, v, u, touched


def bundle_adjust(poses, xy, depth, intrinsics, target, weight, lmbda,
                  ii, jj, kk, mask, t0, t1, patch_base, *, W, PC,
                  iterations=2, structure_only=False):
    """Windowed Gauss-Newton bundle adjustment over an edge table.

    poses (N, 7); xy (Np, 2) patch centers; depth (Np,); intrinsics (4,);
    target / weight (E, 2); ii / jj / kk (E,) int; mask (E,) bool; host ints
    t0, t1 (pose window [t0, t1), at most W slots) and patch_base (depth
    window of PC patches). With structure_only the poses stay as they are
    and each step moves the depths alone, by Q u (zeroed unless every
    entry is finite; dpvo_tpu/ba.py:194-197): the classic loop closure's
    triangulation. Returns new (poses, depth); inputs untouched."""
    ii, jj, kk = ii.long(), jj.long(), kk.long()
    s = clamp_start(patch_base, PC, depth.shape[0])
    for _ in range(iterations):
        r, w, Ji, Jj, Jz = _linearize(poses, xy, depth, intrinsics, target,
                                      weight, ii, jj, kk, mask)
        B, Em, C, v, u, touched = _gather_blocks(
            r, w, Ji, Jj, Jz, ii, jj, kk, t0, patch_base, W, PC)
        if structure_only:
            dZ = (1.0 / (C + lmbda)) * u
            dZ = torch.where(torch.isfinite(dZ).all(), dZ, 0.0)
            depth = retract_depth(depth, dZ, touched, s)
        else:
            poses, depth = solve_step(poses, depth, B, Em, C, v, u, touched,
                                      lmbda, t0, t1, s)
    return poses, depth
