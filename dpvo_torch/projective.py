"""Projective geometry on tensors: patch (inverse-)projection, reprojection
with analytic SE3 / Sim3 Jacobians, point clouds and flow magnitude.

Port of dpvo_tpu/projective.py (the reference's dpvo/projective_ops.py:
19-130). Functions take raw (..., 7) SE3 or (..., 8) Sim3 pose tensors in
dpvo_torch.lie's layout. Patches are (..., 3, P, P): channels 0 / 1 are the
patch grid's x / y pixels, channel 2 its inverse depth. The runtimes keep
their own fused forms of these (runtime/device_vo.py, ba_pairs.py); this
module is the library surface, held against dpvo_tpu by the tests.
"""
from __future__ import annotations

import torch

from . import lie

MIN_DEPTH = 0.2  # reference projective_ops.py:6

_GROUPS = {
    'se3': (lie.se3_inv, lie.se3_mul, lie.se3_act4, lie.se3_adjT,
            lie.se3_matrix),
    'sim3': (lie.sim3_inv, lie.sim3_mul, lie.sim3_act4, lie.sim3_adjT,
             lie.sim3_matrix),
}


def _intrinsics(intrinsics):
    """fx, fy, cx, cy of (..., 4) intrinsics, shaped to broadcast over a
    (..., P, P) patch grid."""
    return [intrinsics[..., i, None, None] for i in range(4)]


def iproj(patches, intrinsics):
    """Inverse-project patches (..., 3, P, P) with intrinsics (..., 4)
    [fx fy cx cy] to homogeneous points (..., P, P, 4) [xn, yn, 1, d]."""
    x, y, d = patches[..., 0, :, :], patches[..., 1, :, :], \
        patches[..., 2, :, :]
    fx, fy, cx, cy = _intrinsics(intrinsics)
    return torch.stack([(x - cx) / fx, (y - cy) / fy, torch.ones_like(d), d],
                       dim=-1)


def proj(X, intrinsics, depth=False):
    """Pinhole projection of homogeneous points (..., P, P, 4) to pixels
    (..., P, P, 2), or (..., P, P, 3) [px, py, 1/Z] with depth=True. Z is
    clamped at 0.1 (reference projective_ops.py:43)."""
    d = 1.0 / torch.clamp(X[..., 2], min=0.1)
    fx, fy, cx, cy = _intrinsics(intrinsics)
    px = fx * (d * X[..., 0]) + cx
    py = fy * (d * X[..., 1]) + cy
    if depth:
        return torch.stack([px, py, d], dim=-1)
    return torch.stack([px, py], dim=-1)


def transform(poses, patches, intrinsics, ii, jj, kk, jacobian=False,
              valid=False, tonly=False, group='se3'):
    """Reproject patch kk of frame ii into frame jj.

    poses (N, 7) SE3 or (N, 8) Sim3 (group='sim3'); patches (Np, 3, P, P);
    intrinsics (N, 4); ii, jj, kk (E,) int. Returns coords (E, P, P, 2);
    with valid=True also Z > 0.2 at every tap (E, P, P); with jacobian=True
    (coords, Z > 0.2 at the centre tap (E,), (Ji, Jj, Jz)): the analytic
    Jacobians of the centre tap's pixel w.r.t. a left perturbation of pose
    ii (E, 2, dof), of pose jj (E, 2, dof) and w.r.t. the patch's inverse
    depth (E, 2, 1) (reference projective_ops.py:53-113). tonly replaces
    Gij[..., 3:] with [0, 0, 0, 1, 0...] as dpvo_tpu does: the identity
    rotation, and for Sim3 a zero scale."""
    g_inv, g_mul, g_act4, g_adjT, g_matrix = _GROUPS[group]
    ii, jj, kk = ii.long(), jj.long(), kk.long()

    X0 = iproj(patches[kk], intrinsics[ii])             # (E, P, P, 4)
    Gij = g_mul(poses[jj], g_inv(poses[ii]))            # (E, 7 | 8)
    if tonly:
        rot = torch.zeros_like(Gij[..., 3:])
        rot[..., 3] = 1.0
        Gij = torch.cat([Gij[..., :3], rot], dim=-1)

    X1 = g_act4(Gij[..., None, None, :], X0)            # (E, P, P, 4)
    x1 = proj(X1, intrinsics[jj])

    if jacobian:
        c = X1.shape[-3] // 2
        Xc = X1[..., c, c, :]                           # (E, 4)
        X, Y, Z, H = Xc.unbind(-1)
        o = torch.zeros_like(H)
        fx, fy = intrinsics[jj][..., 0], intrinsics[jj][..., 1]
        # gated inverse depth (reference projective_ops.py:79-80)
        near = Z.abs() > 0.2
        d = torch.where(near, 1.0 / torch.where(near, Z, torch.ones_like(Z)),
                        o)
        if group == 'se3':
            Ja = [H, o, o, o, Z, -Y,
                  o, H, o, -Z, o, X,
                  o, o, H, Y, -X, o,
                  o, o, o, o, o, o]
        else:
            Ja = [H, o, o, o, Z, -Y, X,
                  o, H, o, -Z, o, X, Y,
                  o, o, H, Y, -X, o, Z,
                  o, o, o, o, o, o, o]
        Ja = torch.stack(Ja, dim=-1).reshape(Xc.shape[:-1] +
                                             (4, len(Ja) // 4))
        Jp = torch.stack([fx * d, o, -fx * X * d * d, o,
                          o, fy * d, -fy * Y * d * d, o],
                         dim=-1).reshape(Xc.shape[:-1] + (2, 4))
        # elementwise products summed in the inputs' dtype (no TF32 path)
        Jj = (Jp[..., :, :, None] * Ja[..., None, :, :]).sum(-2)
        Ji = -g_adjT(Gij[..., None, :], Jj)
        Jz = (Jp * g_matrix(Gij)[..., None, :, 3]).sum(-1)[..., None]
        return x1, (Z > 0.2).to(x1.dtype), (Ji, Jj, Jz)

    if valid:
        return x1, (X1[..., 2] > 0.2).to(x1.dtype)
    return x1


def point_cloud(poses, patches, intrinsics, ix):
    """Back-project patches (Np, 3, P, P) of frames ix to world homogeneous
    points (Np, P, P, 4) (reference projective_ops.py:115-117)."""
    ix = ix.long()
    X = iproj(patches, intrinsics[ix])
    return lie.se3_act4(lie.se3_inv(poses[ix])[..., None, None, :], X)


def flow_mag(poses, patches, intrinsics, ii, jj, kk, beta=0.3):
    """Blend of the full and the translation-only flow magnitude (reference
    projective_ops.py:120-130). Returns (flow (E, P, P), valid (E, P, P)
    bool)."""
    coords0 = transform(poses, patches, intrinsics, ii, ii, kk)
    coords1, val = transform(poses, patches, intrinsics, ii, jj, kk,
                             valid=True)
    coords2 = transform(poses, patches, intrinsics, ii, jj, kk, tonly=True)
    flow1 = torch.linalg.norm(coords1 - coords0, dim=-1)
    flow2 = torch.linalg.norm(coords2 - coords0, dim=-1)
    return beta * flow1 + (1 - beta) * flow2, val > 0.5
