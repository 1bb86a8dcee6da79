"""Device state of the hybrid runtime and its per-frame step functions.

Port of dpvo_tpu/runtime/state.py. The device holds fixed-shape buffers
(poses, patch grids, inverse depths, feature rings, per-edge recurrent
state); the edge set is a padded, masked table whose integer bookkeeping
lives on the host (runtime/dpvo.py). Per frame, `frame_step` runs in order:
the previous frame's deferred keyframe removal (`shift_frames`), the
edge-state compaction, patchify + store, and one correlation + update +
BA iteration (`update_step`); it returns one packed vector of host mirrors.

Edge capacities are bucketed (`edge_bucket`) as in dpvo_tpu. Row gathers
are index_select; dpvo_tpu's one-hot / remapped gathers were TPU
workarounds. Keyframe removal moves whole frames of patch rows
(patch_xy, depth); dpvo_tpu's shift_frames rolls those flat buffers by one
patch instead (ROADMAP.md queue 3).
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from .. import lie
from ..ba import bundle_adjust
from ..models.vonet import DIM, P
from ..ops.corr_fused import corr_fused
from ..ops.corr_onepass import corr_two_level
from .device_vo import _median, i420_to_rgb

# edge-table rows (dpvo_tpu's row 11, the loop-closure ring remap, is gone)
II, JJ, KK, KK_SLOT, JJ_SLOT, IX, JX, KK_IDS, PAIR_IDS, MASK, PERM = range(11)
TABLE_ROWS = 11


@dataclass
class HybridState:
    poses: torch.Tensor        # (N, 7)
    patch_xy: torch.Tensor     # (N*M, 2, P, P) patch pixel grids, 1/4 res
    depth: torch.Tensor        # (N*M,) inverse depths
    intr: torch.Tensor         # (N, 4) intrinsics / RES per frame
    imap: torch.Tensor         # (pmem*M, DIM) context ring
    gmap: torch.Tensor         # (pmem*M, P, P, 128) patch-feature ring
    fmap1: torch.Tensor        # (mem, H/4, W/4, 128) channels-last
    fmap2: torch.Tensor        # (mem, H/16, W/16, 128)
    net: torch.Tensor          # (cap, DIM) per-edge hidden state
    target: torch.Tensor       # (cap, 2)
    weight: torch.Tensor       # (cap, 2)

    def tensors(self):
        return {f.name: getattr(self, f.name) for f in fields(self)}


def init_state(N, M, pmem, mem, ht, wd, cap, device, dtype):
    """Empty HybridState on `device`; feature buffers and net in `dtype`."""
    kw = dict(device=device)
    h4, w4 = ht // 4, wd // 4
    return HybridState(
        poses=torch.tensor([0, 0, 0, 0, 0, 0, 1.0], **kw).repeat(N, 1),
        patch_xy=torch.zeros((N * M, 2, P, P), **kw),
        depth=torch.ones((N * M,), **kw),
        intr=torch.zeros((N, 4), **kw),
        imap=torch.zeros((pmem * M, DIM), dtype=dtype, **kw),
        gmap=torch.zeros((pmem * M, P, P, 128), dtype=dtype, **kw),
        fmap1=torch.zeros((mem, h4, w4, 128), dtype=dtype, **kw),
        fmap2=torch.zeros((mem, h4 // 4, w4 // 4, 128), dtype=dtype, **kw),
        net=torch.zeros((cap, DIM), dtype=dtype, **kw),
        target=torch.zeros((cap, 2), **kw),
        weight=torch.zeros((cap, 2), **kw),
    )


def edge_bucket(n):
    """Edge capacity for an edge count (few distinct shapes)."""
    if n <= 128:
        return 128
    b = 256
    while b < n and b < 8192:
        b *= 2
    if b >= n:
        return b
    return ((n + 8191) // 8192) * 8192


def gather_rows(buf, idx):
    """Edge-buffer compaction / padding gather; rows with idx < 0 are 0."""
    out = buf.index_select(0, idx.clamp(min=0))
    keep = (idx >= 0).reshape((-1,) + (1,) * (buf.dim() - 1))
    return torch.where(keep, out, torch.zeros((), dtype=buf.dtype,
                                              device=buf.device))


def _reproject(poses, patch_xy, depth, intrinsics, ii, jj, kk):
    """Full-patch reprojection (E, P, P, 2) (reference dpvo.py:209-213)."""
    xy = patch_xy[kk]                                     # (E, 2, P, P)
    d = depth[kk][:, None, None]
    intr_i = intrinsics[ii]
    intr_j = intrinsics[jj]
    fx, fy, cx, cy = (intr_i[:, i, None, None] for i in range(4))
    xn = (xy[:, 0] - cx) / fx
    yn = (xy[:, 1] - cy) / fy
    X0 = torch.stack([xn, yn, torch.ones_like(xn), d.expand(xn.shape)],
                     dim=-1)
    Gij = lie.se3_mul(poses[jj], lie.se3_inv(poses[ii]))
    X1 = lie.se3_act4(Gij[:, None, None, :], X0)
    Z = X1[..., 2].clamp(min=0.1)
    fx, fy, cx, cy = (intr_j[:, i, None, None] for i in range(4))
    return torch.stack([fx * X1[..., 0] / Z + cx, fy * X1[..., 1] / Z + cy],
                       dim=-1)


def shift_frames(st, k, n, *, M, pmem, mem):
    """Drop keyframe k of the n frames [0, n): frames (k, n) move down one
    slot (reference dpvo.py:287-297), in place. Per-frame rows (poses,
    intrinsics) and per-patch rows (patch_xy, depth) move by whole frames;
    in the feature rings, slot (f % slots) of each moved frame f receives
    slot ((f + 1) % slots)."""
    for name, rows in (('poses', 1), ('intr', 1), ('patch_xy', M),
                       ('depth', M)):
        buf = getattr(st, name)
        buf[k * rows:(n - 1) * rows] = buf[(k + 1) * rows:n * rows].clone()
    for name, slots, rows in (('imap', pmem, M), ('gmap', pmem, M),
                              ('fmap1', mem, 1), ('fmap2', mem, 1)):
        count = min(n - 1 - k, slots)
        if count <= 0:
            continue
        dst = (k + torch.arange(count, device=st.poses.device)) % slots
        buf = getattr(st, name).view((slots, rows) + getattr(
            st, name).shape[1:])
        buf.index_copy_(0, dst, buf.index_select(0, (dst + 1) % slots))


def _corr_features(st, tab, coords, corr_mode):
    """(E, 882) correlation features of the edge table, reference layout
    [dx, dy, py, px, level] (the update operator's corr input)."""
    E = coords.shape[0]
    kk = tab[KK_SLOT].int()
    jj = tab[JJ_SLOT].int()
    if corr_mode == 'onepass':
        corr = corr_two_level(st.gmap, st.fmap1, st.fmap2, coords, kk, jj)
    else:
        corr = torch.stack(corr_fused(st.gmap, st.fmap1, st.fmap2, coords,
                                      kk, jj), dim=-1)
    return corr.reshape(E, -1)


def update_step(network, st, tab, t0, t1, patch_base, *, W, PC,
                iterations=2, run_ba=True, corr_mode='fused', net=None,
                oracle=None):
    """One correlation + update + BA iteration over the padded edge table
    (reference DPVO.update, dpvo.py:328-360).

    tab (11, cap) int64 edge table on the device (rows: see TABLE_ROWS);
    net: the edges' hidden state (default st.net); host ints t0, t1 (pose
    window [t0, t1)), patch_base (first patch of the depth window). With
    run_ba, st.poses / st.depth are updated. oracle: an optional callable
    (poses, patch_xy, depth, intr, ii, jj, kk) -> (target (E, 2), weight
    (E, 2)) that replaces the correlation and the update operator; the net
    state then stays as it is. Returns (net, target, weight, delta)."""
    mask = tab[MASK].bool()
    ii, jj, kk = tab[II], tab[JJ], tab[KK]
    coords = _reproject(st.poses, st.patch_xy, st.depth, st.intr, ii, jj, kk)
    center = coords[:, P // 2, P // 2, :]
    net = st.net if net is None else net
    if oracle is None:
        corr = _corr_features(st, tab, coords, corr_mode)
        inp = st.imap.index_select(0, tab[KK_SLOT])
        net, delta, weight = network.update_op(
            net, inp, corr, tab[IX], tab[JX], tab[KK_IDS], tab[PAIR_IDS],
            num_segments=ii.shape[0], edge_mask=mask)
        target = center + delta
        weight = torch.where(mask[:, None], weight, 0.0)
    else:
        tgt, wgt = oracle(st.poses, st.patch_xy, st.depth, st.intr, ii, jj,
                          kk)
        target = torch.where(mask[:, None], tgt, center)
        weight = torch.where(mask[:, None], wgt, 0.0)
        delta = target - center
    if run_ba:
        st.poses, st.depth = bundle_adjust(
            st.poses, st.patch_xy[:, :, P // 2, P // 2], st.depth, st.intr[0],
            target, weight, 1e-4, ii, jj, kk, mask, t0, t1, patch_base,
            W=W, PC=PC, iterations=iterations)
    return net, target, weight, delta


def probe_median_delta(delta, mask):
    """Median ||delta|| over the valid probe edges (reference
    dpvo.py:240-255); linear interpolation like jnp.nanquantile."""
    nrm = torch.linalg.vector_norm(delta, dim=-1)
    return torch.nanquantile(torch.where(mask, nrm, float('nan')), 0.5)


def frame_step(network, st, image, coords, tab, pose_init, intr_row,
               depth_init, n, imap_slot, fmap_slot, t0, patch_base, kf_k,
               motion_fac=1.0, *, W, PC, M, pmem, mem, iterations=2,
               run_ba=True, do_update=True, corr_mode='fused',
               device_init=None, oracle=None):
    """Everything the device does for one tracked frame, in order:
    (a) the previous frame's deferred removal of keyframe kf_k (>= 0; the
    host already counts one frame less, so n + 1 frames existed),
    (b) the edge-state compaction by the table's PERM row, (c) patchify +
    store of frame n, (d) with do_update, one update_step over the table
    (pose window [t0, n + 1)).

    device_init 'damped' / 'last' recompute the motion-model pose init and
    the median depth init from the device state after (a), which the host
    mirrors may not have seen yet (motion_fac carries the host-known
    timestamp ratio); None takes the host's pose_init / depth_init.
    image (H, W, 3) uint8, or the (3H/2, W) uint8 I420 plane stack, and
    coords (M, 2) on the device; oracle: see update_step. Returns the
    packed mirror (pose window [t0, t0 + W + 2), depth window [patch_base,
    + PC), the frame's colors; starts clamped into the buffers) and delta."""
    if kf_k >= 0:
        shift_frames(st, kf_k, n + 1, M=M, pmem=pmem, mem=mem)

    if device_init is not None:
        P1 = st.poses[n - 1]
        if device_init == 'damped':
            xi = motion_fac * lie.se3_log(lie.se3_mul(P1, lie.se3_inv(
                st.poses[n - 2])))
            pose_init = lie.se3_mul(lie.se3_exp(xi), P1)
        else:                                   # 'last'
            pose_init = P1
        depth_init = _median(st.depth[(n - 3) * M:n * M]).expand(M)

    perm = tab[PERM]
    st.net = gather_rows(st.net, perm)
    st.target = gather_rows(st.target, perm)
    st.weight = gather_rows(st.weight, perm)

    if image.dim() == 2:
        ht, wd = image.shape[0] * 2 // 3, image.shape[1]
        image = i420_to_rgb(image.reshape(-1), ht, wd)
    dt = network.dtype
    # f32 normalization, as dpvo_tpu's hybrid does (the encoders cast)
    feats = network.patchify_frame(2.0 * (image.float() / 255.0) - 0.5,
                                   coords)
    st.poses[n] = pose_init
    st.intr[n] = intr_row
    st.patch_xy[n * M:(n + 1) * M] = feats['patch_xy']
    st.depth[n * M:(n + 1) * M] = depth_init
    st.imap[imap_slot * M:(imap_slot + 1) * M] = feats['imap'].to(dt)
    st.gmap[imap_slot * M:(imap_slot + 1) * M] = feats['gmap'].to(dt)
    st.fmap1[fmap_slot] = feats['fmap1'].to(dt)
    st.fmap2[fmap_slot] = feats['fmap2'].to(dt)

    delta = torch.zeros((tab.shape[1], 2), device=st.poses.device)
    if do_update:
        st.net, st.target, st.weight, delta = update_step(
            network, st, tab, t0, n + 1, patch_base, W=W, PC=PC,
            iterations=iterations, run_ba=run_ba, corr_mode=corr_mode,
            oracle=oracle)

    N = st.poses.shape[0]
    ps = min(t0, N - (W + 2))
    ds = min(patch_base, st.depth.shape[0] - PC)
    mirror = torch.cat([st.poses[ps:ps + W + 2].reshape(-1),
                        st.depth[ds:ds + PC], feats['clr'].float().reshape(-1)])
    return mirror, delta
