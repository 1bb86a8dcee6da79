"""Device-resident VO state machine (the pure-VO main path).

Port of dpvo_tpu/runtime/device_vo.py:vo_frame / vo_refine (reference
dpvo/dpvo.py:377-473). All per-frame tensors stay on the device: the
pair-blocked edge table (GP_CAP pairs x M patches, with validity masks),
patch and feature buffers, the feature-ring slot map, poses, depths and the
trajectory deltas of removed keyframes.

Control flow. The JAX version decides everything in-graph (lax.cond /
fori_loop). Here the scalars that decide it -- keyframe count `n`, input
counter `counter`, `is_init` -- live on the host: they follow from the
accept and keyframe decisions alone. Two decisions depend on device values
and read one scalar back (a device sync each):
  * the motion probe (only without force_accept, before initialization);
  * the keyframe test `mflow < kf_thresh` (every frame once initialized).
Everything else (pair append, compaction, slot allocation, the update
and BA loop) is enqueued without a sync.

Ingest (vo_frame_packed1, vo_frames_packed1): one flat uint8 upload per
frame, [image bytes (rgb, or I420 planes turned back into RGB here by
i420_to_rgb) | (M, 4) f32 aux bytes]. An optional target oracle (the
accuracy tests' seam, _call_oracle) replaces the correlation and the update
operator; the reprojection and the BA still run.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from .. import lie
from ..ba_pairs import bundle_adjust_pairs, clamp_start, pair_centers, \
    pair_depth
from ..models.vonet import DIM, P
from ..ops.corr_fused import corr_fused
from ..ops.corr_onepass import corr_two_level

CNT_CAP = 16384     # max input frames per sequence


@dataclass
class VOState:
    poses: torch.Tensor        # (N, 7)
    centers: torch.Tensor      # (N, 2*M) frame-major (M, 2) blocks
    depth: torch.Tensor        # (N*M,)
    colors: torch.Tensor       # (N, M, 3) f32
    imap: torch.Tensor         # (pmem*M, DIM)
    gmap: torch.Tensor         # (pmem*M, P, P, 128)
    fmap1: torch.Tensor        # (mem, H/4, W/4, 128) channels-last
    fmap2: torch.Tensor        # (mem, H/16, W/16, 128) channels-last
    pi: torch.Tensor           # (GP,) int64 source frame per pair
    pj: torch.Tensor           # (GP,) int64 target frame per pair
    pvalid: torch.Tensor       # (GP,) bool
    net: torch.Tensor          # (GP, M, DIM)
    target: torch.Tensor       # (GP, M, 2)
    weight: torch.Tensor       # (GP, M, 2)
    tstamps: torch.Tensor      # (N,) int64: keyframe -> input counter
    in_times: torch.Tensor     # (CNT_CAP,) f32 raw input timestamps
    delta_src: torch.Tensor    # (CNT_CAP,) int64 (-1 = live keyframe)
    delta_pose: torch.Tensor   # (CNT_CAP, 7)
    intr: torch.Tensor         # (4,) intrinsics / RES
    fslot: torch.Tensor        # (N,) int64 frame index -> feature ring slot
    n: int = 0                 # keyframe count (host)
    counter: int = 0           # input frame count (host)
    is_init: bool = False      # (host)

    def tensors(self):
        return {f.name: getattr(self, f.name) for f in fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)}


def ring_capacity(cfg):
    """Feature-ring slots: the slot allocator scans a live window of
    REMOVAL_WINDOW + 6 frames, so the ring must strictly exceed it."""
    return max(36, int(cfg.REMOVAL_WINDOW) + 7)


def _gp_cap(cfg):
    """Static pair capacity = exact steady-state maximum of live pairs.

    A source frame i = n-k contributes at most r backward pairs plus
    min(r-1, k-1) forward pairs; sources retire when k > REMOVAL_WINDOW.
    One frame's fresh appends (2r-1) are added as margin."""
    r = cfg.PATCH_LIFETIME
    rw = cfg.REMOVAL_WINDOW
    total = sum(min(r - 1, k - 1) + r for k in range(1, rw + 1))
    total += 2 * r - 1
    return int(-(-total // 64) * 64)


def init_state(cfg, ht, wd, intrinsics, device, dtype):
    """Empty VOState on `device`; feature buffers in `dtype`."""
    M = cfg.PATCHES_PER_FRAME
    N = cfg.BUFFER_SIZE
    pmem = ring_capacity(cfg)
    GP = _gp_cap(cfg)
    h4, w4 = ht // 4, wd // 4
    kw = dict(device=device)
    ident = torch.tensor([0, 0, 0, 0, 0, 0, 1.0], **kw)
    return VOState(
        poses=ident.repeat(N, 1),
        centers=torch.zeros((N, 2 * M), **kw),
        depth=torch.ones((N * M,), **kw),
        colors=torch.zeros((N, M, 3), **kw),
        imap=torch.zeros((pmem * M, DIM), dtype=dtype, **kw),
        gmap=torch.zeros((pmem * M, P, P, 128), dtype=dtype, **kw),
        fmap1=torch.zeros((pmem, h4, w4, 128), dtype=dtype, **kw),
        fmap2=torch.zeros((pmem, h4 // 4, w4 // 4, 128), dtype=dtype, **kw),
        pi=torch.zeros((GP,), dtype=torch.long, **kw),
        pj=torch.zeros((GP,), dtype=torch.long, **kw),
        pvalid=torch.zeros((GP,), dtype=torch.bool, **kw),
        net=torch.zeros((GP, M, DIM), dtype=dtype, **kw),
        target=torch.zeros((GP, M, 2), **kw),
        weight=torch.zeros((GP, M, 2), **kw),
        tstamps=torch.zeros((N,), dtype=torch.long, **kw),
        in_times=torch.zeros((CNT_CAP,), **kw),
        delta_src=torch.full((CNT_CAP,), -1, dtype=torch.long, **kw),
        delta_pose=ident.repeat(CNT_CAP, 1),
        intr=torch.as_tensor(np.asarray(intrinsics, np.float32) / 4.0,
                             device=device),
        fslot=torch.zeros((N,), dtype=torch.long, **kw),
    )


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _median(x):
    """Median that averages the two middle values of an even count, like
    jnp.median (torch.median returns the lower one)."""
    s = torch.sort(x.reshape(-1)).values
    k = s.shape[0]
    return s[k // 2] if k % 2 else 0.5 * (s[k // 2 - 1] + s[k // 2])


def _center_flow(poses, centers, depth, intr, i, j, M, beta=0.5):
    """Mean blended flow magnitude of frame i's patch centers into frame j
    (reference pops.flow_mag at the keyframe test, dpvo.py:257-264)."""
    fx, fy, cx, cy = intr.unbind(0)
    i_c = clamp_start(i, 1, centers.shape[0])
    c = centers[i_c].reshape(M, 2)
    s = clamp_start(i * M, M, depth.shape[0])
    d = depth[s:s + M]
    X0 = torch.stack([(c[:, 0] - cx) / fx, (c[:, 1] - cy) / fy,
                      torch.ones_like(d), d], dim=-1)
    # poses[i] / poses[j] with gather-style index clamping
    N = poses.shape[0]
    Gij = lie.se3_mul(poses[min(max(j, 0), N - 1)],
                      lie.se3_inv(poses[min(max(i, 0), N - 1)]))

    def proj(X):
        Z = X[..., 2].clamp(min=0.1)
        return torch.stack([fx * X[..., 0] / Z + cx,
                            fy * X[..., 1] / Z + cy], dim=-1)

    co1 = proj(lie.se3_act4(Gij[None], X0))
    Xt = torch.cat([X0[..., :3] + d[:, None] * Gij[:3][None], X0[..., 3:]],
                   dim=-1)
    co2 = proj(Xt)
    f1 = torch.linalg.vector_norm(co1 - c, dim=-1)
    f2 = torch.linalg.vector_norm(co2 - c, dim=-1)
    return (beta * f1 + (1 - beta) * f2).mean()


def _slot_of(fslot, idx):
    """Ring slot of each frame index."""
    return fslot[idx.clamp(min=0)]


def _pair_neighbors(pi, pj, pvalid):
    """Per-pair previous / next pair with the same source frame, ordered by
    target frame (replaces fastba.neighbors, ba.cpp:59-97). -1 if none."""
    same_i = (pi[:, None] == pi[None, :]) & pvalid[:, None] & pvalid[None, :]
    dj = pj[None, :] - pj[:, None]
    big = 10 ** 6
    prev_key = torch.where(same_i & (dj < 0), pj[None, :], -big)
    next_key = torch.where(same_i & (dj > 0), -pj[None, :], -big)
    pmax, prev = prev_key.max(dim=1)
    nmax, nxt = next_key.max(dim=1)
    return (torch.where(pmax > -big, prev, -1),
            torch.where(nmax > -big, nxt, -1))


def _reproject_pairs(poses, centers, depth, intr, pi, pj, M):
    """(GP, M, P, P, 2) full-patch reprojection from the patch centers."""
    fx, fy, cx, cy = intr.unbind(0)
    c = pair_centers(centers, pi, M)                       # (GP, M, 2)
    d = pair_depth(depth, pi, M)                           # (GP, M)
    off = torch.arange(-(P // 2), P // 2 + 1, dtype=torch.float32,
                       device=poses.device)
    shape = c.shape[:2] + (P, P)
    gx = (c[..., 0, None, None] + off[None, None, None, :]).expand(shape)
    gy = (c[..., 1, None, None] + off[None, None, :, None]).expand(shape)
    xn = (gx - cx) / fx
    yn = (gy - cy) / fy
    X0 = torch.stack([xn, yn, torch.ones_like(xn),
                      d[..., None, None].expand(shape)], dim=-1)
    Gij = lie.se3_mul(poses[pj.clamp(min=0)],
                      lie.se3_inv(poses[pi.clamp(min=0)]))
    X1 = lie.se3_act4(Gij[:, None, None, None, :], X0)
    Z = X1[..., 2].clamp(min=0.1)
    return torch.stack([fx * X1[..., 0] / Z + cx,
                        fy * X1[..., 1] / Z + cy], dim=-1)


def _shift_frames(st, k, M):
    """Keyframe removal: frame rows (k, n) move down by one. The feature
    buffers stay put; the fslot map that points into them shifts instead."""
    n = st.n
    for name in ('poses', 'tstamps', 'colors', 'centers', 'fslot'):
        buf = getattr(st, name)
        buf[k:n - 1] = buf[k + 1:n].clone()
    st.depth[k * M:(n - 1) * M] = st.depth[(k + 1) * M:n * M].clone()


def _compact_pairs(st):
    """Sort pairs by target frame, invalid last (stable); permute the
    per-pair state. Valid pairs become a prefix, and edges sharing a target
    frame are adjacent (the correlation kernel's cache locality)."""
    BIG = 1 << 20
    order = torch.sort(torch.where(st.pvalid, st.pj, BIG), stable=True).indices
    for name in ('pi', 'pj', 'pvalid', 'net', 'target', 'weight'):
        setattr(st, name, getattr(st, name)[order])


def _set_rows(buf, idx, val):
    """buf[idx] = val where idx == len(buf) means "drop" (the
    .at[].set(mode='drop') semantics): the write goes to a spare row."""
    ext = torch.cat([buf, buf[:1]])
    ext[idx] = val
    return ext[:-1]


def _corr_features(st, pi_a, pj_a, pv_a, poses, depth, M, corr_dtype,
                   corr_impl='onepass'):
    """Reprojected coords, correlation features and context for pairs
    (pi_a, pj_a): (G, M, P, P, 2), (G*M, 882), (G*M, DIM). corr_impl
    'onepass' runs K1 (edges of invalid pairs are zeros), 'fused' K2 + K3
    over every edge, as dpvo_tpu does (device_vo.py:458-463)."""
    coords_r = _reproject_pairs(poses, st.centers, depth, st.intr, pi_a, pj_a,
                                M)
    G = pi_a.shape[0]
    E = G * M
    pmem = st.gmap.shape[0] // M
    psl = _slot_of(st.fslot, pi_a)
    ar = torch.arange(M, device=psl.device)
    kk = (psl[:, None] * M + ar[None, :]).reshape(E).int()
    jj = _slot_of(st.fslot, pj_a).repeat_interleave(M).int()
    coords_f = coords_r.reshape(E, P, P, 2)
    if corr_impl == 'onepass':
        nv = pv_a.sum() * M       # valid pairs are a prefix (_compact_pairs)
        corr = corr_two_level(st.gmap, st.fmap1, st.fmap2, coords_f, kk, jj,
                              nv=nv, out_dtype=corr_dtype)
    else:
        corr = torch.stack(corr_fused(st.gmap, st.fmap1, st.fmap2, coords_f,
                                      kk, jj), dim=-1)
    inp = st.imap.view(pmem, M * DIM)[psl].reshape(E, DIM)
    return coords_r, corr.reshape(E, -1), inp


def _call_oracle(oracle, st, M):
    """Targets and weights of every pair edge from a target oracle with the
    hybrid runtime's contract, (poses, patch_xy, depth, intr, ii, jj, kk)
    -> ((E, 2), (E, 2)) (runtime/state.py:update_step). The pair-blocked
    state keeps bare centers, so the edge view is synthesized: patch_xy
    repeats each center over the P x P grid (an oracle reads only the
    center tap), and ii / jj go through st.tstamps to input-frame indices,
    which is what a ground-truth oracle indexes its trajectory by; they
    equal the keyframe indices until a keyframe is removed."""
    GP = st.pi.shape[0]
    ar = torch.arange(M, device=st.pi.device)
    ii = st.tstamps[st.pi].repeat_interleave(M)
    jj = st.tstamps[st.pj].repeat_interleave(M)
    kk = (st.pi[:, None] * M + ar).reshape(GP * M)
    cent = st.centers.reshape(-1, 2)
    patch_xy = cent[:, :, None, None].expand(cent.shape + (P, P))
    intr = st.intr[None].expand(st.poses.shape[0], 4)
    return oracle(st.poses, patch_xy, st.depth, intr, ii, jj, kk)


def _update_ba(network, st, n1, *, M, W, PCF, iterations,
               corr_impl='onepass', oracle=None):
    """`iterations` rounds of correlation + update operator + 2-step BA over
    the live pairs (the body of vo_frame's update loop and of vo_refine).
    W = OPTIMIZATION_WINDOW: the BA's pose slots, ending at keyframe n1.
    With an oracle, its targets and weights replace the correlation and
    the update operator; the net state stays as it is."""
    GP = st.pi.shape[0]
    pmem = st.gmap.shape[0] // M
    ar = torch.arange(M, device=st.pi.device)
    edge_mask = st.pvalid.repeat_interleave(M)
    mask3 = edge_mask.reshape(GP, M, 1)
    t0 = max(n1 - W, 1)
    fbase = max(n1 - (PCF - 2), 0)
    if oracle is None:
        ix_pair, jx_pair = _pair_neighbors(st.pi, st.pj, st.pvalid)
        ix_e = torch.where(ix_pair[:, None] >= 0, ix_pair[:, None] * M + ar,
                           -1).reshape(GP * M)
        jx_e = torch.where(jx_pair[:, None] >= 0, jx_pair[:, None] * M + ar,
                           -1).reshape(GP * M)
        # patch groups keyed by source ring slot (unique among live frames)
        kk_ids = (_slot_of(st.fslot, st.pi)[:, None] * M + ar).reshape(GP * M)
        pair_ids = torch.arange(GP, device=ar.device).repeat_interleave(M)
    for _ in range(iterations):
        if oracle is None:
            coords_r, corr_feat, inp = _corr_features(
                st, st.pi, st.pj, st.pvalid, st.poses, st.depth, M,
                network.dtype, corr_impl)
            netf, delta, wgt = network.update_op(
                st.net.reshape(GP * M, DIM), inp, corr_feat, ix_e, jx_e,
                kk_ids, pair_ids, num_segments=GP * M, edge_mask=edge_mask,
                num_segments_kk=pmem * M, num_segments_ij=GP,
                gather_pairs=(ix_pair, jx_pair, M))
            st.net = netf.reshape(GP, M, DIM)
            center = coords_r[:, :, P // 2, P // 2, :]
            st.target = center + delta.reshape(GP, M, 2)
            st.weight = torch.where(mask3, wgt.reshape(GP, M, 2), 0.0)
        else:
            center = _reproject_pairs(st.poses, st.centers, st.depth, st.intr,
                                      st.pi, st.pj, M)[:, :, P // 2, P // 2]
            tgt, wgt = _call_oracle(oracle, st, M)
            st.target = torch.where(mask3, tgt.reshape(GP, M, 2), center)
            st.weight = torch.where(mask3, wgt.reshape(GP, M, 2), 0.0)
        st.poses, st.depth = bundle_adjust_pairs(
            st.poses, st.centers, st.depth, st.intr, st.target, st.weight,
            1e-4, st.pi, st.pj, st.pvalid, t0, n1, fbase,
            M=M, W=W, PCF=PCF, iterations=2)


# ---------------------------------------------------------------------------
# the per-frame step
# ---------------------------------------------------------------------------

@torch.no_grad()
def vo_frame(network, st, image, aux, *, M, W, PCF, r, kf_index,
             removal_window, kf_thresh, motion_damping, motion_model,
             force_accept=False, corr_impl='onepass', oracle=None):
    """Track one frame (reference dpvo.py:377-473); updates `st` in place.

    image (H, W, 3) on the state's device, uint8 or f32 in [0, 255]
    (i420_to_rgb's output); aux (M, 4) f32 [x, y, depth seed, tstamp]
    (patch centroids at 1/4 scale, the frame's depth seeds, its timestamp
    in every row). oracle: see _update_ba; pair it with force_accept (the
    motion probe still runs the learned network)."""
    n = st.n
    N = st.poses.shape[0]
    GP = st.pi.shape[0]
    pmem = st.gmap.shape[0] // M
    dev = st.poses.device
    coords, depth_seed, tstamp = aux[:, :2], aux[:, 2], aux[0, 3]

    # ---------------- patchify + store ---------------- #
    ndt = network.dtype
    img = image.to(ndt) * torch.tensor(2.0 / 255.0, dtype=ndt, device=dev) \
        - torch.tensor(0.5, dtype=ndt, device=dev)
    feats = network.patchify_frame(img, coords)

    # motion model (dpvo.py:410-424); indices clamp like the JAX gathers
    P1 = st.poses[max(n - 1, 0)]
    if n > 1 and motion_model == 'DAMPED_LINEAR':
        P2 = st.poses[max(n - 2, 0)]
        tc = st.in_times[max(st.counter - 1, 0)]
        tb = st.in_times[max(st.counter - 2, 0)]
        if st.counter >= 2:
            fac = torch.where((tb - tc).abs() > 0,
                              (tstamp - tc) / torch.clamp(tc - tb, min=1e-6),
                              1.0)
        else:
            fac = torch.ones((), device=dev)
        xi = motion_damping * fac * lie.se3_log(
            lie.se3_mul(P1, lie.se3_inv(P2)))
        pose_init = lie.se3_mul(lie.se3_exp(xi), P1)
    else:
        pose_init = P1

    # depth init (dpvo.py:426-431): median of the last 3 frames' depths
    if st.is_init:
        lo = clamp_start(max(n - 3, 0) * M, 3 * M, st.depth.shape[0])
        depth_init = _median(st.depth[lo:lo + 3 * M]).expand(M)
    else:
        depth_init = depth_seed

    nw = min(n, N - 1)          # dynamic_update_slice clamps its start
    st.poses[nw] = pose_init
    st.centers[nw] = feats['patch_xy'][:, :, 1, 1].reshape(2 * M)
    s = clamp_start(n * M, M, st.depth.shape[0])
    st.depth[s:s + M] = depth_init
    st.colors[nw] = feats['clr']
    st.tstamps[nw] = st.counter
    st.in_times[st.counter] = tstamp

    # ring-slot allocation: the first slot no live frame references
    live_lo = max(n - (PCF + 2) + 1, 0)
    used = torch.zeros((pmem,), dtype=torch.int32, device=dev)
    used[st.fslot[live_lo:n]] = 1
    slot = torch.argmin(used).reshape(1)     # first minimum: lowest free slot
    st.fslot[nw:nw + 1] = slot
    st.imap.view(pmem, M, DIM).index_copy_(0, slot,
                                           feats['imap'][None].to(ndt))
    st.gmap.view(pmem, M, P, P, 128).index_copy_(
        0, slot, feats['gmap'][None].to(ndt))
    st.fmap1.index_copy_(0, slot, feats['fmap1'][None].to(ndt))
    st.fmap2.index_copy_(0, slot, feats['fmap2'][None].to(ndt))

    # ---------------- probe (pre-init accept test) ---------------- #
    if force_accept or st.is_init or n == 0:
        accept = True
    else:
        pi_p = torch.full((1,), max(n - 1, 0), dtype=torch.long, device=dev)
        _, corr_feat, inp = _corr_features(
            st, pi_p, pi_p + 1, torch.ones((1,), dtype=torch.bool,
                                           device=dev),
            st.poses, st.depth, M, ndt, corr_impl)
        ids = torch.arange(M, device=dev)
        neg = torch.full((M,), -1, dtype=torch.long, device=dev)
        _, delta, _ = network.update_op(
            torch.zeros((M, DIM), dtype=ndt, device=dev), inp, corr_feat,
            neg, neg, ids, torch.zeros((M,), dtype=torch.long, device=dev),
            num_segments=M, edge_mask=torch.ones((M,), dtype=torch.bool,
                                                 device=dev))
        # device sync: the accept decision needs the probe's value
        accept = bool(_median(torch.linalg.vector_norm(delta, dim=-1)) >= 2.0)

    if not accept:
        # rejected pre-init frame: identity delta to the previous input
        st.delta_src[st.counter] = st.counter - 1
        st.counter += 1
        return st
    st.counter += 1

    n1 = n + 1
    was_init = st.is_init
    bootstrap = n1 == 8 and not was_init
    st.is_init = was_init or bootstrap

    # ---- append pair factors (dpvo.py:457-459) ---- #
    # forward (i, n1-1) for i in [n1-r, n1-1); backward (n1-1, j) for j in
    # [n1-r, n1)
    new_i = np.concatenate([n1 - r + np.arange(r - 1), np.full(r, n1 - 1)])
    new_j = np.concatenate([np.full(r - 1, n1 - 1), n1 - r + np.arange(r)])
    new_v = (new_i >= 0) & (new_j >= 0)
    new_i, new_j = new_i[new_v], new_j[new_v]
    idx = st.pvalid.sum() + torch.arange(len(new_i), device=dev)
    idx = torch.where(idx < GP, idx, GP)       # past capacity: dropped
    st.pi = _set_rows(st.pi, idx, torch.as_tensor(new_i, device=dev))
    st.pj = _set_rows(st.pj, idx, torch.as_tensor(new_j, device=dev))
    st.pvalid = _set_rows(st.pvalid, idx, True)
    fresh = _set_rows(torch.zeros(GP, dtype=torch.bool, device=dev), idx,
                      True)
    st.net = st.net.masked_fill(fresh[:, None, None], 0.0)
    st.target = st.target.masked_fill(fresh[:, None, None], 0.0)
    st.weight = st.weight.masked_fill(fresh[:, None, None], 0.0)
    _compact_pairs(st)

    # ---- update iterations (12 at bootstrap, 1 once initialized) ---- #
    iters = 12 if bootstrap else (1 if st.is_init else 0)
    _update_ba(network, st, n1, M=M, W=W, PCF=PCF, iterations=iters,
               corr_impl=corr_impl, oracle=oracle)
    st.n = n1

    # ---- keyframe decision (dpvo.py:266-310) ---- #
    if was_init:
        i = st.n - kf_index - 1
        j = st.n - kf_index + 1
        mflow = 0.5 * (
            _center_flow(st.poses, st.centers, st.depth, st.intr, i, j, M) +
            _center_flow(st.poses, st.centers, st.depth, st.intr, j, i, M))
        # device sync: the keyframe decision needs the flow's value
        if bool(mflow < kf_thresh):
            k = st.n - kf_index
            t1 = st.tstamps[k:k + 1]
            dP = lie.se3_mul(st.poses[k], lie.se3_inv(st.poses[k - 1]))
            st.delta_src.index_copy_(0, t1, st.tstamps[k - 1:k])
            st.delta_pose.index_copy_(0, t1, dP[None])

            drop = (st.pi == k) | (st.pj == k)
            st.pvalid = st.pvalid & ~drop
            st.pi = torch.where(st.pi > k, st.pi - 1, st.pi)
            st.pj = torch.where(st.pj > k, st.pj - 1, st.pj)
            _shift_frames(st, k, M)
            st.n -= 1

        # retire pairs outside the window (dpvo.py:305-310)
        st.pvalid = st.pvalid & (st.pi >= st.n - removal_window)
        _compact_pairs(st)
    return st


@torch.no_grad()
def vo_refine(network, st, *, M, W, PCF, corr_impl='onepass', oracle=None):
    """One update + BA iteration over the existing pairs (terminate() runs
    this 12 times — reference dpvo.py:181-183)."""
    _update_ba(network, st, st.n, M=M, W=W, PCF=PCF, iterations=1,
               corr_impl=corr_impl, oracle=oracle)
    return st


# ---------------------------------------------------------------------------
# ingest and the chunked step
# ---------------------------------------------------------------------------

def i420_to_rgb(planes, ht, wd):
    """I420 planes (flat uint8: Y (ht, wd), then U and V (ht/2, wd/2)) ->
    (ht, wd, 3) f32 RGB in [0, 255]: video-range BT.601 with 2x2 nearest
    chroma, as dpvo_tpu/runtime/device_vo.py:_i420_to_rgb; within one unit
    of cv2.COLOR_YUV2RGB_I420, which rounds to uint8."""
    n = ht * wd
    q = n // 4
    y = planes[:n].reshape(ht, wd).float()

    def up2(c):                                   # 2x2 nearest upsample
        c = c.reshape(ht // 2, 1, wd // 2, 1).float() - 128.0
        return c.expand(ht // 2, 2, wd // 2, 2).reshape(ht, wd)

    U, V = up2(planes[n:n + q]), up2(planes[n + q:n + 2 * q])
    yv = 1.164 * (y - 16.0)
    r = yv + 1.596 * V
    g = yv - 0.392 * U - 0.813 * V
    b = yv + 2.017 * U
    return torch.stack([r, g, b], dim=-1).clamp(0.0, 255.0)


def unpack_frame(buf, *, ht, wd, M, upload='rgb'):
    """(image, aux) of one flat uint8 upload row [image bytes (rgb: 3,
    yuv420: 1.5 per pixel) | (M, 4) f32 aux bytes]. The aux bytes are
    reinterpreted in place where their offset in the storage is a multiple
    of 4, else copied first."""
    npix = ht * wd * 3 if upload == 'rgb' else ht * wd * 3 // 2
    if upload == 'rgb':
        image = buf[:npix].view(ht, wd, 3)
    else:
        image = i420_to_rgb(buf[:npix], ht, wd)
    tail = buf[npix:npix + 16 * M]
    if tail.storage_offset() % 4:
        tail = tail.clone()
    return image, tail.view(torch.float32).view(M, 4)


def vo_frame_packed(network, st, image, aux, **kw):
    """vo_frame with the (M, 4) aux packed [x, y, depth seed, tstamp]
    (dpvo_tpu's vo_frame_packed): vo_frame itself takes that layout."""
    return vo_frame(network, st, image, aux, **kw)


def vo_frame_packed1(network, st, buf, *, ht, wd, upload='rgb', **kw):
    """vo_frame from one flat uint8 upload (dpvo_tpu's vo_frame_packed1),
    laid out as unpack_frame reads it."""
    image, aux = unpack_frame(buf, ht=ht, wd=wd, M=kw['M'], upload=upload)
    return vo_frame(network, st, image, aux, **kw)


def vo_frames(network, st, images, coords, depth_seeds, tstamps, **kw):
    """Track a chunk of K frames: vo_frame over each, in order (dpvo_tpu's
    vo_frames). images (K, H, W, 3); coords (K, M, 2) f32; depth_seeds
    (K, M) f32; tstamps (K,) f32.

    The math is vo_frame's, frame by frame, and so are its host reads: the
    motion probe's before initialization (without force_accept) and the
    keyframe test's every initialized frame each read one scalar back.
    What a chunk saves on this runtime is uploads (one per K frames), not
    launches."""
    M = kw['M']
    for k in range(images.shape[0]):
        aux = torch.cat([coords[k], depth_seeds[k][:, None],
                         tstamps[k].reshape(1, 1).expand(M, 1)], dim=1)
        st = vo_frame(network, st, images[k], aux, **kw)
    return st


def vo_frames_packed(network, st, images, aux, **kw):
    """vo_frames with the per-frame aux packed as (K, M, 4)."""
    for k in range(images.shape[0]):
        st = vo_frame(network, st, images[k], aux[k], **kw)
    return st


def vo_frames_packed1(network, st, bufs, *, ht, wd, upload='rgb', **kw):
    """vo_frames over the rows of one (K, row bytes) uint8 upload, each
    row laid out as vo_frame_packed1's buf."""
    for buf in bufs:
        st = vo_frame_packed1(network, st, buf, ht=ht, wd=wd, upload=upload,
                              **kw)
    return st
