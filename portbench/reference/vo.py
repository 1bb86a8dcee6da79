"""The DeviceVO frame step in plain PyTorch (reference dpvo/dpvo.py:377-473
on a pair-blocked edge table): a frozen copy of the repository's plain
state machine, computed on the reference's own network and features.

State: a namespace with the program's VOState fields (poses, centers,
depth, colors, imap, gmap, fmap1, fmap2, pi, pj, pvalid, net, target,
weight, tstamps, in_times, delta_src, delta_pose, intr, fslot, n, counter,
is_init). The reference reads its scalars on the host where that is
simpler; the arithmetic and every decision are the runtime's.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from . import lie
from .ba import bundle_adjust_pairs, pair_centers, pair_depth, window_rows
from .corr import corr_two_level

CNT_CAP = 16384     # input frames a sequence may hold


def statics(dp):
    """The runtime's static sizes from the configuration's DPVO keys."""
    r, rw = dp['PATCH_LIFETIME'], dp['REMOVAL_WINDOW']
    total = sum(min(r - 1, k - 1) + r for k in range(1, rw + 1)) + 2 * r - 1
    return dict(M=dp['PATCHES_PER_FRAME'], W=dp['OPTIMIZATION_WINDOW'],
                PCF=rw + 4, r=r, kf_index=dp['KEYFRAME_INDEX'],
                removal_window=rw, kf_thresh=float(dp['KEYFRAME_THRESH']),
                damping=float(dp['MOTION_DAMPING']),
                motion=dp['MOTION_MODEL'], N=dp['BUFFER_SIZE'],
                GP=-(-total // 64) * 64, pmem=max(36, rw + 7))


def init_state(s, H, W, intr, D, C, P, dev):
    """The empty state: identity poses, unit depths, no pairs."""
    M, N, GP, pmem = s['M'], s['N'], s['GP'], s['pmem']
    ident = torch.tensor([0, 0, 0, 0, 0, 0, 1.0], device=dev)
    z = dict(device=dev)
    return SimpleNamespace(
        poses=ident.repeat(N, 1), centers=torch.zeros((N, 2 * M), **z),
        depth=torch.ones((N * M,), **z), colors=torch.zeros((N, M, 3), **z),
        imap=torch.zeros((pmem * M, D), **z),
        gmap=torch.zeros((pmem * M, P, P, C), **z),
        fmap1=torch.zeros((pmem, H // 4, W // 4, C), **z),
        fmap2=torch.zeros((pmem, H // 16, W // 16, C), **z),
        pi=torch.zeros((GP,), dtype=torch.long, **z),
        pj=torch.zeros((GP,), dtype=torch.long, **z),
        pvalid=torch.zeros((GP,), dtype=torch.bool, **z),
        net=torch.zeros((GP, M, D), **z), target=torch.zeros((GP, M, 2), **z),
        weight=torch.zeros((GP, M, 2), **z),
        tstamps=torch.zeros((N,), dtype=torch.long, **z),
        in_times=torch.zeros((CNT_CAP,), **z),
        delta_src=torch.full((CNT_CAP,), -1, dtype=torch.long, **z),
        delta_pose=ident.repeat(CNT_CAP, 1),
        intr=torch.as_tensor(intr, dtype=torch.float32, device=dev) / 4.0,
        fslot=torch.zeros((N,), dtype=torch.long, **z),
        n=torch.zeros((), dtype=torch.long, **z),
        counter=torch.zeros((), dtype=torch.long, **z),
        is_init=torch.zeros((), dtype=torch.bool, **z))


def _median(x):
    s = torch.sort(x.reshape(-1)).values
    k = s.shape[0]
    return s[k // 2] if k % 2 else 0.5 * (s[k // 2 - 1] + s[k // 2])


def _row(buf, i):
    return buf.index_select(0, i.clamp(0, buf.shape[0] - 1).reshape(1))[0]


def _rows(buf, start, size):
    return buf.index_select(0, window_rows(start, size, buf.shape[0],
                                           buf.device))


def center_flow(poses, centers, depth, intr, i, j, M, beta=0.5):
    """Mean blended flow magnitude of frame i's patch centers into frame
    j (reference pops.flow_mag at the keyframe test, dpvo.py:257-264)."""
    fx, fy, cx, cy = intr.unbind(0)
    c = _row(centers, i).reshape(M, 2)
    d = _rows(depth, i * M, M)
    X0 = torch.stack([(c[:, 0] - cx) / fx, (c[:, 1] - cy) / fy,
                      torch.ones_like(d), d], dim=-1)
    Gij = lie.se3_mul(_row(poses, j), lie.se3_inv(_row(poses, i)))

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


def _pair_neighbors(pi, pj, pvalid):
    same_i = (pi[:, None] == pi[None, :]) & pvalid[:, None] & pvalid[None, :]
    dj = pj[None, :] - pj[:, None]
    big = 10 ** 6
    pmax, prev = torch.where(same_i & (dj < 0), pj[None, :], -big).max(dim=1)
    nmax, nxt = torch.where(same_i & (dj > 0), -pj[None, :], -big).max(dim=1)
    return (torch.where(pmax > -big, prev, -1),
            torch.where(nmax > -big, nxt, -1))


def _reproject(poses, centers, depth, intr, pi, pj, M, P):
    fx, fy, cx, cy = intr.unbind(0)
    c = pair_centers(centers, pi, M)
    d = pair_depth(depth, pi, M)
    off = torch.arange(-(P // 2), P // 2 + 1, dtype=torch.float32,
                       device=poses.device)
    shape = c.shape[:2] + (P, P)
    gx = (c[..., 0, None, None] + off[None, None, None, :]).expand(shape)
    gy = (c[..., 1, None, None] + off[None, None, :, None]).expand(shape)
    X0 = torch.stack([(gx - cx) / fx, (gy - cy) / fy, torch.ones_like(gx),
                      d[..., None, None].expand(shape)], dim=-1)
    Gij = lie.se3_mul(poses[pj.clamp(min=0)], lie.se3_inv(poses[pi.clamp(
        min=0)]))
    X1 = lie.se3_act4(Gij[:, None, None, None, :], X0)
    Z = X1[..., 2].clamp(min=0.1)
    return torch.stack([fx * X1[..., 0] / Z + cx, fy * X1[..., 1] / Z + cy],
                       dim=-1)


def _shift_frames(st, k, n, rm, M, span):
    N = st.poses.shape[0]
    rows = window_rows(k, min(span, N), N, st.poses.device)
    src = torch.where(rm & (rows >= k) & (rows < n - 1), rows + 1, rows)
    for buf in (st.poses, st.tstamps, st.colors, st.centers, st.fslot,
                st.depth.view(N, M)):
        buf.index_copy_(0, rows, buf.index_select(0, src))


def _compact_pairs(st):
    order = torch.sort(torch.where(st.pvalid, st.pj, 1 << 20),
                       stable=True).indices
    # `center` (the reprojected patch centers the targets were made from,
    # kept for the check) moves with the pairs too
    for name in ('pi', 'pj', 'pvalid', 'net', 'target', 'weight', 'center'):
        if hasattr(st, name):
            setattr(st, name, getattr(st, name)[order])


def _set_rows(buf, idx, val):
    return torch.cat([buf, buf[:1]]).index_copy_(0, idx, val)[:-1]


def _update_ba(net, st, n1, s, iterations):
    """`iterations` rounds of correlation, update operator and a 2-step
    BA over the live pairs."""
    M, W, PCF = s['M'], s['W'], s['PCF']
    GP = st.pi.shape[0]
    pmem = st.gmap.shape[0] // M
    P = st.gmap.shape[1]
    D = st.imap.shape[1]
    mask3 = st.pvalid[:, None].expand(GP, M)
    t0 = (n1 - W).clamp(min=1)
    fbase = (n1 - (PCF - 2)).clamp(min=0)
    ix_pair, jx_pair = _pair_neighbors(st.pi, st.pj, st.pvalid)
    ar = torch.arange(M, device=st.pi.device)
    for it in range(iterations):
        coords = _reproject(st.poses, st.centers, st.depth, st.intr, st.pi,
                            st.pj, M, P)
        psl = st.fslot[st.pi.clamp(min=0)]
        kk = (psl[:, None] * M + ar[None, :]).reshape(GP * M)
        jj = st.fslot[st.pj.clamp(min=0)].repeat_interleave(M)
        nv = int(st.pvalid.sum()) * M
        corr = corr_two_level(st.gmap, st.fmap1, st.fmap2,
                              coords.reshape(GP * M, P, P, 2), kk, jj, nv=nv)
        inp = st.imap.view(pmem, M * D)[psl].reshape(GP * M, D)
        out, delta, wgt = net.update(st.net.reshape(GP * M, D), inp,
                                     corr.reshape(GP * M, -1), ix_pair,
                                     jx_pair, psl, mask3, pmem)
        st.net = net.store(out.reshape(GP, M, D))
        center = coords[:, :, P // 2, P // 2, :]
        st.center = center
        st.target = center + delta.reshape(GP, M, 2)
        st.weight = torch.where(mask3[..., None], wgt.reshape(GP, M, 2), 0.0)
        if it == 0:
            # the first iteration's hidden state and weights (the check
            # compares the bootstrap's, before any bundle adjustment)
            st.net1, st.weight1 = st.net, st.weight
        st.poses, st.depth = bundle_adjust_pairs(
            st.poses, st.centers, st.depth, st.intr, st.target, st.weight,
            1e-4, st.pi, st.pj, st.pvalid, t0, n1, fbase, M=M, W=W, PCF=PCF,
            iterations=2)


def frame_step(net, st, image, aux, s, decide=None):
    """Track one frame (reference dpvo.py:377-473); updates `st` in place.
    image (H, W, 3) uint8 on the state's device; aux (M, 4) f32 [x, y,
    depth seed, tstamp]. Every frame is accepted (the runtime's
    force_accept: random weights never pass the motion probe). `decide`
    (optional) maps the keyframe test's mean flow to its decision, in
    place of flow < KEYFRAME_THRESH. Returns the new frame's features
    (patchify's dict)."""
    M, N = s['M'], s['N']
    n, counter = st.n, st.counter
    GP = st.pi.shape[0]
    pmem = st.gmap.shape[0] // M
    dev = st.poses.device
    coords, depth_seed, tstamp = aux[:, :2], aux[:, 2], aux[0, 3]

    feats = net.patchify(image.float() * (2.0 / 255.0) - 0.5, coords)

    P1 = _row(st.poses, n - 1)
    pose_init = P1
    if s['motion'] == 'DAMPED_LINEAR':
        P2 = _row(st.poses, n - 2)
        tc = _row(st.in_times, counter - 1)
        tb = _row(st.in_times, counter - 2)
        fac = torch.where((counter >= 2) & ((tb - tc).abs() > 0),
                          (tstamp - tc) / torch.clamp(tc - tb, min=1e-6), 1.0)
        xi = s['damping'] * fac * lie.se3_log(lie.se3_mul(P1, lie.se3_inv(
            P2)))
        pose_init = torch.where(n > 1, lie.se3_mul(lie.se3_exp(xi), P1), P1)
    med = _median(_rows(st.depth, (n - 3).clamp(min=0) * M, 3 * M))
    depth_init = torch.where(st.is_init, med.expand(M), depth_seed)

    nw = n.clamp(max=N - 1).reshape(1)
    st.poses.index_copy_(0, nw, pose_init[None])
    st.centers.index_copy_(0, nw, coords.reshape(1, 2 * M))
    st.depth.index_copy_(0, window_rows(n * M, M, N * M, dev), depth_init)
    st.colors.index_copy_(0, nw, feats['clr'][None])
    st.tstamps.index_copy_(0, nw, counter.reshape(1))
    st.in_times.index_copy_(0, counter.clamp(max=CNT_CAP - 1).reshape(1),
                            tstamp.reshape(1))

    # ring slot: the lowest one no live frame of the last PCF + 2 uses
    live_cap = s['PCF'] + 2
    live_lo = (n - live_cap + 1).clamp(min=0)
    pos = window_rows(live_lo, min(live_cap, N), N, dev)
    used = torch.zeros((pmem + 1,), dtype=torch.int32, device=dev)
    used.index_fill_(0, torch.where((pos >= live_lo) & (pos < n),
                                    st.fslot.index_select(0, pos), pmem), 1)
    slot = torch.argmin(used[:pmem]).reshape(1)
    st.fslot.index_copy_(0, nw, slot)
    st.imap.view(pmem, M, -1).index_copy_(0, slot, feats['imap'][None])
    st.gmap.view((pmem, M) + st.gmap.shape[1:]).index_copy_(
        0, slot, feats['gmap'][None])
    st.fmap1.index_copy_(0, slot, feats['fmap1'][None])
    st.fmap2.index_copy_(0, slot, feats['fmap2'][None])

    st.counter = counter + 1
    n1 = n + 1
    was_init = bool(st.is_init)
    bootstrap = not was_init and int(n1) == 8
    st.is_init = st.is_init | (n1 == 8)

    r = s['r']
    ar = torch.arange(r, device=dev)
    last = (n1 - 1).expand(r)
    new_i = torch.cat([n1 - r + ar[:-1], last])
    new_j = torch.cat([last[:-1], n1 - r + ar])
    new_v = (new_i >= 0) & (new_j >= 0)
    idx = st.pvalid.sum() + torch.cumsum(new_v.long(), 0) - 1
    idx = torch.where(new_v & (idx < GP), idx, GP)
    st.pi = _set_rows(st.pi, idx, new_i.clamp(min=0))
    st.pj = _set_rows(st.pj, idx, new_j.clamp(min=0))
    st.pvalid = _set_rows(st.pvalid, idx, new_v)
    fresh = _set_rows(torch.zeros(GP, dtype=torch.bool, device=dev), idx,
                      new_v)
    st.net = st.net.masked_fill(fresh[:, None, None], 0.0)
    st.target = st.target.masked_fill(fresh[:, None, None], 0.0)
    st.weight = st.weight.masked_fill(fresh[:, None, None], 0.0)
    _compact_pairs(st)

    iters = 12 if bootstrap else (1 if was_init else 0)
    poses0, depth0 = st.poses.clone(), st.depth.clone()
    _update_ba(net, st, n1, s, iters)
    # how far this frame's BA moved the poses and depths: the scale the
    # comparison measures a gap against
    st.ba_pose_step = float(torch.linalg.vector_norm(st.poses - poses0))
    st.ba_depth_step = float(torch.linalg.vector_norm(st.depth - depth0))
    st.n = n1

    if was_init:
        kf = s['kf_index']
        i, j = n1 - kf - 1, n1 - kf + 1
        mflow = 0.5 * (
            center_flow(st.poses, st.centers, st.depth, st.intr, i, j, M) +
            center_flow(st.poses, st.centers, st.depth, st.intr, j, i, M))
        st.mflow = float(mflow)
        rm = mflow < s['kf_thresh'] if decide is None else \
            torch.tensor(decide(st.mflow), device=dev)
        k = n1 - kf
        t1 = st.tstamps.index_select(0, k.reshape(1))
        dP = lie.se3_mul(_row(st.poses, k), lie.se3_inv(_row(st.poses, k - 1)))
        st.delta_src.index_copy_(0, t1, torch.where(
            rm, _row(st.tstamps, k - 1), st.delta_src.index_select(0, t1)))
        st.delta_pose.index_copy_(0, t1, torch.where(
            rm, dP[None], st.delta_pose.index_select(0, t1)))
        drop = rm & ((st.pi == k) | (st.pj == k))
        st.pvalid = st.pvalid & ~drop
        st.pi = torch.where(rm & (st.pi > k), st.pi - 1, st.pi)
        st.pj = torch.where(rm & (st.pj > k), st.pj - 1, st.pj)
        _shift_frames(st, k, n1, rm, M, kf)
        st.n = n1 - rm.long()
        st.pvalid = st.pvalid & (st.pi >= st.n - s['removal_window'])
        _compact_pairs(st)
    return feats
