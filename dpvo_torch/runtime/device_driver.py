"""Host driver of the device-resident VO runtime (DeviceVO).

Port of dpvo_tpu/runtime/device_driver.py. Per frame: patch centroids and
depth seeds are drawn on the host from np.random.RandomState(seed) -- the
same draws, in the same order, as dpvo_tpu -- then one flat uint8 row,
[image bytes | (M, 4) f32 aux bytes], goes to the device in one copy and
vo_frame runs there. The image bytes are the RGB frame or, with
UPLOAD_FORMAT=yuv420, its I420 planes (half the bytes; packed on the host by
i420.rgb_to_i420, turned back into RGB on the device). track_frames uploads
a chunk of such rows in one copy. terminate() runs 12 refinement iterations
and reads the trajectory back once.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..models.vonet import RES, load_vonet
from . import numpy_se3 as nse3
from .centroid import select_coords
from .device_vo import CNT_CAP, init_state, vo_frame_packed1, \
    vo_frames_packed1, vo_refine
from .i420 import rgb_to_i420


CORR_IMPLS = ('onepass', 'fused_k', 'fused')


def _pick_corr_impl():
    """The correlation implementation, 'onepass' or 'fused'. DPVO_CORR_IMPL
    overrides with dpvo_tpu's A/B switch values (device_driver.py:21-40);
    the default is 'onepass', the one-pass kernel K1 (dpvo_tpu's choice on
    a TPU where K1 is available). 'fused' runs the planes kernel K2 and the
    select kernel K3 (ops/corr_fused.py). dpvo_tpu's 'fused_k' (K2 + its
    select kernel) and 'fused' (K2 + its XLA select) both map to it: the
    port has one select, K3. On the CPU each runs its plain PyTorch
    versions."""
    forced = os.environ.get('DPVO_CORR_IMPL', '')
    if not forced:
        return 'onepass'
    if forced not in CORR_IMPLS:
        raise ValueError(f'DPVO_CORR_IMPL={forced!r}: expected one of '
                         f'{CORR_IMPLS}')
    return 'onepass' if forced == 'onepass' else 'fused'


def upload_format(cfg, ht, wd):
    """UPLOAD_FORMAT: 'rgb' or 'yuv420'. I420 needs even dims: with an odd
    one, both runtimes warn and take rgb, as dpvo_tpu does."""
    fmt = str(getattr(cfg, 'UPLOAD_FORMAT', 'rgb')).lower()
    if fmt not in ('rgb', 'yuv420'):
        raise ValueError(f'UPLOAD_FORMAT={fmt!r}: expected rgb or yuv420')
    if fmt == 'yuv420' and (ht % 2 or wd % 2):
        print(f'WARNING: UPLOAD_FORMAT=yuv420 needs even dims, got '
              f'{ht}x{wd}; falling back to rgb ingest')
        fmt = 'rgb'
    return fmt


class DeviceVO:
    """Same public surface as the reference DPVO: construct, __call__,
    terminate; and dpvo_tpu's track_frames, point_cloud and colors."""

    def __init__(self, cfg, network, ht=480, wd=640, viz=False, seed=1234,
                 device='cuda'):
        if viz:
            raise NotImplementedError(
                'the viewer is not ported yet: ROADMAP.md queue 1, item C')
        self.cfg = cfg
        self.ht, self.wd = ht, wd
        self.M = cfg.PATCHES_PER_FRAME
        self.device = torch.device(device)
        self.rng = np.random.RandomState(seed)
        self.network = load_vonet(network, self.device,
                                  bool(cfg.MIXED_PRECISION))
        self._static = dict(
            M=self.M,
            W=cfg.OPTIMIZATION_WINDOW,
            PCF=cfg.REMOVAL_WINDOW + 4,
            r=cfg.PATCH_LIFETIME,
            kf_index=cfg.KEYFRAME_INDEX,
            removal_window=cfg.REMOVAL_WINDOW,
            kf_thresh=float(cfg.KEYFRAME_THRESH),
            motion_damping=float(cfg.MOTION_DAMPING),
            motion_model=cfg.MOTION_MODEL,
            corr_impl=_pick_corr_impl(),
        )
        self._upload = upload_format(cfg, ht, wd)
        # random weights never pass the learned motion probe; benchmarks and
        # smoke runs set this to reach the steady-state workload
        self.force_accept = False
        # optional target oracle, (poses, patch_xy, depth, intr, ii, jj, kk)
        # -> (target, weight) on the device (device_vo._call_oracle): the
        # accuracy tests drive the real state machine with it, with
        # force_accept set
        self._oracle = None
        self.st = None
        self.tlist = []
        self.h2d_bytes = 0       # bytes uploaded by __call__ / track_frames

    def _start(self, K, intrinsics):
        """Build the state on the first call; refuse K more frames when they
        could overflow the input or keyframe capacity."""
        if self.st is None:
            self.st = init_state(self.cfg, self.ht, self.wd, intrinsics,
                                 self.device, self.network.dtype)
        if len(self.tlist) + K >= CNT_CAP:
            raise RuntimeError('input frame capacity exceeded; raise '
                               'device_vo.CNT_CAP')
        # BUFFER_SIZE bounds keyframes (reference dpvo.py:383-384); the
        # keyframe count is known on the host, so the check is exact
        if self.st.n + K + 1 >= self.cfg.BUFFER_SIZE:
            raise RuntimeError(
                f'The buffer size is too small. You can increase it using '
                f'"--opts BUFFER_SIZE={self.cfg.BUFFER_SIZE * 2}"')

    def _pack_buf(self, image, tstamp):
        """One flat uint8 row for vo_frame(s)_packed1: [image bytes (rgb or
        I420) | (M, 4) f32 aux bytes]."""
        image = np.ascontiguousarray(image, np.uint8)
        if image.shape != (self.ht, self.wd, 3):
            raise ValueError(f'expected a ({self.ht}, {self.wd}, 3) frame, '
                             f'got {image.shape}')
        aux = np.empty((self.M, 4), np.float32)
        aux[:, :2] = select_coords(self.cfg, self.rng, image, self.M,
                                   self.ht // RES, self.wd // RES)
        aux[:, 2] = self.rng.rand(self.M)
        aux[:, 3] = tstamp
        pix = rgb_to_i420(image) if self._upload == 'yuv420' else image
        return np.concatenate([pix.reshape(-1), aux.view(np.uint8).ravel()])

    def _upload_rows(self, bufs):
        """One host-to-device copy. The host buffer is made anew for every
        call, so nothing rewrites it while the copy runs."""
        self.h2d_bytes += bufs.nbytes
        return torch.from_numpy(bufs).to(self.device, non_blocking=True)

    def _kw(self):
        return dict(ht=self.ht, wd=self.wd, upload=self._upload,
                    force_accept=self.force_accept, oracle=self._oracle,
                    **self._static)

    def __call__(self, tstamp, image, intrinsics):
        """Track one (ht, wd, 3) uint8 RGB frame."""
        self._start(1, intrinsics)
        buf = self._pack_buf(image, tstamp)
        self.tlist.append(tstamp)
        self.st = vo_frame_packed1(self.network, self.st,
                                   self._upload_rows(buf), **self._kw())

    def track_frames(self, tstamps, images, intrinsics):
        """Track a chunk of K frames from one upload (dpvo_tpu's
        track_frames): images (K, ht, wd, 3) uint8. The math is per-frame
        __call__'s, frame by frame (device_vo.vo_frames), so are its host
        reads; the chunk saves K - 1 uploads."""
        K = len(images)
        self._start(K, intrinsics)
        bufs = np.stack([self._pack_buf(images[k], tstamps[k])
                         for k in range(K)])
        self.tlist.extend(tstamps)
        self.st = vo_frames_packed1(self.network, self.st,
                                    self._upload_rows(bufs), **self._kw())

    def terminate(self):
        """Refine 12 times, then return (poses (T, 7) world-from-camera,
        tstamps (T,)) for every input frame."""
        s = self._static
        for _ in range(12):
            self.st = vo_refine(self.network, self.st, M=s['M'], W=s['W'],
                                PCF=s['PCF'], corr_impl=s['corr_impl'],
                                oracle=self._oracle)

        st = self.st
        poses_np = st.poses.cpu().numpy()
        tstamps = st.tstamps.cpu().numpy()
        delta_src = st.delta_src.cpu().numpy()
        delta_pose = st.delta_pose.cpu().numpy()
        traj = {int(tstamps[i]): poses_np[i] for i in range(st.n)}

        def get_pose(t):
            chain = []
            while t not in traj:
                chain.append(t)
                t = int(delta_src[t])
            pose = traj[t]
            for t1 in reversed(chain):
                pose = nse3.mul(delta_pose[t1], pose)
            return pose

        poses = nse3.inv(np.stack([get_pose(t) for t in range(st.counter)]))
        return poses, np.array(self.tlist, dtype=np.float64)

    @property
    def n(self):
        return self.st.n if self.st is not None else 0

    def point_cloud(self):
        """(n*M, 3) world points of the live keyframes' patch centers."""
        st = self.st
        n = st.n
        m = n * self.M
        centers = st.centers[:n].cpu().numpy().reshape(-1, 2)
        depth = st.depth[:m].cpu().numpy()
        poses = st.poses.cpu().numpy()
        intr = st.intr.cpu().numpy()
        xn = (centers[:, 0] - intr[2]) / intr[0]
        yn = (centers[:, 1] - intr[3]) / intr[1]
        pts_c = np.stack([xn, yn, np.ones(m)], -1) / np.maximum(
            depth[:, None], 1e-6)
        c2w = nse3.inv(poses[np.arange(m) // self.M])
        return nse3.quat_rotate(c2w[:, 3:7], pts_c) + c2w[:, :3]

    def colors(self):
        """(n, M, 3) uint8 colors of the live keyframes' patch centers,
        channels reversed as dpvo_tpu's colors() does (the reference's
        readers deliver BGR frames, so this gives RGB)."""
        clr = self.st.colors[:self.st.n].cpu().numpy()
        return np.clip(clr[..., [2, 1, 0]], 0, 255).astype(np.uint8)
