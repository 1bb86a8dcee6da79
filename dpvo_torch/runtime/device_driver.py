"""Host driver of the device-resident VO runtime (DeviceVO).

Port of dpvo_tpu/runtime/device_driver.py. Per frame: patch centroids and
depth seeds are drawn on the host from np.random.RandomState(seed) -- the
same draws, in the same order, as dpvo_tpu -- then one flat uint8 row,
[image bytes | (M, 4) f32 aux bytes], goes to the device in one copy and
vo_frame runs there. The image bytes are the RGB frame or, with
UPLOAD_FORMAT=yuv420, its I420 planes (half the bytes; packed on the host by
i420.rgb_to_i420, turned back into RGB on the device). track_frames uploads
a chunk of such rows in one copy. Uploads go through page-locked memory
without waiting for the device (transfer.upload).

The host reads nothing back per frame from the bootstrap frame on: the
state machine's decisions stay on the device (device_vo.py), and the
keyframe buffer's guard reads `n` only when the worst case -- every frame
since its last read a keyframe -- could overflow BUFFER_SIZE. Before
initialization the learned motion probe's accept decision is read once per
frame (none with force_accept). The read points are those of dpvo_tpu: the
`n` property, point_cloud(), colors(), the viewer's snapshots and
terminate(), which runs 12 refinement iterations and reads the trajectory
back once. With viz, each frame goes to the viewer (viz/viewer.py) and
every 10th frame, and terminate(), push it a snapshot of the keyframes'
poses and points, read back in one copy.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import tracing
from ..models.vonet import RES, VONet, load_vonet
from ..transfer import upload
from . import numpy_se3 as nse3
from .centroid import select_coords
from .device_vo import CNT_CAP, init_state, vo_frame_packed1, vo_refine
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


def _points(poses, centers, depth, intr, M):
    """(m, 3) world points of m = len(depth) patch centers (m, 2) at
    inverse depths `depth`, patch i in keyframe i // M of cam-from-world
    `poses`; intr (4,) at the centers' scale."""
    m = len(depth)
    xn = (centers[:, 0] - intr[2]) / intr[0]
    yn = (centers[:, 1] - intr[3]) / intr[1]
    pts_c = np.stack([xn, yn, np.ones(m)], -1) / np.maximum(
        depth[:, None], 1e-6)
    c2w = nse3.inv(poses[np.arange(m) // M])
    return nse3.quat_rotate(c2w[:, 3:7], pts_c) + c2w[:, :3]


class DeviceVO:
    """Same public surface as the reference DPVO: construct, __call__,
    terminate; and dpvo_tpu's track_frames, point_cloud and colors."""

    def __init__(self, cfg, network, ht=480, wd=640, viz=False, seed=1234,
                 device='cuda'):
        self.cfg = cfg
        self.ht, self.wd = ht, wd
        self.M = cfg.PATCHES_PER_FRAME
        self.device = torch.device(device)
        self.rng = np.random.RandomState(seed)
        if isinstance(network, VONet):
            # preloaded (MultiStreamVO shares one network per device)
            want = torch.bfloat16 if cfg.MIXED_PRECISION else torch.float32
            dev = next(network.parameters()).device
            here = torch.empty(0, device=self.device).device   # cuda:i
            if network.dtype != want or dev != here:
                raise ValueError(f'network on {dev} in {network.dtype}; this '
                                 f'runtime needs {here}, {want}')
            self.network = network
        else:
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
        # the keyframe guard's last read of n, and frames enqueued since
        self._last_n = 0
        self._since_check = 0
        self.viewer = None
        if viz:
            from ..viz.viewer import Viewer
            self.viewer = Viewer()

    def _start(self, K, intrinsics):
        """Build the state on the first call; refuse K more frames when they
        could overflow the input or keyframe capacity."""
        if self.st is None:
            self.st = init_state(self.cfg, self.ht, self.wd, intrinsics,
                                 self.device, self.network.dtype)
        if len(self.tlist) + K >= CNT_CAP:
            raise RuntimeError('input frame capacity exceeded; raise '
                               'device_vo.CNT_CAP')
        # BUFFER_SIZE bounds keyframes (reference dpvo.py:383-384), and the
        # keyframe count lives on the device: read it only when the worst
        # case (every frame since the last read accepted and kept) could
        # refuse these K frames (dpvo_tpu's lazy guard,
        # device_driver.py:110-123); before the bootstrap frame the host
        # knows it. The frame refused is the one an exact check refuses.
        N = self.cfg.BUFFER_SIZE
        if self._last_n + self._since_check + K + 1 >= N:
            host_n = self.st.host_n
            self._last_n = host_n if host_n is not None else self.n
            self._since_check = 0
            if self._last_n + K + 1 >= N:
                raise RuntimeError(
                    f'The buffer size is too small. You can increase it '
                    f'using "--opts BUFFER_SIZE={N * 2}"')
        self._since_check += K

    def _frame(self, image):
        image = np.ascontiguousarray(image, np.uint8)
        if image.shape != (self.ht, self.wd, 3):
            raise ValueError(f'expected a ({self.ht}, {self.wd}, 3) frame, '
                             f'got {image.shape}')
        return image

    def _draw(self, image):
        """The frame's host randoms, in dpvo_tpu's order: (M, 2) patch
        centroids on the 1/4 grid (select_coords), then (M,) depth
        seeds."""
        with tracing.span('vo.draw'):
            coords = select_coords(self.cfg, self.rng, image, self.M,
                                   self.ht // RES, self.wd // RES)
            return coords, self.rng.rand(self.M)

    def _pack_buf(self, image, tstamp, coords, seeds):
        """One flat uint8 row for vo_frame_packed1: [image bytes (rgb or
        I420) | (M, 4) f32 aux bytes: coords, seed, tstamp]."""
        with tracing.span('vo.pack'):
            aux = np.empty((self.M, 4), np.float32)
            aux[:, :2] = coords
            aux[:, 2] = seeds
            aux[:, 3] = tstamp
            pix = rgb_to_i420(image) if self._upload == 'yuv420' else image
            return np.concatenate([pix.reshape(-1),
                                   aux.view(np.uint8).ravel()])

    def _upload_rows(self, bufs):
        """One host-to-device copy through page-locked memory, which the
        host does not wait for (transfer.upload)."""
        self.h2d_bytes += bufs.nbytes
        with tracing.span('vo.upload', bytes=bufs.nbytes):
            return upload(bufs, self.device)

    def _kw(self):
        return dict(ht=self.ht, wd=self.wd, upload=self._upload,
                    force_accept=self.force_accept, oracle=self._oracle,
                    **self._static)

    def __call__(self, tstamp, image, intrinsics):
        """Track one (ht, wd, 3) uint8 RGB frame."""
        tracing.frame(len(self.tlist))
        with tracing.span('vo.frame'):
            self._start(1, intrinsics)
            image = self._frame(image)
            self._step(tstamp, image, *self._draw(image))

    def step(self, tstamp, image, intrinsics, coords, seeds):
        """Track one frame with its host randoms given: (M, 2) patch
        centroids on the 1/4 grid and (M,) depth seeds (MultiStreamVO
        draws them for all its streams in dpvo_tpu's order)."""
        tracing.frame(len(self.tlist))
        with tracing.span('vo.frame'):
            self._start(1, intrinsics)
            self._step(tstamp, self._frame(image), coords, seeds)

    def _step(self, tstamp, image, coords, seeds):
        buf = self._pack_buf(image, tstamp, coords, seeds)
        self.tlist.append(tstamp)
        rows = self._upload_rows(buf)
        with tracing.span('vo.step'):
            self.st = vo_frame_packed1(self.network, self.st, rows,
                                       **self._kw())
        if self.viewer is not None:
            self.viewer.update_image(image)
            if len(self.tlist) % 10 == 0:
                self._push_viewer_state()

    def _push_viewer_state(self):
        """Send the viewer the keyframes' world-from-camera poses, points
        and colors (dpvo_tpu's raw f32 colors, BGR), read back in one
        copy."""
        st, n, M = self.st, self.n, self.M
        if n < 2:
            return
        flat = torch.cat([st.poses[:n].reshape(-1), st.centers[:n].reshape(-1),
                          st.depth[:n * M], st.colors[:n].reshape(-1),
                          st.intr]).cpu().numpy()
        poses, centers, depth, clr, intr = np.split(
            flat, np.cumsum([7 * n, 2 * n * M, n * M, 3 * n * M]))
        poses = poses.reshape(n, 7)
        self.viewer.update_state(
            nse3.inv(poses), _points(poses, centers.reshape(-1, 2), depth,
                                     intr, M), clr.reshape(-1, 3))

    def track_frames(self, tstamps, images, intrinsics):
        """Track a chunk of K frames from one upload (dpvo_tpu's
        track_frames): images (K, ht, wd, 3) uint8. The math is per-frame
        __call__'s, frame by frame (vo_frame_packed1 on each row): from the
        bootstrap frame on, the K frames are enqueued with no read back,
        as per-frame calls are; the chunk saves K - 1 uploads.

        Spans: each frame's vo.draw and vo.pack, then the chunk's one
        vo.upload, come before any frame's step and so lie outside the
        frames' vo.frame spans, each tagged with its frame (the upload
        with the chunk's first); each frame's vo.frame holds its vo.step."""
        K = len(images)
        self._start(K, intrinsics)
        first = len(self.tlist)
        frames = [self._frame(img) for img in images]
        bufs = []
        for k, (img, ts) in enumerate(zip(frames, tstamps)):
            tracing.frame(first + k)
            bufs.append(self._pack_buf(img, ts, *self._draw(img)))
        self.tlist.extend(tstamps)
        tracing.frame(first)
        rows = self._upload_rows(np.stack(bufs))
        kw = self._kw()
        for k in range(K):
            tracing.frame(first + k)
            with tracing.span('vo.frame'), tracing.span('vo.step'):
                self.st = vo_frame_packed1(self.network, self.st, rows[k],
                                           **kw)

    def terminate(self):
        """Refine 12 times, then return (poses (T, 7) world-from-camera,
        tstamps (T,)) for every input frame."""
        s = self._static
        for _ in range(12):
            self.st = vo_refine(self.network, self.st, M=s['M'], W=s['W'],
                                PCF=s['PCF'], corr_impl=s['corr_impl'],
                                oracle=self._oracle)

        st = self.st
        n, counter = self.n, int(st.counter)
        poses_np = st.poses.cpu().numpy()
        tstamps = st.tstamps.cpu().numpy()
        delta_src = st.delta_src.cpu().numpy()
        delta_pose = st.delta_pose.cpu().numpy()
        traj = {int(tstamps[i]): poses_np[i] for i in range(n)}

        def get_pose(t):
            chain = []
            while t not in traj:
                chain.append(t)
                t = int(delta_src[t])
            pose = traj[t]
            for t1 in reversed(chain):
                pose = nse3.mul(delta_pose[t1], pose)
            return pose

        poses = nse3.inv(np.stack([get_pose(t) for t in range(counter)]))
        if self.viewer is not None:
            self._push_viewer_state()
            self.viewer.join()
        return poses, np.array(self.tlist, dtype=np.float64)

    @property
    def n(self):
        """The keyframe count, read back from the device (a host int)."""
        return int(self.st.n) if self.st is not None else 0

    def point_cloud(self):
        """(n*M, 3) world points of the live keyframes' patch centers."""
        st, n = self.st, self.n
        return _points(st.poses.cpu().numpy(),
                       st.centers[:n].cpu().numpy().reshape(-1, 2),
                       st.depth[:n * self.M].cpu().numpy(),
                       st.intr.cpu().numpy(), self.M)

    def colors(self):
        """(n, M, 3) uint8 colors of the live keyframes' patch centers,
        channels reversed as dpvo_tpu's colors() does (the reference's
        readers deliver BGR frames, so this gives RGB)."""
        clr = self.st.colors[:self.n].cpu().numpy()
        return np.clip(clr[..., [2, 1, 0]], 0, 255).astype(np.uint8)
