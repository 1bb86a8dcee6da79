"""Host driver of the device-resident VO runtime (DeviceVO).

Port of dpvo_tpu/runtime/device_driver.py. Per frame: patch centroids and
depth seeds are drawn on the host from np.random.RandomState(seed) -- the
same draws, in the same order, as dpvo_tpu -- then the image and an (M, 4)
aux row go to the device and vo_frame runs there. terminate() runs 12
refinement iterations and reads the trajectory back once.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..models.vonet import RES, load_vonet
from . import numpy_se3 as nse3
from .centroid import select_coords
from .device_vo import CNT_CAP, init_state, vo_frame, vo_refine


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


class DeviceVO:
    """Same public surface as the reference DPVO: construct, __call__,
    terminate."""

    def __init__(self, cfg, network, ht=480, wd=640, seed=1234,
                 device='cuda'):
        if str(getattr(cfg, 'UPLOAD_FORMAT', 'rgb')).lower() != 'rgb':
            raise NotImplementedError(
                'UPLOAD_FORMAT=yuv420 (I420 ingest) is not ported yet; '
                'see ROADMAP.md queue 1')
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
        # random weights never pass the learned motion probe; benchmarks and
        # smoke runs set this to reach the steady-state workload
        self.force_accept = False
        self.st = None
        self.tlist = []

    def __call__(self, tstamp, image, intrinsics):
        """Track one (ht, wd, 3) uint8 RGB frame."""
        if self.st is None:
            self.st = init_state(self.cfg, self.ht, self.wd, intrinsics,
                                 self.device, self.network.dtype)
        if len(self.tlist) + 1 >= CNT_CAP:
            raise RuntimeError('input frame capacity exceeded; raise '
                               'device_vo.CNT_CAP')
        # BUFFER_SIZE bounds keyframes (reference dpvo.py:383-384); the
        # keyframe count is known on the host, so the check is exact
        if self.st.n + 2 >= self.cfg.BUFFER_SIZE:
            raise RuntimeError(
                f'The buffer size is too small. You can increase it using '
                f'"--opts BUFFER_SIZE={self.cfg.BUFFER_SIZE * 2}"')
        image = np.ascontiguousarray(image, np.uint8)
        if image.shape != (self.ht, self.wd, 3):
            raise ValueError(f'expected a ({self.ht}, {self.wd}, 3) frame, '
                             f'got {image.shape}')

        self.tlist.append(tstamp)
        aux = np.empty((self.M, 4), np.float32)
        aux[:, :2] = select_coords(self.cfg, self.rng, image, self.M,
                                   self.ht // RES, self.wd // RES)
        aux[:, 2] = self.rng.rand(self.M)
        aux[:, 3] = tstamp
        self.st = vo_frame(
            self.network, self.st,
            torch.from_numpy(image).to(self.device, non_blocking=True),
            torch.from_numpy(aux).to(self.device, non_blocking=True),
            force_accept=self.force_accept, **self._static)

    def terminate(self):
        """Refine 12 times, then return (poses (T, 7) world-from-camera,
        tstamps (T,)) for every input frame."""
        s = self._static
        for _ in range(12):
            self.st = vo_refine(self.network, self.st, M=s['M'], W=s['W'],
                                PCF=s['PCF'], corr_impl=s['corr_impl'])

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
