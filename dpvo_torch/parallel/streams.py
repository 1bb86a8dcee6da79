"""Multi-stream VO: B independent streams stepped in lockstep.

Port of dpvo_tpu/parallel/streams.py. There, a batch of VO states is
sharded over a device mesh with shard_map, one stream per chip, each chip
running the full per-frame step with no cross-chip traffic. Here each
stream is a DeviceVO (runtime/device_driver.py) on its own torch device,
stepped in stream order. A device may appear more than once: a card then
holds several streams and steps them in turn, with one network between
them.

The host draws follow dpvo_tpu's order, so both packages can be fed the
same draws: per call, for each stream a uniform randint of the patch
coordinates on the 1/4 grid (x then y), then one rand(B, M) of the depth
seeds; each stream's DeviceVO.step takes its share. dpvo_tpu's shard_map
body forces its portable correlation (corr_impl='fused'); each stream here
takes DeviceVO's default, K1 (DPVO_CORR_IMPL overrides it). On the CPU
both packages compute the same correlation through their plain paths.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.vonet import RES, load_vonet
from ..runtime.device_driver import DeviceVO


class MultiStreamVO:
    """Lockstep tracking of B streams, one torch device per stream.

    devices: one torch device (or name) per stream; by default every
    visible CUDA device. The network is loaded once per distinct device.
    streams[b] is stream b's DeviceVO, states[b] its VOState
    (runtime/device_vo.py). force_accept: skip the learned motion probe
    before initialization in every stream (DeviceVO.force_accept; random
    or untrained weights never pass it)."""

    def __init__(self, cfg, network, ht, wd, intrinsics, devices=None,
                 seed=1234):
        if devices is None:
            count = torch.cuda.device_count()
            if count == 0:
                raise RuntimeError('MultiStreamVO: no CUDA device; pass '
                                   'devices=[...] to run elsewhere')
            devices = [f'cuda:{i}' for i in range(count)]
        self.ht, self.wd = ht, wd
        self.M = cfg.PATCHES_PER_FRAME
        self.devices = [torch.device(d) for d in devices]
        self.B = len(self.devices)
        self.intrinsics = intrinsics
        self.rng = np.random.RandomState(seed)
        nets = {}
        for d in self.devices:
            if d not in nets:
                nets[d] = load_vonet(network, d, bool(cfg.MIXED_PRECISION))
        self.streams = [DeviceVO(cfg, nets[d], ht, wd, device=d)
                        for d in self.devices]
        for s in self.streams:
            s._start(0, intrinsics)          # each state built now

    @property
    def states(self):
        return [s.st for s in self.streams]

    @property
    def networks(self):
        return [s.network for s in self.streams]

    @property
    def force_accept(self):
        return all(s.force_accept for s in self.streams)

    @force_accept.setter
    def force_accept(self, value):
        for s in self.streams:
            s.force_accept = value

    def __call__(self, tstamps, images):
        """tstamps: (B,) floats; images: (B, H, W, 3) uint8."""
        images = np.asarray(images)
        if images.shape != (self.B, self.ht, self.wd, 3):
            raise ValueError(f'expected ({self.B}, {self.ht}, {self.wd}, 3) '
                             f'frames, got {images.shape}')
        h4, w4 = self.ht // RES, self.wd // RES
        coords = np.stack([
            np.stack([self.rng.randint(1, w4 - 1, self.M),
                      self.rng.randint(1, h4 - 1, self.M)], -1)
            for _ in range(self.B)]).astype(np.float32)
        seeds = self.rng.rand(self.B, self.M).astype(np.float32)
        for b, s in enumerate(self.streams):
            s.step(tstamps[b], images[b], self.intrinsics, coords[b],
                   seeds[b])

    def terminate(self):
        """Each stream's DeviceVO.terminate(): a list of B (poses (T, 7)
        world-from-camera, tstamps (T,))."""
        return [s.terminate() for s in self.streams]
