"""VO runtimes (PyTorch port).

Two implementations behind one constructor, as in dpvo_tpu:
  * DeviceVO (runtime/device_vo.py) -- the pure-VO state machine on the
    device, its scalars there too: no read back per frame after the
    bootstrap;
  * HybridVO (runtime/dpvo.py) -- host-orchestrated, for every other
    config: GRADIENT_BIAS centroids, DPV-SLAM's learned loop closure
    (LOOP_CLOSURE: proximity edges, the inactive edge store, gauge
    normalization and global BA) and its classic one (CLASSIC_LOOP_CLOSURE:
    BoW retrieval, structure-only triangulation, RANSAC-Umeyama and the
    Sim3 pose-graph worker).
Both take viz=True, which starts the viewer (viz/viewer.py); the DPVO
constructor sends viz configs to HybridVO, as dpvo_tpu's does.
"""
from .device_driver import DeviceVO
from .dpvo import HybridVO


def DPVO(cfg, network, ht=480, wd=640, viz=False, seed=1234, device='cuda'):
    """Constructor with the reference's signature (dpvo/dpvo.py:22)."""
    pure_vo = (not cfg.LOOP_CLOSURE and not cfg.CLASSIC_LOOP_CLOSURE
               and cfg.CENTROID_SEL_STRAT == 'RANDOM' and not viz)
    if pure_vo:
        return DeviceVO(cfg, network, ht, wd, seed=seed, device=device)
    return HybridVO(cfg, network, ht, wd, viz=viz, seed=seed, device=device)


__all__ = ['DPVO', 'DeviceVO', 'HybridVO']
