"""VO runtimes (PyTorch port).

Only the device-resident pure-VO runtime (DeviceVO) is ported. Configs that
dpvo_tpu sends to its hybrid host-driven runtime -- loop closure, classic
loop closure, GRADIENT_BIAS centroids, visualization -- are not ported yet
(ROADMAP.md queue 1, "Hybrid runtime" and "Loop closure").
"""
from .device_driver import DeviceVO


def DPVO(cfg, network, ht=480, wd=640, viz=False, seed=1234, device='cuda'):
    """Constructor with the reference's signature (dpvo/dpvo.py:22)."""
    pure_vo = (not cfg.LOOP_CLOSURE and not cfg.CLASSIC_LOOP_CLOSURE
               and cfg.CENTROID_SEL_STRAT == 'RANDOM' and not viz)
    if not pure_vo:
        raise NotImplementedError(
            'this config needs the hybrid runtime (loop closure, '
            'GRADIENT_BIAS centroids or viz), which is not ported yet: '
            'ROADMAP.md queue 1, item "Hybrid runtime"')
    return DeviceVO(cfg, network, ht, wd, seed=seed, device=device)


__all__ = ['DPVO', 'DeviceVO']
