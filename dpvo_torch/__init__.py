"""dpvo_torch — Deep Patch Visual Odometry on PyTorch and CUDA (Hopper).

The port of dpvo_tpu's pure-VO runtime (DeviceVO) and of its hybrid runtime
(HybridVO) with DPV-SLAM's learned and classic loop closures. dpvo_tpu (JAX) stays the
reference the tests hold this package against; this package imports torch
and never jax.

Layer map (module names mirror dpvo_tpu/):
  config.py             CfgNode + defaults
  lie.py                SE3 / RxSO3 / Sim3 / quaternion ops on tensors
  ops/                  patchify, segment scatter, correlation: plain
                        PyTorch in corr.py and beside each kernel; the
                        hand-written sm_90a kernels behind corr_onepass.py
                        (K1) and corr_fused.py (K2 planes, K3 select),
                        sources in csrc/, built by cuda_lib.py
  models/               encoders + VONet (nn.Modules), checkpoint loading
  ba_pairs.py, ba.py    Gauss-Newton bundle adjustment: pair-blocked
                        (DeviceVO) and edge-wise (HybridVO)
  ba_global.py          global BA over every edge, pair-block-compressed E
                        (loop closure)
  loop_closure/         proximity loop-edge proposal (numpy); the classic
                        backend: retrieval, image cache, triangulation,
                        RANSAC-Umeyama, the Sim3 pose graph (CPU worker)
  native/               the retrieval library's C++ source (g++ at first
                        use)
  runtime/              DeviceVO, HybridVO and the DPVO constructor; I420
                        packing for the yuv420 upload (i420.py)
  accuracy.py           the accuracy gates' runs (learned and oracle ATE)
  evaluation.py         Sim3-aligned ATE (numpy)
  data_readers/         synthetic scenes with exact ground truth (numpy)
"""

__version__ = '0.1.0'

from .config import cfg  # noqa: F401
