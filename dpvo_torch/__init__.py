"""dpvo_torch — Deep Patch Visual Odometry on PyTorch and CUDA (Hopper).

The port of dpvo_tpu's pure-VO main path. dpvo_tpu (JAX) stays the
reference the tests hold this package against; this package imports torch
and never jax.

Layer map (module names mirror dpvo_tpu/):
  config.py             CfgNode + defaults
  lie.py                SE3 / quaternion ops on tensors
  ops/                  patchify, segment scatter, correlation (plain
                        PyTorch in corr.py; the hand-written sm_90a kernel
                        behind corr_onepass.py, source in csrc/)
  models/               encoders + VONet (nn.Modules), checkpoint loading
  ba_pairs.py           pair-blocked Gauss-Newton bundle adjustment
  runtime/              DeviceVO state machine + DPVO constructor
"""

__version__ = '0.1.0'

from .config import cfg  # noqa: F401
