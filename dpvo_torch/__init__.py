"""dpvo_torch — Deep Patch Visual Odometry on PyTorch and CUDA (Hopper).

The port of dpvo_tpu's pure-VO runtime (DeviceVO), of its hybrid runtime
(HybridVO) with DPV-SLAM's learned and classic loop closures and the
viewer, of multi-stream tracking, training, and of the demo and evaluation
CLIs. dpvo_tpu (JAX) stays the reference the tests hold this package
against; this package imports torch and never jax.

Layer map (module names mirror dpvo_tpu/):
  config.py             CfgNode + defaults
  lie.py            L0  Lie groups SO3 / RxSO3 / SE3 / Sim3 on tensors:
                        the functional ops and the lietorch-style classes
                        (SO3, RxSO3, SE3, Sim3, stack)
  projective.py     L1  iproj / proj / transform with analytic SE3 and
                        Sim3 Jacobians, point_cloud, flow_mag
  ops/              L2  patchify, segment scatter, correlation: plain
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
  transfer.py           host <-> device copies that do not wait for the
                        device: page-locked uploads, read-backs in flight
                        (HybridVO's MIRROR_PIPELINE)
  parallel/streams.py   MultiStreamVO: B DeviceVOs stepped in lockstep,
                        one torch device per stream
  viz/                  the viewer thread (viewer.py: jpg frames, ply, 3D
                        renders) and the self-contained WebGL page
                        (html_viewer.py)
  train/                the unrolled VONet, the differentiable BA, the
                        loss and the optimizer step
  accuracy.py           the accuracy gates' runs (learned and oracle ATE)
  evaluation.py         Sim3-aligned ATE, TUM / EuRoC trajectory files
  plot_utils.py         trajectory plot, ply and COLMAP writers
  stream.py             image-directory and video readers (a reader
                        process feeds the runtime through a queue)
  utils/                Timer (timing.py, synchronizes a CUDA device);
                        coordinate grids and set_depth (grids.py)
  data_readers/         synthetic scenes with exact ground truth (numpy)
  demo.py, evaluate_euroc.py, evaluate_tum.py, evaluate_kitti.py,
  evaluate_icl_nuim.py, evaluate_synthetic.py
                        the CLIs (python -m dpvo_torch.demo ...); each
                        runs on cuda unless given --device cpu
"""

__version__ = '0.1.0'

from .config import cfg  # noqa: F401
