"""The whole slice in bf16 (MIXED_PRECISION) and through the motion probe:
dpvo_tpu's DeviceVO against dpvo_torch's on the CPU. Setup, frames and
tolerances as in test_torch_runtime.py (bf16: poses within 1e-2; probe
path, f32: within 1e-3)."""
import numpy as np

from test_torch_runtime import POSE_TOL, _check_slice, _frames, _run_jax, \
    _run_torch


def test_whole_slice_matches_jax_mixed_precision():
    _check_slice(mixed=True)


def test_probe_path_matches_jax():
    """Without force_accept the motion probe (segment-form update operator
    + median of |delta|) decides on every pre-init frame; on this sequence
    both sides reject all but the first, and fill the rejected frames' poses
    from the identity deltas."""
    frames = _frames(10, seed=1, step=(12, 8))
    jp, jn, jc, _ = _run_jax(frames, False)
    tp, tn, tc, _ = _run_torch(frames, False)
    assert (tn, tc) == (jn, jc) == (1, 10)
    np.testing.assert_allclose(tp, jp, atol=POSE_TOL, rtol=0)
