"""The hybrid runtime in bf16 (MIXED_PRECISION) and through the motion
probe: dpvo_tpu's HybridVO against dpvo_torch's on the CPU. Setup and
frames as in test_torch_hybrid.py (a file of its own, so that these JAX
compiles run on another test worker).

Tolerances: bf16 (convolutions, GEMMs and feature maps in bf16, each side
rounding at its own places): poses within 1e-2 (measured 1.1e-3). Probe
path, f32: within 1e-3."""
import numpy as np

from test_torch_hybrid import check_slice, run_jax, run_torch
from test_torch_runtime import POSE_TOL, POSE_TOL_BF16, _frames


def test_whole_slice_matches_jax_mixed_precision():
    tv, _ = check_slice(_frames(16), POSE_TOL_BF16, MIXED_PRECISION=True)
    assert tv.n <= 16 - 4


def test_probe_path_matches_jax():
    """Without the forced probe, the learned motion probe (segment-form
    update operator, median |delta| by nanquantile) decides on every
    pre-init frame; on this sequence both sides reject all but the first
    and fill the rejected frames' poses from identity deltas."""
    frames = _frames(10, seed=1, step=(12, 8))
    jv, jp, _ = run_jax(frames, force_probe=False)
    tv, tp, _ = run_torch(frames, force_probe=False)
    assert (tv.n, tv.counter) == (jv.n, jv.counter) == (1, 10)
    assert sorted(tv.delta) == sorted(jv.delta)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=POSE_TOL)
