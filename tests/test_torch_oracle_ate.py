"""The accuracy gates on the port (dpvo_torch.accuracy), on the CPU, at the
JAX package's bars, and the copied numpy modules they use.

Oracle ATE (tests/test_oracle_ate.py's two cases; ground-truth
reprojection targets replace the learned update on a plane scene):
  * HybridVO constructed directly, no keyframe removal: ATE < 0.02 x the
    path; the same run on dpvo_tpu's HybridVO with its JAX oracle gives the
    same trajectory within 1e-3 per component;
  * DeviceVO through a dwell, KEYFRAME_THRESH 0.8: at least 3 removals,
    every input frame's pose filled in, ATE < 0.01 x the path. This case is
    held to the bar only, not to dpvo_tpu's trajectory: dpvo_tpu's removal
    rolls its depth buffer by one patch instead of one frame (ROADMAP.md
    queue 1, section 3), so after a removal the two states differ by
    design. dpvo_tpu's run is held to the same bar.

Learned ATE (tests/test_learned_ate.py, test_yuv_ingest.py's accuracy
case; scripts/train_synthetic.py:run_vo_ate's settings) with
artifacts/micro_vonet.npz on make_sequence(1234, T=25, 64x96):
ATE < 0.15 x the path and < 0.5 x seeded random weights' ATE; yuv420 ATE
< 0.15 x the path and < rgb ATE + 0.05 x the path. KEYFRAME_THRESH is -1,
so no removal fires, and the port's rgb ATE is held to dpvo_tpu's on the
same run: within 10% of it or 1e-3 x the path, whichever is larger.

Each dpvo_tpu run is made once per module (module-scoped fixtures).
"""
import os
import sys

import numpy as np
import pytest
import torch

from dpvo_torch import accuracy as acc
from dpvo_torch.data_readers.synthetic import make_sequence
from dpvo_torch.evaluation import ate_rmse, poses_to_trajectory
from test_oracle_ate import (N_FRAMES, _ConstDepthRng, make_gt_poses,
                             make_gt_poses_dwell, make_oracle)
from test_torch_runtime import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, 'artifacts', 'micro_vonet.npz')


def _jax_oracle_run(runtime, gt, kf_thresh):
    """test_oracle_ate.py's run on dpvo_tpu: (poses, keyframes, ATE)."""
    import jax.numpy as jnp
    from dpvo_tpu import lie
    from dpvo_tpu.config import cfg as base_cfg
    from dpvo_tpu.evaluation import ate_rmse as jax_ate
    from dpvo_tpu.evaluation import poses_to_trajectory as jax_traj
    from dpvo_tpu.utils.fetch import fetch

    cfg, ours = base_cfg.clone(), acc.oracle_cfg(kf_thresh)
    for k in ('BUFFER_SIZE', 'PATCHES_PER_FRAME', 'PATCH_LIFETIME',
              'REMOVAL_WINDOW', 'OPTIMIZATION_WINDOW', 'KEYFRAME_THRESH',
              'MIXED_PRECISION'):
        cfg[k] = ours[k]
    H, W = acc.ORACLE_HW
    slam = runtime(cfg, None, ht=H, wd=W, seed=3)
    slam._oracle = make_oracle(gt)
    if hasattr(slam, '_static'):
        slam._static['force_accept'] = True
    else:
        slam.motion_probe = lambda: 100.0
        slam.rng = _ConstDepthRng(slam.rng)
    rng = np.random.RandomState(1)
    for t in range(N_FRAMES):
        img = rng.randint(0, 255, (H, W, 3), np.uint8)
        if hasattr(slam, '_static'):
            slam.rng = _ConstDepthRng(np.random.RandomState(1000 + t))
        slam(t, img, acc.ORACLE_INTR)
    if hasattr(slam, '_drain'):
        slam._drain()
    n = int(fetch(slam.st.n)) if hasattr(slam, 'st') else slam.n
    poses, tstamps = slam.terminate()
    gt_wfc = np.asarray(lie.se3_inv(jnp.asarray(gt)))
    err = jax_ate(jax_traj(poses, tstamps), jax_traj(gt_wfc,
                                                     np.arange(N_FRAMES)))
    return poses, n, err


@pytest.fixture(scope='module')
def hybrid_runs():
    from dpvo_tpu.runtime import HybridVO as JaxHybridVO
    return (acc.oracle_hybrid('cpu'),
            _jax_oracle_run(JaxHybridVO, make_gt_poses(N_FRAMES), -1.0))


@pytest.fixture(scope='module')
def removal_runs():
    from dpvo_tpu.runtime.device_driver import DeviceVO as JaxDeviceVO
    return (acc.oracle_removal('cpu'),
            _jax_oracle_run(JaxDeviceVO, make_gt_poses_dwell(N_FRAMES), 0.8))


def test_oracle_hybrid_recovers_trajectory(hybrid_runs):
    r, _ = hybrid_runs
    assert r['poses'].shape == (N_FRAMES, 7) and r['keyframes'] == N_FRAMES
    assert np.isfinite(r['ate'])
    assert r['ate'] < 0.02 * r['path'], (r['ate'], r['path'])


def test_oracle_hybrid_matches_jax(hybrid_runs):
    r, (jp, jn, jerr) = hybrid_runs
    assert jn == r['keyframes']
    np.testing.assert_allclose(r['poses'], jp, rtol=0, atol=1e-3)


def test_oracle_removal_recovers_trajectory(removal_runs):
    r, _ = removal_runs
    removed = N_FRAMES - r['keyframes']
    assert removed >= 3, f'keyframe removal never fired (removed={removed})'
    assert r['poses'].shape == (N_FRAMES, 7)
    assert np.isfinite(r['ate'])
    assert r['ate'] < 0.01 * r['path'], (r['ate'], r['path'])


def test_oracle_removal_jax_held_to_the_same_bar(removal_runs):
    """dpvo_tpu on the same scene: held to the bar, not compared pose by
    pose with the port (its depth shift after a removal differs)."""
    r, (jp, jn, jerr) = removal_runs
    assert N_FRAMES - jn >= 3 and jerr < 0.01 * r['path'], (jn, jerr)


def test_plane_scene_matches_jax():
    """The port's ground truth and oracle against test_oracle_ate.py's, on
    the same edges."""
    import jax.numpy as jnp
    from dpvo_torch.models.vonet import P
    for ours, theirs in ((acc.plane_gt_poses(N_FRAMES),
                          make_gt_poses(N_FRAMES)),
                         (acc.plane_gt_poses(N_FRAMES, dwell=(12, 19)),
                          make_gt_poses_dwell(N_FRAMES))):
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=2e-6)
    gt = make_gt_poses_dwell(N_FRAMES)
    rng = np.random.RandomState(0)
    E, NM = 200, 64
    patch_xy = rng.uniform(0, 24, (NM, 2, P, P)).astype(np.float32)
    intr = np.tile(acc.ORACLE_INTR / 4, (N_FRAMES, 1))
    ii = rng.randint(0, N_FRAMES, E)
    jj = np.clip(ii + rng.randint(-3, 4, E), 0, N_FRAMES - 1)
    kk = rng.randint(0, NM, E)
    args = (np.zeros((N_FRAMES, 7), np.float32), patch_xy,
            np.ones(NM, np.float32), intr, ii, jj, kk)
    got = acc.plane_oracle(gt)(*(torch.from_numpy(a) for a in args))
    ref = make_oracle(gt)(*(jnp.asarray(a) for a in args))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-4)


def test_const_depth_rng():
    r = acc.ConstDepthRng(np.random.RandomState(0))
    assert (r.rand(5) == 0.5).all()
    assert (r.randint(0, 9, 4) ==
            np.random.RandomState(0).randint(0, 9, 4)).all()


# ---------------------------------------------------------------------------
# the learned gate
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def seq():
    return make_sequence(1234, T=25, H=64, W=96, step=0.12)


@pytest.fixture(scope='module')
def learned(seq):
    runs = {(net, up): acc.learned_ate(net, seq, device='cpu', upload=up)
            for net, up in ((NPZ, 'rgb'), (NPZ, 'yuv420'), (None, 'rgb'))}
    sys.path.insert(0, os.path.join(REPO, 'scripts'))
    from train_synthetic import run_vo_ate
    from dpvo_tpu.data_readers.synthetic import make_sequence as jax_seq
    runs['jax'] = run_vo_ate(NPZ, jax_seq(1234, T=25, H=64, W=96, step=0.12))
    return runs


def test_learned_ate_beats_random(learned):
    err_t, path = learned[(NPZ, 'rgb')]
    err_r, _ = learned[(None, 'rgb')]
    assert np.isfinite(err_t)
    assert err_t < 0.5 * err_r, (err_t, err_r)
    assert err_t < 0.15 * path, (err_t, path)


def test_learned_ate_yuv420_within_rgb(learned):
    err_y, path = learned[(NPZ, 'yuv420')]
    err_t, _ = learned[(NPZ, 'rgb')]
    assert err_y < 0.15 * path, (err_y, path)
    assert err_y < err_t + 0.05 * path, (err_y, err_t, path)


def test_learned_ate_matches_jax(learned):
    err_t, path = learned[(NPZ, 'rgb')]
    err_j, path_j = learned['jax']
    assert path == pytest.approx(path_j, rel=1e-6)
    assert abs(err_t - err_j) <= max(0.1 * err_j, 1e-3 * path), (err_t,
                                                                  err_j)


# ---------------------------------------------------------------------------
# the copied numpy modules
# ---------------------------------------------------------------------------

def test_make_sequence_copy_is_bit_equal():
    from dpvo_tpu.data_readers.synthetic import make_sequence as jax_seq
    for seed, T in ((1234, 6), (7, 4)):
        a = make_sequence(seed, T=T, H=64, W=96, step=0.12)
        b = jax_seq(seed, T=T, H=64, W=96, step=0.12)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize('scale', [True, False])
def test_evaluation_copy_matches(scale):
    from dpvo_tpu.evaluation import ate_rmse as jax_ate
    from dpvo_tpu.evaluation import poses_to_trajectory as jax_traj
    rng = np.random.RandomState(int(scale))
    gt = rng.randn(40, 7)
    est = gt + 0.05 * rng.randn(40, 7)
    est[:, :3] = 1.7 * est[:, :3] + 0.3
    t_gt = np.arange(40) * 0.05
    t_est = t_gt[rng.permutation(40)[:33]] + rng.uniform(-0.01, 0.01, 33)
    ours = ate_rmse(poses_to_trajectory(est[:33], t_est),
                    poses_to_trajectory(gt, t_gt), correct_scale=scale)
    theirs = jax_ate(jax_traj(est[:33], t_est), jax_traj(gt, t_gt),
                     correct_scale=scale)
    assert np.isfinite(ours) and abs(ours - theirs) <= 1e-9
