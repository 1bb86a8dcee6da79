"""DPV-SLAM's classic loop closure on the port (CLASSIC_LOOP_CLOSURE in
HybridVO) against dpvo_tpu's, on the CPU (torch on one thread):

* the native retrieval library the port builds from dpvo_torch/native/
  into build/dpvo_torch_native/ gives dpvo_tpu's library's query scores
  and indices on test_classic_lc.py's textured frames; a failed build
  raises with the compiler's output;
* the whole slice on test_classic_lc.py's closed-loop scene (an
  out-and-back pan over a textured plane, plane_oracle's targets, 36
  frames at 128x192; dpvo_torch.accuracy.classic_run), with sync_pgo on
  both packages and the same RANSAC draws (dpvo_tpu's module attribute
  long_term.ransac_umeyama replaced by one that draws from the port's
  seeded generator): the same loops, lc_count >= 1, trajectories within
  1e-3 (quaternions made unit), the port's ATE < 0.05 x the path;
* test_classic_lc.py's pipeline run on the port finishes, with every
  worker process closed;
* without OpenCV, construction raises ImportError naming it (no silent
  pure-VO run);
* apply_pgo_result (loop_closure/pgo.py, which imports without OpenCV)
  lands its rows where the host has them while a keyframe removal is
  still owed by the device.

dpvo_tpu's run is made once per module (a module-scoped fixture).
"""
import sys

import numpy as np
import pytest

from dpvo_torch import accuracy as acc
from dpvo_torch.runtime import HybridVO
from test_torch_runtime import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')


def _unit(poses):
    p = np.array(poses, np.float64)
    p[:, 3:] /= np.linalg.norm(p[:, 3:], axis=1, keepdims=True)
    p[:, 3:] *= np.sign(p[:, 6:7])
    return p


def test_retrieval_library_matches_jax():
    from dpvo_tpu.loop_closure.retrieval import retrieval_native as jret
    from dpvo_torch.loop_closure.retrieval import retrieval_native as tret
    path = tret.library_path()
    assert path.parent == tret.BUILD_DIR
    assert path.parent.parts[-2:] == ('build', 'dpvo_torch_native')
    frames = acc.textured_frames(24)
    dbs = (jret.NativeRetrieval(rad=6), tret.NativeRetrieval(rad=6))
    hits = 0
    for t, img in enumerate(frames):
        out = []
        for db in dbs:
            db.insert_image(np.ascontiguousarray(img))
            out.append(db.query(t))
        assert out[1] == out[0], (t, out)
        hits += out[1][1] >= 0
    assert hits >= 5                     # the revisits are found
    np.testing.assert_array_equal(dbs[1].match_pair(20, 3),
                                  dbs[0].match_pair(20, 3))


def test_failed_build_raises(monkeypatch, tmp_path):
    from dpvo_torch.loop_closure.retrieval import retrieval_native as tret
    monkeypatch.setattr(tret, 'BUILD_DIR', tmp_path)
    monkeypatch.setattr(tret, '_opencv_flags',
                        lambda: ['-I/nonexistent', '-lno_such_library'])
    with pytest.raises(RuntimeError, match='native retrieval library'):
        tret.library_path()
    assert not list(tmp_path.glob('*.so'))


def _jax_classic(scene):
    """dpvo_tpu's run of the scene: test_classic_lc.py's runtime with the
    port's config keys, sync_pgo, and RANSAC drawn from a generator seeded
    like the port's (the runtime's seed, 3)."""
    from dpvo_torch.loop_closure.optim import ransac_umeyama
    from dpvo_tpu.config import cfg as base_cfg
    from dpvo_tpu.loop_closure import long_term as jlt
    from dpvo_tpu.runtime import HybridVO as JaxHybrid
    from test_oracle_ate import _ConstDepthRng, make_oracle
    gt, frames, intr = scene
    cfg, ours = base_cfg.clone(), acc.classic_cfg()
    for k in ('BUFFER_SIZE', 'PATCHES_PER_FRAME', 'PATCH_LIFETIME',
              'REMOVAL_WINDOW', 'OPTIMIZATION_WINDOW', 'KEYFRAME_THRESH',
              'MIXED_PRECISION', 'CLASSIC_LOOP_CLOSURE', 'LOOP_RETR_RAD',
              'LOOP_CLOSE_WINDOW_SIZE', 'LOOP_RETR_THRESH'):
        cfg[k] = ours[k]
    rng = np.random.RandomState(3)
    orig = jlt.ransac_umeyama
    jlt.ransac_umeyama = (lambda a, b, iterations, threshold:
                          ransac_umeyama(a, b, rng, iterations, threshold))
    try:
        H, W, _ = frames[0].shape
        slam = JaxHybrid(cfg, None, ht=H, wd=W, seed=3)
        lc = acc.sync_pgo(slam.long_term_lc)
        slam._oracle = make_oracle(gt)
        slam.motion_probe = lambda: 100.0
        slam.rng = _ConstDepthRng(slam.rng)
        for t, img in enumerate(frames):
            slam(t, img, intr)
        poses, _ = slam.terminate()
    finally:
        jlt.ransac_umeyama = orig
    return dict(poses=poses, lc_count=lc.lc_count,
                loops=list(zip(lc.loop_ii.tolist(), lc.loop_jj.tolist())))


@pytest.fixture(scope='module')
def scene():
    return acc.classic_scene()


@pytest.fixture(scope='module')
def jax_run(scene):
    return _jax_classic(scene)


@pytest.fixture(scope='module')
def port_run(scene):
    return acc.classic_run('cpu', scene=scene)


def test_classic_slice_matches_jax(port_run, jax_run):
    assert port_run['lc_count'] >= 1, 'no loop closure fired'
    assert port_run['lc_count'] == jax_run['lc_count']
    assert port_run['loops'] == jax_run['loops']
    got, want = _unit(port_run['poses']), _unit(jax_run['poses'])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert port_run['ate'] < 0.05 * port_run['path'], port_run['ate']


def test_classic_backend_state(port_run):
    """What the run leaves: its PGO applied (no result pending), each
    worker process stopped."""
    lc = port_run['slam'].long_term_lc
    assert not lc.lc_in_progress
    assert not lc.retrieval.proc.is_alive()
    assert lc.lc_pool._state != 'RUN'
    assert lc.imcache._worker._state != 'RUN'


def test_classic_pipeline_closes_its_processes():
    """test_classic_lc.py's pipeline run: tiny textured frames, keyframe
    removal on (KEYFRAME_INDEX 2), retrieval threshold 0.01."""
    cfg = acc.base_cfg.clone()
    cfg.PATCHES_PER_FRAME = 8
    cfg.BUFFER_SIZE = 64
    cfg.REMOVAL_WINDOW = 5
    cfg.OPTIMIZATION_WINDOW = 4
    cfg.PATCH_LIFETIME = 4
    cfg.KEYFRAME_INDEX = 2
    cfg.CLASSIC_LOOP_CLOSURE = True
    cfg.LOOP_RETR_THRESH = 0.01
    frames = acc.textured_frames(16)
    H, W, _ = frames[0].shape
    intr = np.array([80.0, 80.0, W / 2, H / 2], np.float32)
    slam = HybridVO(cfg, None, ht=H, wd=W, seed=0, device='cpu')
    lc = slam.long_term_lc
    assert lc is not None
    slam.motion_probe = lambda: 100.0
    for t, img in enumerate(frames):
        slam(t, img, intr)
    poses, _ = slam.terminate()
    assert poses.shape == (len(frames), 7)
    assert np.isfinite(poses).all()
    lc.retrieval.proc.join(timeout=10)
    assert not lc.retrieval.proc.is_alive()
    for pool in (lc.lc_pool, lc.imcache._worker):
        assert pool._state != 'RUN'
        assert not any(p.is_alive() for p in pool._pool)


def test_construction_without_opencv_raises(monkeypatch):
    """An import of cv2 that fails (sys.modules entry None) makes
    construction raise ImportError naming OpenCV."""
    monkeypatch.setitem(sys.modules, 'cv2', None)
    for name in [m for m in sys.modules
                 if m.startswith('dpvo_torch.loop_closure.')
                 and m != 'dpvo_torch.loop_closure.proximity']:
        monkeypatch.delitem(sys.modules, name)
    with pytest.raises(ImportError, match='OpenCV'):
        HybridVO(acc.classic_cfg(), None, *acc.CLASSIC_HW, device='cpu')


def _removal_run():
    """HybridVO on the oracle plane scene with a dwell (frames 12-18 move a
    fifth as far) and KEYFRAME_THRESH 0.8, stopped at the first frame
    whose keyframe test removes a keyframe: the device still owes that
    removal (_pending_kf_k) when the run returns."""
    from dpvo_torch.runtime import numpy_se3 as nse3
    gt = acc.plane_gt_poses(acc.ORACLE_FRAMES, dwell=(12, 19))
    slam = HybridVO(acc.oracle_cfg(0.8), None, *acc.ORACLE_HW, seed=3,
                    device='cpu')
    slam._oracle = acc.plane_oracle(gt)
    slam.motion_probe = lambda: 100.0
    slam.rng = acc.ConstDepthRng(slam.rng)
    rng = np.random.RandomState(1)
    for t in range(acc.ORACLE_FRAMES):
        slam(t, rng.randint(0, 255, acc.ORACLE_HW + (3,), np.uint8),
             acc.ORACLE_INTR)
        slam._drain()
        if slam._pending_kf_k >= 0:
            return slam, nse3
    raise AssertionError('no keyframe removal in the scene')


def test_apply_pgo_result_after_a_pending_removal(monkeypatch):
    """apply_pgo_result needs no LongTermLoopClosure and no OpenCV: pgo.py
    imports with cv2 missing (sys.modules entry None). A result that
    leaves every pose as it is (unit scales), applied while a keyframe
    removal is still owed by the device, gives the state of the removal
    applied and a normalize: the rows land where the host has them."""
    want, _ = _removal_run()
    want._flush_pending()
    want.normalize()

    slam, nse3 = _removal_run()
    monkeypatch.setitem(sys.modules, 'cv2', None)
    monkeypatch.delitem(sys.modules, 'dpvo_torch.loop_closure.pgo',
                        raising=False)
    from dpvo_torch.loop_closure.pgo import apply_pgo_result, se3_to_sim3
    safe_i = slam.n - 2
    apply_pgo_result(slam, se3_to_sim3(nse3.inv(slam.poses_np[:safe_i])))
    assert slam._pending_kf_k < 0
    for got, ref in ((slam.st.poses, want.st.poses),
                     (slam.st.depth, want.st.depth)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-6)
    # the host mirrors follow the device
    np.testing.assert_array_equal(slam.poses_np, slam.st.poses.numpy())
    np.testing.assert_array_equal(slam.depth_np, slam.st.depth.numpy())
