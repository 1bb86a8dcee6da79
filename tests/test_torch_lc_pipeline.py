"""DPV-SLAM's learned loop closure at MIRROR_PIPELINE = 2: dpvo_torch
against dpvo_tpu on the CPU.

test_torch_loop_closure.py's config (synth_frames(20), 96x128, M = 8,
MAX_EDGE_AGE 30, GLOBAL_OPT_FREQ 6, BACKEND_THRESH 1e6, KEYFRAME_THRESH
-1, the motion probe forced) and trained weights (artifacts/
micro_vonet.npz) in f32, with up to two mirrors in flight. Proximity
scheduling reads every mirror in flight first; a frame with global BA
only queues it (the gauge normalization's scale stays on the device) and
reads the poses and depths back through its queue entry, as dpvo_tpu does.
No keyframe is removed (KEYFRAME_THRESH -1), so dpvo_tpu's one-patch
depth shift (ROADMAP.md §3) does not enter.

Held: the same loop-edge count, global-BA frames and inactive store as
dpvo_tpu at 2, poses within test_torch_loop_closure.py's 1e-3 of
dpvo_tpu's made unit (its normalize does not keep the quaternions unit),
and every frame with global BA left its pose / depth read-back in the
queue instead of reading it.

With keyframe removals (KEYFRAME_THRESH 2, the port alone, at 1 and 2):
a drain that proximity scheduling forces, after the new frame's host rows
are written, may remove a keyframe and so move those rows down one. The
port then sends the frame to the device at its new row; dpvo_tpu stores
it at the old one (ROADMAP.md §3), so the two packages are not compared. Held: at every frame_step the
device's patch centres equal the host's rows, keyframes were removed,
terminate's mirrors equal the device rows, and _settle_deltas scaled the
relative pose of a removed frame by the normalizes that followed it.
"""
import numpy as np
import pytest

from dpvo_torch.config import cfg as torch_cfg
from dpvo_torch.runtime import DPVO as TorchDPVO
from dpvo_torch.runtime import HybridVO
from dpvo_tpu.config import cfg as jax_cfg
from dpvo_tpu.runtime import HybridVO as JaxHybridVO
from test_loop_closure import synth_frames
from test_torch_loop_closure import _lc_cfg, _unit
from test_torch_runtime import NPZ, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')


def _run(build, base):
    frames = synth_frames(20)
    H, W, _ = frames[0].shape
    intr = np.array([80.0, 80.0, W / 2, H / 2], np.float32)
    cfg = _lc_cfg(base, False)
    cfg.MIRROR_PIPELINE = 2
    slam = build(cfg, NPZ, ht=H, wd=W, seed=0)
    slam.motion_probe = lambda: 100.0
    deferred_ba = []     # frames whose global BA left its read-back queued
    for t, img in enumerate(frames):
        before = slam.ran_global_ba.copy()
        tracking = slam.is_initialized       # not the bootstrap's updates
        slam(t, img, intr)
        ran = np.flatnonzero(slam.ran_global_ba & ~before)
        if len(ran) and tracking and isinstance(slam, HybridVO):
            deferred_ba.append((int(ran[0]), slam._deferred[-1][-1]
                                is not None))
    poses, _ = slam.terminate()
    return dict(slam=slam, poses=poses, n_loop=slam._n_loop_edges,
                gba=np.flatnonzero(slam.ran_global_ba),
                deferred_ba=deferred_ba)


def test_lc_pipeline_matches_jax():
    t = _run(lambda *a, **k: TorchDPVO(*a, device='cpu', **k), torch_cfg)
    j = _run(JaxHybridVO, jax_cfg)
    ts, js = t['slam'], j['slam']
    assert isinstance(ts, HybridVO) and ts._pipeline == 2
    assert t['n_loop'] == j['n_loop'] > 0
    assert np.array_equal(t['gba'], j['gba']) and len(t['gba']) >= 2
    assert len(ts.ii_inac) == len(js.ii_inac) > 0
    for k in ('ii_inac', 'jj_inac', 'kk_inac'):
        assert np.array_equal(getattr(ts, k), getattr(js, k)), k
    assert (ts.n, ts.m, ts.counter) == (js.n, js.m, js.counter)
    # every global BA during the frames (not terminate's) left its
    # read-back queued
    assert len(t['deferred_ba']) >= 2
    assert all(queued for _, queued in t['deferred_ba']), t['deferred_ba']
    assert not ts._scale_events          # settled at terminate
    assert np.isfinite(t['poses']).all() and t['poses'].shape == (20, 7)
    assert np.abs(np.linalg.norm(t['poses'][:, 3:], axis=1) - 1).max() < 1e-6
    np.testing.assert_allclose(t['poses'], _unit(j['poses']), rtol=0,
                               atol=1e-3)
    assert np.abs(t['poses'][:, :3]).max() > 1e-2      # the camera moved


@pytest.mark.parametrize('k', [1, 2])
def test_lc_removals_keep_host_and_device_rows(k):
    frames = synth_frames(20)
    H, W, _ = frames[0].shape
    intr = np.array([80.0, 80.0, W / 2, H / 2], np.float32)
    cfg = _lc_cfg(torch_cfg, False)
    cfg.MIRROR_PIPELINE = k
    cfg.KEYFRAME_THRESH = 2.0
    slam = TorchDPVO(cfg, NPZ, ht=H, wd=W, seed=0, device='cpu')
    slam.motion_probe = lambda: 100.0
    M, steps, removals, scaled = slam.M, [], [], []
    fused_step, keyframe, settle = (slam._fused_step, slam.keyframe,
                                    slam._settle_deltas)

    def checked_step(*args, **kw):
        out = fused_step(*args, **kw)
        rows = (out[1] + 1) * M          # the frame's dispatch: ns + 1 rows
        steps.append(np.array_equal(slam.st.patch_xy[:rows, :, 1, 1].numpy(),
                                    slam.centers_np[:rows]))
        return out

    def counted_keyframe():
        n = slam.n
        keyframe()
        if slam.n < n:
            removals.append(slam.counter)

    def checked_settle():
        before = {t: dP.copy() for t, (_, dP) in slam.delta.items()}
        pending = bool(slam._scale_events)
        settle()
        scaled.extend(t for t, dP in before.items()
                      if pending and not np.array_equal(dP, slam.delta[t][1]))

    slam._fused_step, slam.keyframe, slam._settle_deltas = (
        checked_step, counted_keyframe, checked_settle)
    for t, img in enumerate(frames):
        slam(t, img, intr)
    poses, tstamps = slam.terminate()
    assert len(steps) == 20 and all(steps), steps
    assert slam._n_loop_edges > 0 and len(removals) >= 3, removals
    assert slam.n + len(slam.delta) == slam.counter == 20
    assert scaled and not slam._scale_events, scaled
    np.testing.assert_array_equal(slam.poses_np, slam.st.poses.numpy())
    np.testing.assert_array_equal(slam.depth_np, slam.st.depth.numpy())
    assert np.isfinite(poses).all() and poses.shape == (20, 7)
    np.testing.assert_array_equal(tstamps, np.arange(20))
