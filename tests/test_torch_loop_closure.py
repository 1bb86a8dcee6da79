"""DPV-SLAM's learned loop closure: dpvo_tpu against dpvo_torch on the CPU.

Pieces, on the same numpy inputs:
  * reduce_edges and proximity_edges (loop_closure/proximity.py, copied):
    the same edges, in the same order;
  * normalize() against dpvo_tpu's _normalize_dev (+ _settle_deltas for
    the removed frames' relative poses): poses, depths and deltas within
    1e-6, and the guard on a non-finite or non-positive mean depth.
    dpvo_tpu rebases with the conjugate of pose 0's quaternion, which is
    its inverse only at unit norm, so each normalize squares pose 0's norm
    and multiplies every other one by it; the reference's lietorch makes
    each quaternion unit when it reads it. The port makes the live
    quaternions unit before it rebases (test_normalize_keeps_unit_
    quaternions shows both).
  * HybridVO.point_cloud() after a keyframe removal the device still owes.

The whole LC runtime on tests/test_loop_closure.py's config (synth_frames
(20), 96x128, M = 8, MAX_EDGE_AGE 30, GLOBAL_OPT_FREQ 6, BACKEND_THRESH
1e6, KEYFRAME_THRESH -1, the motion probe forced): proximity runs every
6 frames and at terminate, and global BA runs at n = 8, 9, 15 and 20
(bootstrap, loop edges) and in each of terminate's 12 refinements.
  * With artifacts/micro_vonet.npz in f32: poses within 1e-3 of dpvo_tpu's
    once its quaternions are made unit (its 16 normalizes leave them
    ~1.0015 long, measured; the port's stay unit within 1e-6); the same
    loop-edge count, global-BA frames and inactive store indices. The same
    in bf16 within 1e-2.
  * With seeded random weights (test_loop_closure.py's own), the same
    discrete outputs: loop edges, global-BA frames, inactive store. Poses
    are not held there: in terminate's 12 refinements the random update
    pushes the depths of frame 18's patches, seen from frames 15-19 only,
    further each time, and the two packages' values part by ~0.1 (measured
    1.97 against 1.85), so their poses end ~1e-3 apart.
The store's [target | weight] rows are the learned update's output, which
the two packages compute with sums in another order: they are held to
1e-3 in f32 (measured 1.6e-4 on rows of up to 33 px) and to one bf16
rounding of the largest row in bf16 (measured 0.016); test_torch_lc_ate.py
holds them to 1e-5 on the oracle run, whose targets do not depend on the
state.
Each dpvo_tpu run is made once per module.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpvo_torch.config import cfg as torch_cfg
from dpvo_torch.loop_closure import proximity as tprox
from dpvo_torch.runtime import DPVO as TorchDPVO
from dpvo_torch.runtime import HybridVO
from dpvo_torch.runtime import numpy_se3 as nse3
from dpvo_tpu.config import cfg as jax_cfg
from dpvo_tpu.loop_closure import proximity as jprox
from dpvo_tpu.runtime import HybridVO as JaxHybridVO
from dpvo_tpu.runtime import dpvo as jdpvo
from test_loop_closure import synth_frames
from test_torch_runtime import (H as RH, INTR as RINTR, NPZ, W as RW, _cfg,
                                _frames, one_torch_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')


# ---------------------------------------------------------------------------
# proximity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('seed, n, nms, cap', [(0, 40, 1, 1000),
                                               (1, 300, 1, 1000),
                                               (2, 300, 2, 7),
                                               (3, 0, 1, 1000)])
def test_reduce_edges_matches_jax(seed, n, nms, cap):
    """Integer flows, so that many candidates tie: the stable order must
    break the ties the same way."""
    rng = np.random.RandomState(seed)
    flow = rng.randint(0, 20, n).astype(np.float64)
    ii, jj = rng.randint(0, 30, n), rng.randint(20, 60, n)
    got = tprox.reduce_edges(flow, ii, jj, cap, nms=nms)
    ref = jprox.reduce_edges(flow, ii, jj, cap, nms=nms)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    if n:
        assert 0 < len(got) <= cap


def _mirror_state(cfg, n, M, seed):
    """A graph's host mirrors: an out-and-back camera path (frames i and
    n - 1 - i close to each other), patch centers and depths."""
    rng = np.random.RandomState(seed)
    N = n + 4
    s = np.minimum(np.arange(N), n - 1 - np.arange(N)).clip(0)
    xi = np.zeros((N, 6), np.float32)
    xi[:, 0] = 0.05 * s + 0.01 * rng.randn(N)
    xi[:, 4] = 0.01 * rng.randn(N)
    poses = np.stack([nse3.exp(x) for x in xi]).astype(np.float32)
    return SimpleNamespace(
        cfg=cfg, M=M, n=n, poses_np=poses,
        centers_np=rng.uniform(2, 30, (N * M, 2)).astype(np.float32),
        depth_np=rng.uniform(0.2, 1.0, N * M).astype(np.float32),
        intr_np=np.array([20.0, 20.0, 16.0, 12.0], np.float32))


@pytest.mark.parametrize('thresh, n', [(1e6, 40), (64.0, 40), (3.0, 40),
                                       (64.0, 5)])
def test_proximity_edges_match_jax(thresh, n):
    out = []
    for base, prox in ((torch_cfg, tprox), (jax_cfg, jprox)):
        cfg = base.clone()
        cfg.REMOVAL_WINDOW, cfg.GLOBAL_OPT_FREQ = 6, 8
        cfg.KEYFRAME_INDEX, cfg.MAX_EDGE_AGE = 2, 20
        cfg.BACKEND_THRESH = thresh
        out.append(prox.proximity_edges(_mirror_state(cfg, n, 4, 0)))
    (tk, tj), (jk, jj) = out
    assert tk.dtype == jk.dtype and np.array_equal(tk, jk)
    assert tj.dtype == jj.dtype and np.array_equal(tj, jj)
    if thresh == 1e6:
        assert len(tk) > 0
    if n == 5:                           # no frame is older than the window
        assert len(tk) == 0


# ---------------------------------------------------------------------------
# normalize
# ---------------------------------------------------------------------------

def _pose_state(seed, N=12, M=3, qnorm=1.0):
    rng = np.random.RandomState(seed)
    xi = 0.3 * rng.randn(N, 6).astype(np.float32)
    poses = np.stack([nse3.exp(x) for x in xi]).astype(np.float32)
    poses[0, 3:] *= qnorm
    depth = rng.uniform(0.1, 2.0, N * M).astype(np.float32)
    return poses, depth


def _port_normalize(poses, depth, n, M, delta):
    host = SimpleNamespace(
        st=SimpleNamespace(poses=torch.from_numpy(poses.copy()),
                           depth=torch.from_numpy(depth.copy())),
        n=n, M=M, delta={k: (t0, dP.copy()) for k, (t0, dP) in
                         delta.items()},
        _scale_events=[], _delta_epoch={k: 0 for k in delta})
    HybridVO.normalize(host)
    HybridVO._settle_deltas(host)
    return host.st.poses.numpy(), host.st.depth.numpy(), host.delta


def _jax_normalize(poses, depth, n, M, delta, times=1):
    host = SimpleNamespace(poses_dev=jnp.asarray(poses),
                           depth_dev=jnp.asarray(depth), n=n, M=M,
                           _scale_events=[], delta=dict(delta),
                           _delta_epoch={k: 0 for k in delta})
    for _ in range(times):
        jdpvo.DPVO.normalize(host)
    jdpvo.DPVO._settle_deltas(host)
    return np.asarray(host.poses_dev), np.asarray(host.depth_dev), host.delta


@pytest.mark.parametrize('case', ['mean', 'nan', 'negative'])
def test_normalize_matches_jax(case):
    n, M = 9, 3
    poses, depth = _pose_state(0, M=M)
    if case == 'nan':
        depth[4] = np.nan
    elif case == 'negative':
        depth[:n * M] = -depth[:n * M]
    rng = np.random.RandomState(1)
    delta = {t: (t - 1, nse3.exp(0.2 * rng.randn(6).astype(np.float32))
                 .astype(np.float32)) for t in (3, 7)}
    tp, td, tdel = _port_normalize(poses, depth, n, M, delta)
    jp, jd, jdel = _jax_normalize(poses, depth, n, M, delta)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-6, equal_nan=True)
    for t in delta:
        assert tdel[t][0] == jdel[t][0]
        np.testing.assert_allclose(tdel[t][1], jdel[t][1], rtol=0, atol=1e-6)
    if case == 'mean':
        assert abs(td[:n * M].mean() - 1.0) < 1e-6
        np.testing.assert_allclose(tp[0], [0, 0, 0, 0, 0, 0, 1], atol=1e-6)
        assert np.array_equal(tp[n:], poses[n:])   # rows past n untouched
        assert not np.allclose(tdel[3][1], delta[3][1])
    else:                                          # the guard: untouched
        assert np.array_equal(tp, poses)
        assert np.array_equal(td, depth, equal_nan=True)


def test_normalize_keeps_unit_quaternions():
    """Pose 0's quaternion 1e-4 too long: after 8 normalizes dpvo_tpu's
    are 2^8 times as far from unit, the port's are unit."""
    n, M = 9, 3
    poses, depth = _pose_state(2, M=M, qnorm=1.0 + 1e-4)
    jp, _, _ = _jax_normalize(poses, depth, n, M, {}, times=8)
    tp, td = poses, depth
    for _ in range(8):
        tp, td, _ = _port_normalize(tp, td, n, M, {})
    jn = np.linalg.norm(jp[:n, 3:], axis=1) - 1
    tn = np.linalg.norm(tp[:n, 3:], axis=1) - 1
    assert jn.min() > 0.02 and np.abs(tn).max() < 1e-6, (jn, tn)


# ---------------------------------------------------------------------------
# the point cloud with a removal the device still owes
# ---------------------------------------------------------------------------

def test_point_cloud_after_owed_removal():
    """After a keyframe removal the host mirrors have shifted and the
    device has not (it shifts in the next frame step): point_cloud() must
    describe the shifted keyframes, as the host mirrors do."""
    vo = HybridVO(_cfg(torch_cfg, CENTROID_SEL_STRAT='GRADIENT_BIAS'), NPZ,
                  ht=RH, wd=RW, seed=0, device='cpu')
    vo.motion_probe = lambda: 100.0
    for t, img in enumerate(_frames(16)):
        vo(t, img, RINTR)
        vo._drain()
        if vo._pending_kf_k >= 0:
            break
    assert vo._pending_kf_k >= 0, 'no keyframe removal in 16 frames'
    m = vo.m
    ix = np.arange(m) // vo.M
    c = vo.centers_np[:m]
    fx, fy, cx, cy = vo.intr_np
    pts_c = np.stack([(c[:, 0] - cx) / fx, (c[:, 1] - cy) / fy,
                      np.ones(m)], -1) / vo.depth_np[:m, None]
    ref = nse3.act(nse3.inv(vo.poses_np[ix]), pts_c)
    np.testing.assert_allclose(vo.point_cloud(), ref, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the whole LC runtime
# ---------------------------------------------------------------------------

def _lc_cfg(base, mixed):
    c = base.clone()
    c.PATCHES_PER_FRAME = 8
    c.BUFFER_SIZE = 64
    c.REMOVAL_WINDOW = 6
    c.OPTIMIZATION_WINDOW = 5
    c.PATCH_LIFETIME = 4
    c.KEYFRAME_INDEX = 2
    c.LOOP_CLOSURE = True
    c.GLOBAL_OPT_FREQ = 6
    c.MAX_EDGE_AGE = 30
    c.BACKEND_THRESH = 1e6     # accept any proximity candidate
    c.KEYFRAME_THRESH = -1.0   # retain keyframes (keeps old patches around)
    c.MIXED_PRECISION = mixed
    return c


def _lc_run(build, base, network, mixed):
    frames = synth_frames(20)
    H, W, _ = frames[0].shape
    intr = np.array([80.0, 80.0, W / 2, H / 2], np.float32)
    slam = build(_lc_cfg(base, mixed), network, ht=H, wd=W, seed=0)
    slam.motion_probe = lambda: 100.0
    for t, img in enumerate(frames):
        slam(t, img, intr)
    poses, _ = slam.terminate()
    ni = len(slam.ii_inac)
    tw = (slam._inac_tw[:ni].numpy() if isinstance(slam, HybridVO) else
          np.asarray(slam._inac_tw_dev)[:ni])
    return dict(slam=slam, poses=poses, tw=tw, n_loop=slam._n_loop_edges,
                gba=np.flatnonzero(slam.ran_global_ba))


@pytest.fixture(scope='module')
def lc_runs():
    """(torch, jax) runs by (weights, mixed precision), made on demand."""
    cache = {}

    def get(weights, mixed):
        if (weights, mixed) not in cache:
            net = NPZ if weights == 'npz' else None
            cache[weights, mixed] = (
                _lc_run(lambda *a, **k: TorchDPVO(*a, device='cpu', **k),
                        torch_cfg, net, mixed),
                _lc_run(JaxHybridVO, jax_cfg, net, mixed))
        return cache[weights, mixed]
    return get


def _check_decisions(t, j):
    ts, js = t['slam'], j['slam']
    assert isinstance(ts, HybridVO) and ts.pmem == 30
    assert t['n_loop'] == j['n_loop'] > 0
    assert np.array_equal(t['gba'], j['gba']) and len(t['gba']) >= 2
    assert len(ts.ii_inac) == len(js.ii_inac) > 0
    for k in ('ii_inac', 'jj_inac', 'kk_inac'):
        assert np.array_equal(getattr(ts, k), getattr(js, k)), k
    assert (ts.n, ts.m, ts.counter) == (js.n, js.m, js.counter)


def _unit(poses):
    out = poses.copy()
    out[:, 3:] /= np.linalg.norm(out[:, 3:], axis=1, keepdims=True)
    return out


@pytest.mark.parametrize('mixed, tol', [(False, 1e-3), (True, 1e-2)])
def test_lc_runtime_matches_jax(lc_runs, mixed, tol):
    t, j = lc_runs('npz', mixed)
    _check_decisions(t, j)
    assert np.isfinite(t['poses']).all() and t['poses'].shape == (20, 7)
    assert np.abs(np.linalg.norm(t['poses'][:, 3:], axis=1) - 1).max() < 1e-6
    np.testing.assert_allclose(t['poses'], _unit(j['poses']), rtol=0,
                               atol=tol)
    assert np.abs(t['poses'][:, :3]).max() > 1e-2      # the camera moved
    # the store's rows: f32 at the runtime's pose bound; bf16 within one
    # bf16 rounding of the largest row
    np.testing.assert_allclose(
        t['tw'], j['tw'], rtol=0,
        atol=2 ** -8 * np.abs(j['tw']).max() if mixed else 1e-3)


def test_lc_random_weights_same_decisions(lc_runs):
    t, j = lc_runs('random', False)
    _check_decisions(t, j)
    assert np.isfinite(t['poses']).all()


def test_point_cloud_and_colors_after_terminate(lc_runs):
    """After terminate (normalizes and global BAs included), point_cloud()
    is the patch centers back-projected with the device depths and placed
    with the returned poses; colors() is dpvo_tpu's color mirror."""
    t, j = lc_runs('npz', False)
    vo = t['slam']
    m = vo.m
    ix = np.arange(m) // vo.M
    xy = vo.st.patch_xy[:m, :, 1, 1].numpy()
    intr = vo.st.intr.numpy()[ix]
    pts_c = np.stack([(xy[:, 0] - intr[:, 2]) / intr[:, 0],
                      (xy[:, 1] - intr[:, 3]) / intr[:, 1], np.ones(m)],
                     -1) / vo.st.depth[:m].numpy()[:, None]
    wfc = t['poses'][vo.tstamps_[ix]]
    ref = nse3.act(wfc, pts_c)
    np.testing.assert_allclose(vo.point_cloud(), ref, rtol=1e-5, atol=1e-5)
    clr = vo.colors()
    assert clr.shape == (vo.n, vo.M, 3) and clr.dtype == np.uint8
    assert np.abs(clr.astype(int) - j['slam'].colors_np[:vo.n]).max() <= 1
