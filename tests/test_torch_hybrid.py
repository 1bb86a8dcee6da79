"""The hybrid runtime: dpvo_tpu's HybridVO against dpvo_torch's on the CPU,
same frames, same seed (host numpy draws of centroids and depth seeds), same
weights (artifacts/micro_vonet.npz), f32; and its host and device pieces.

Both sides get CENTROID_SEL_STRAT=GRADIENT_BIAS, which is what sends a
config to the hybrid runtime, the short windows of test_torch_runtime.py
and 16 frames of its moving texture, with the motion probe forced as
bench.py does (random-looking early frames never pass it). The run covers
the store-only pre-init frames, bootstrap (frame 8, 12 updates), the fused
steady-state frame steps, keyframe removals (n ends at 8 of 16), edge
retirement and terminate()'s 12 updates. At 64x96 the level-2 map (4x6)
is below D_MIN, so both sides take the exact correlation.

Tolerance 1e-3 on every pose component (unit quaternions, translations
< 1). Two things separate the sides. Sums run in another order (f32 on
both sides): against a dpvo_tpu whose keyframe removal moves whole frames,
the port agrees to 3.2e-5 (measured). And dpvo_tpu's removal
(runtime/state.py:261-262, :305-306) rolls the flat patch_xy and depth
buffers by one patch instead of one frame (ROADMAP.md queue 3); the port
moves whole frames (test_keyframe_removal_shifts_whole_frames), and the
trajectories then differ by up to 8.8e-4 (measured)."""
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dpvo_torch.config import cfg as torch_cfg
from dpvo_torch.runtime import DPVO as TorchDPVO
from dpvo_torch.runtime import HybridVO
from dpvo_torch.runtime import state as tstate
from dpvo_tpu.config import cfg as jax_cfg
from dpvo_tpu.runtime import DPVO as JaxDPVO
from dpvo_tpu.runtime import state as jstate
from test_torch_runtime import (H, INTR, NPZ, POSE_TOL, W, _cfg, _frames,
                                torch_threads)


def _run(build, base, frames, force_probe, **kw):
    vo = build(_cfg(base, CENTROID_SEL_STRAT='GRADIENT_BIAS', **kw), NPZ,
               ht=H, wd=W, seed=0)
    if force_probe:
        vo.motion_probe = lambda: 100.0
    for t, img in enumerate(frames):
        vo(t, img, INTR)
    poses, tstamps = vo.terminate()
    return vo, poses, tstamps


def run_jax(frames, force_probe=True, **kw):
    return _run(JaxDPVO, jax_cfg, frames, force_probe, **kw)


def run_torch(frames, force_probe=True, **kw):
    vo, poses, tstamps = _run(
        lambda *a, **k: TorchDPVO(*a, device='cpu', **k), torch_cfg, frames,
        force_probe, **kw)
    assert isinstance(vo, HybridVO)
    return vo, poses, tstamps


def check_slice(frames, tol, **kw):
    jv, jp, jt = run_jax(frames, **kw)
    tv, tp, tt = run_torch(frames, **kw)
    assert (tv.n, tv.counter, tv.m) == (jv.n, jv.counter, jv.m)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tv.tstamps_[:tv.n], jv.tstamps_[:jv.n])
    assert np.isfinite(tp).all() and tp.shape == (len(frames), 7)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=tol)
    pts = tv.point_cloud()
    assert pts.shape == (tv.m, 3) and np.isfinite(pts).all()
    return tv, tp


def test_whole_slice_matches_jax():
    tv, tp = check_slice(_frames(16), POSE_TOL)
    assert tv.n <= 16 - 4                         # keyframes were removed
    assert np.abs(tp[:, :3]).max() > 1e-2         # the camera moved


def test_keyframe_removal_shifts_whole_frames():
    """Removing keyframe k moves every per-frame and per-patch row after it
    down by one frame (patch_xy and depth by M rows), and ring slot
    f % slots of each moved frame f receives slot (f + 1) % slots
    (reference dpvo.py:287-297). dpvo_tpu's shift_frames rolls the flat
    patch_xy / depth buffers by one patch instead (runtime/state.py:261-262,
    :305-306)."""
    M, n, k, ring = 3, 7, 2, 5
    st = tstate.init_state(16, M, ring, ring, 64, 64, 128, 'cpu',
                           torch.float32)
    for t in st.tensors().values():
        t.copy_(torch.arange(t.numel(), dtype=t.dtype).reshape(t.shape))
    before = {name: t.clone() for name, t in st.tensors().items()}
    st.imap[...] = torch.arange(ring * M)[:, None].float()      # row ids
    rows_before = st.imap[:, 0].clone()
    tstate.shift_frames(st, k, n, M=M, pmem=ring, mem=ring)

    for name, rows in (('poses', 1), ('intr', 1), ('patch_xy', M),
                       ('depth', M)):
        a, b = getattr(st, name), before[name]
        assert torch.equal(a[:k * rows], b[:k * rows]), name
        assert torch.equal(a[k * rows:(n - 1) * rows],
                           b[(k + 1) * rows:n * rows]), name
        assert torch.equal(a[(n - 1) * rows:], b[(n - 1) * rows:]), name
    # frames 3..6 sit in ring slots 3, 4, 0, 1 and move to slots 2, 3, 4, 0
    slot_src = {2: 3, 3: 4, 4: 0, 0: 1, 1: 1}
    for s, src in slot_src.items():
        assert torch.equal(st.fmap1[s], before['fmap1'][src])
        assert torch.equal(st.gmap.view(ring, M, -1)[s],
                           before['gmap'].view(ring, M, -1)[src])
        assert torch.equal(st.imap[s * M:(s + 1) * M, 0],
                           rows_before[src * M:(src + 1) * M])


def _edges(seed, M, frames, span):
    rng = np.random.RandomState(seed)
    ii = np.repeat(rng.randint(frames[0], frames[1], 40), M)
    kk = ii * M + np.tile(np.arange(M), 40)
    jj = np.clip(ii + rng.randint(-span, span + 1, ii.shape), 0, None)
    return ii, jj, kk


@pytest.mark.parametrize('frames, span', [((3, 12), 3),      # dense ids
                                          ((0, 60), 40)])    # np.unique ids
def test_edge_table_matches_jax(frames, span):
    from dpvo_tpu.runtime.dpvo import DPVO as JaxHybrid
    M = 3
    ii, jj, kk = _edges(0, M, frames, span)
    host = SimpleNamespace(M=M, pmem=36, mem=36)
    jt, jcap, _, remap = JaxHybrid._edge_table(host, ii.astype(np.int32),
                                               jj.astype(np.int32),
                                               kk.astype(np.int32))
    tt, tcap = HybridVO._edge_table(host, ii, jj, kk)
    assert (tcap, remap) == (jcap, False)
    np.testing.assert_array_equal(tt, jt[:tstate.TABLE_ROWS])


@pytest.mark.parametrize('n', [1, 7, 8, 128, 129, 5000, 9000, 20000])
def test_edge_bucket_matches_jax(n):
    assert tstate.edge_bucket(n) == jstate.edge_bucket(n)


def test_gather_rows_and_probe_median_match_jax():
    rng = np.random.RandomState(0)
    buf = rng.randn(10, 4).astype(np.float32)
    idx = np.array([3, -1, 0, 9, -1, 2], np.int32)
    np.testing.assert_array_equal(
        tstate.gather_rows(torch.from_numpy(buf), torch.from_numpy(idx)
                           .long()).numpy(),
        np.asarray(jstate.gather_rows(buf, idx)))
    for n_valid in (5, 6):        # odd / even: linear interpolation
        delta = rng.randn(128, 2).astype(np.float32)
        mask = np.arange(128) < n_valid
        got = tstate.probe_median_delta(torch.from_numpy(delta),
                                        torch.from_numpy(mask))
        assert float(got) == pytest.approx(
            float(jstate.probe_median_delta(delta, mask)), rel=1e-6)


@pytest.mark.parametrize('key, value, viz', [
    ('CENTROID_SEL_STRAT', 'GRADIENT_BIAS', True)])
def test_unported_options_raise(key, value, viz, tmp_path, monkeypatch):
    """No option of HybridVO is left unported: viz=True builds the headless
    viewer (viz/viewer.py), joined at terminate(). A viewer that fails to
    start raises; dpvo_tpu warns and runs on without one."""
    from dpvo_torch.viz import viewer
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv('DISPLAY', raising=False)
    vo = HybridVO(_cfg(torch_cfg, **{key: value}), NPZ, ht=H, wd=W, viz=viz,
                  device='cpu')
    assert isinstance(vo.viewer, viewer.Viewer) and not vo.viewer.live
    vo(0, _frames(1)[0], INTR)
    vo.terminate()
    assert not vo.viewer.thread.is_alive()
    assert (tmp_path / 'viewer_out' / 'frame_000000.jpg').exists()

    def broken(*args, **kwargs):
        raise PermissionError('viewer_out is not writable')
    monkeypatch.setattr(viewer, 'Viewer', broken)
    with pytest.raises(PermissionError, match='viewer_out'):
        HybridVO(_cfg(torch_cfg, **{key: value}), NPZ, ht=H, wd=W, viz=viz,
                 device='cpu')


@pytest.mark.parametrize('key, value', [('UPLOAD_FORMAT', 'yuv420'),
                                        ('MIRROR_PIPELINE', 2),
                                        ('LOOP_CLOSURE', True),
                                        ('CLASSIC_LOOP_CLOSURE', True)])
def test_ported_options_accepted(key, value):
    """I420 ingest is ported (test_torch_ingest.py holds it against
    dpvo_tpu); MIRROR_PIPELINE > 1 keeps that many mirrors in flight
    (test_torch_hybrid_pipeline.py); LOOP_CLOSURE runs
    the learned backend with a MAX_EDGE_AGE-frame feature ring
    (test_torch_loop_closure.py); CLASSIC_LOOP_CLOSURE builds the classic
    backend (test_torch_classic_lc.py)."""
    vo = HybridVO(_cfg(torch_cfg, **{key: value}), NPZ, ht=H, wd=W,
                  device='cpu')
    assert vo._upload == ('yuv420' if key == 'UPLOAD_FORMAT' else 'rgb')
    lc = key == 'LOOP_CLOSURE'
    assert vo.pmem == (torch_cfg.MAX_EDGE_AGE if lc else vo.mem)
    assert vo.st.gmap.shape[0] == vo.pmem * vo.M
    assert (vo.long_term_lc is not None) == (key == 'CLASSIC_LOOP_CLOSURE')
    if vo.long_term_lc is not None:
        vo.long_term_lc.close()


def test_mirror_pipeline_gives_the_synchronous_poses():
    """With no keyframe removal (KEYFRAME_THRESH -1), MIRROR_PIPELINE=2
    stays within POSE_TOL of the synchronous poses (measured 1.4e-4): the
    pipeline moves when the host reads the mirrors, runs the keyframe tests
    and retires edges (the first drain comes a frame later, so frame 9
    still sees frame 0's edges), while frame_step computes the pose and
    depth inits from the device state. With removals the trajectories
    part, since a removal drops the keyframe tests of the mirrors in
    flight, as dpvo_tpu does (test_torch_hybrid_pipeline.py holds the port
    at 2 and 3 to dpvo_tpu at the same value)."""
    frames = _frames(12)
    with torch_threads(1):
        runs = [run_torch(frames, MIRROR_PIPELINE=k, KEYFRAME_THRESH=-1.0)
                for k in (1, 2)]
    assert [vo._pipeline for vo, _, _ in runs] == [1, 2]
    assert runs[0][0].n == runs[1][0].n == 12
    np.testing.assert_allclose(runs[1][1], runs[0][1], rtol=0,
                               atol=POSE_TOL)


def test_corr_impl_override(monkeypatch):
    """DPVO_CORR_IMPL picks the correlation of both runtimes: dpvo_tpu's
    'fused_k' and 'fused' both run K2 + K3 ('fused'); an unknown value is
    refused."""
    c = _cfg(torch_cfg, CENTROID_SEL_STRAT='GRADIENT_BIAS')
    for impl, mode in (('fused_k', 'fused'), ('fused', 'fused'),
                       ('onepass', 'onepass')):
        monkeypatch.setenv('DPVO_CORR_IMPL', impl)
        assert HybridVO(c, NPZ, ht=H, wd=W, device='cpu')._corr_mode == mode
        dv = TorchDPVO(_cfg(torch_cfg), NPZ, ht=H, wd=W, device='cpu')
        assert dv._static['corr_impl'] == mode
    monkeypatch.setenv('DPVO_CORR_IMPL', 'xla')
    with pytest.raises(ValueError, match='DPVO_CORR_IMPL'):
        HybridVO(c, NPZ, ht=H, wd=W, device='cpu')
    monkeypatch.delenv('DPVO_CORR_IMPL')
    assert HybridVO(c, NPZ, ht=H, wd=W, device='cpu')._corr_mode == 'onepass'
    assert os.environ.get('DPVO_CORR_IMPL') is None
