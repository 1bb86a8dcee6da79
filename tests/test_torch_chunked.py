"""The chunked step: DeviceVO.track_frames (one upload of K frames, then
vo_frame over its rows) against per-frame __call__ on the same frames, and
against dpvo_tpu's track_frames (tests/test_chunked.py is dpvo_tpu's own).

The port's chunk runs the per-frame math frame by frame, so its state
must match the per-frame run's: poses within 1e-4, depths within 1e-3
relative (test_chunked.py's bounds), keyframe and frame counts equal. The
run is test_torch_runtime.py's 16-frame slice (bootstrap inside a chunk,
keyframe removals), in chunks of 3 and of 5 (the last one short), rgb and
yuv420. Against dpvo_tpu (chunks of 4, rgb, f32) the poses after
terminate() are compared, at test_torch_runtime.py's POSE_TOL: depths
differ by design after a removal (its docstring).
"""
import numpy as np
import pytest

from dpvo_torch.config import cfg as torch_cfg
from dpvo_torch.runtime import DeviceVO
from dpvo_tpu.config import cfg as jax_cfg
from test_torch_runtime import (H, INTR, NPZ, POSE_TOL, W, _cfg, _frames,
                                one_torch_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')
T = 16


def _port(chunk, upload='rgb'):
    """The port's DeviceVO over T frames, per frame (chunk None) or in
    chunks; returns it after the last frame, before terminate()."""
    vo = DeviceVO(_cfg(torch_cfg, UPLOAD_FORMAT=upload), NPZ, ht=H, wd=W,
                  seed=0, device='cpu')
    vo.force_accept = True
    frames = _frames(T)
    if chunk is None:
        for t, img in enumerate(frames):
            vo(t, img, INTR)
    else:
        for t in range(0, T, chunk):
            vo.track_frames(list(range(t, min(t + chunk, T))),
                            np.stack(frames[t:t + chunk]), INTR)
    return vo


def _summary(vo):
    """The state after the last frame, then terminate()'s output."""
    st, n = vo.st, vo.n
    out = dict(n=n, counter=int(st.counter), h2d=vo.h2d_bytes,
               poses=st.poses[:n].numpy().copy(),
               depth=st.depth[:n * vo.M].numpy().copy())
    out['traj'], out['tstamps'] = vo.terminate()
    return out


@pytest.fixture(scope='module')
def per_frame():
    return {up: _summary(_port(None, up)) for up in ('rgb', 'yuv420')}


@pytest.mark.parametrize('upload', ['rgb', 'yuv420'])
@pytest.mark.parametrize('chunk', [3, 5])
def test_track_frames_matches_per_frame(per_frame, chunk, upload):
    a, b = per_frame[upload], _summary(_port(chunk, upload))
    assert (a['n'], a['counter']) == (b['n'], b['counter'])
    assert a['n'] <= T - 4                        # keyframes were removed
    assert a['h2d'] == b['h2d']
    np.testing.assert_allclose(b['poses'], a['poses'], rtol=0, atol=1e-4)
    np.testing.assert_allclose(b['depth'], a['depth'], rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(b['tstamps'], a['tstamps'])
    np.testing.assert_allclose(b['traj'], a['traj'], rtol=0, atol=1e-4)


@pytest.mark.parametrize('form', ['vo_frames', 'vo_frames_packed'])
def test_vo_frames_match_vo_frame(form):
    """The state-level chunk functions (tests/test_chunked.py's layout:
    frames 0-9 one by one, then 10-15 as one chunk) against vo_frame."""
    import torch
    from dpvo_torch.runtime import device_vo as dv
    c = _cfg(torch_cfg)
    vo = DeviceVO(c, NPZ, ht=H, wd=W, device='cpu')
    net, kw = vo.network, dict(vo._static, force_accept=True)
    rng = np.random.RandomState(0)
    M, WARM = c.PATCHES_PER_FRAME, 10
    images = torch.from_numpy(np.stack(_frames(T)))
    coords = torch.from_numpy(rng.randint(1, W // 4 - 1, (T, M, 2))
                              .astype(np.float32))
    seeds = torch.from_numpy(rng.rand(T, M).astype(np.float32))
    times = torch.arange(T, dtype=torch.float32)
    aux = torch.cat([coords, seeds[..., None],
                     times[:, None, None].expand(T, M, 1)], dim=-1)
    sts = []
    for chunked in (False, True):
        st = dv.init_state(c, H, W, INTR, 'cpu', torch.float32)
        for t in range(T if not chunked else WARM):
            st = dv.vo_frame(net, st, images[t], aux[t], **kw)
        if chunked and form == 'vo_frames':
            st = dv.vo_frames(net, st, images[WARM:], coords[WARM:],
                              seeds[WARM:], times[WARM:], **kw)
        elif chunked:
            st = dv.vo_frames_packed(net, st, images[WARM:], aux[WARM:], **kw)
        sts.append(st)
    a, b = sts
    n = int(a.n)
    assert (n, int(a.counter)) == (int(b.n), int(b.counter)) and n <= T - 4
    np.testing.assert_allclose(b.poses[:n].numpy(), a.poses[:n].numpy(),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(b.depth[:n * M].numpy(),
                               a.depth[:n * M].numpy(), rtol=1e-3,
                               atol=1e-4)


def test_track_frames_matches_jax():
    from dpvo_tpu.runtime.device_driver import DeviceVO as JaxDeviceVO
    frames = np.stack(_frames(T))
    jv = JaxDeviceVO(_cfg(jax_cfg), NPZ, ht=H, wd=W, seed=0)
    jv._static['force_accept'] = True
    for t in range(0, T, 4):
        jv.track_frames(list(range(t, t + 4)), frames[t:t + 4], INTR)
    jp, _ = jv.terminate()
    tp, tt = _port(4).terminate()
    np.testing.assert_array_equal(tt, np.arange(T))
    np.testing.assert_allclose(tp, jp, rtol=0, atol=POSE_TOL)
    assert np.abs(tp[:, :3]).max() > 1e-2


def test_track_frames_capacity_checks():
    """The chunk is refused whole where its worst case (every frame a
    keyframe) could overflow BUFFER_SIZE, and frames of the wrong shape
    are refused."""
    vo = DeviceVO(_cfg(torch_cfg, BUFFER_SIZE=8, KEYFRAME_THRESH=0.0), NPZ,
                  ht=H, wd=W, seed=0, device='cpu')
    vo.force_accept = True
    frames = np.stack(_frames(8))
    vo.track_frames([0, 1, 2, 3], frames[:4], INTR)
    with pytest.raises(RuntimeError, match='buffer size'):
        vo.track_frames([4, 5, 6], frames[4:7], INTR)
    assert vo.n == 4 and len(vo.tlist) == 4
    with pytest.raises(ValueError, match='frame'):
        vo.track_frames([4], frames[4:5, :-1], INTR)
