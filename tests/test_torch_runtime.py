"""The whole slice: dpvo_tpu's DeviceVO against dpvo_torch's on the CPU, same
frames, same seed (host numpy draws of centroids and depth seeds), same
weights (artifacts/micro_vonet.npz). This file runs it in f32 and holds the
runtime's small pieces; test_torch_runtime_mixed.py runs it in bf16 and
through the motion probe (a file of its own, so that those JAX compiles run
on another test worker).

At 64x96 the JAX side takes its exact XLA correlation (ops/corr.py), the
port its plain version. The run covers bootstrap (frame 8, 12 updates),
steady-state updates, keyframe removals and terminate()'s 12 refinements.

Poses are compared, not depths: dpvo_tpu's keyframe removal shifts its flat
depth buffer by one patch instead of one frame (see
test_keyframe_removal_shifts_whole_frames), which moves a few depths while
the poses stay within the bounds below.

Tolerance, on every pose component (unit quaternions, translations < 1):
with MIXED_PRECISION off every op is f32 on both sides with sums in another
order, the trajectories agree to ~5e-5 over 16 frames, and the bound is
1e-3. With it on (bf16 convs, GEMMs and feature maps) each side rounds at
its own places; they agree to ~1.5e-3 and the bound is 1e-2."""
import contextlib
import os

import numpy as np
import pytest
from scipy.ndimage import gaussian_filter

from dpvo_torch.config import cfg as torch_cfg
from dpvo_torch.runtime import DPVO as TorchDPVO
from dpvo_tpu.config import cfg as jax_cfg
from dpvo_tpu.runtime.device_driver import DeviceVO as JaxDeviceVO
from dpvo_tpu.utils.fetch import fetch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, 'artifacts', 'micro_vonet.npz')
H, W = 64, 96
INTR = np.array([60.0, 60.0, W / 2, H / 2], np.float32)
POSE_TOL = 1e-3
POSE_TOL_BF16 = 1e-2


@contextlib.contextmanager
def torch_threads(n):
    """Run torch's CPU ops on n threads inside the block. The suite runs
    several test processes at once; with every process's intra-op pool as
    wide as the machine, the runtimes' many small parallel ops wait for
    their threads most of the time."""
    import torch
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


@pytest.fixture(scope='module')
def one_torch_thread():
    """A whole module's torch ops on one thread (torch_threads)."""
    with torch_threads(1):
        yield


def _frames(n, seed=0, step=(3, 2)):
    """Smooth seeded texture seen through a crop moving `step` px/frame."""
    rng = np.random.RandomState(seed)
    sx, sy = step
    tex = gaussian_filter(rng.rand(H + sy * n, W + sx * n, 3), (2, 2, 0))
    tex = (tex - tex.min()) / np.ptp(tex) * 255
    return [tex[sy * t:sy * t + H, sx * t:sx * t + W].astype(np.uint8)
            for t in range(n)]


def _cfg(base, **kw):
    c = base.clone()
    c.merge_from_file(os.path.join(REPO, 'config', 'default.yaml'))
    c.PATCHES_PER_FRAME = 8
    c.BUFFER_SIZE = 64
    c.MIXED_PRECISION = False
    # a short window so keyframe removals and pair retirement happen early
    c.REMOVAL_WINDOW = 8
    c.OPTIMIZATION_WINDOW = 6
    c.PATCH_LIFETIME = 5
    c.KEYFRAME_INDEX = 2
    for k, v in kw.items():
        c[k] = v
    return c


def _run_jax(frames, force_accept, **kw):
    vo = JaxDeviceVO(_cfg(jax_cfg, **kw), NPZ, ht=H, wd=W, seed=0)
    vo._static['force_accept'] = force_accept
    for t, img in enumerate(frames):
        vo(t, img, INTR)
    n, counter = int(fetch(vo.st.n)), int(fetch(vo.st.counter))
    poses, _ = vo.terminate()
    return poses, n, counter, vo.colors()


def _run_torch(frames, force_accept, **kw):
    vo = TorchDPVO(_cfg(torch_cfg, **kw), NPZ, ht=H, wd=W, seed=0,
                   device='cpu')
    vo.force_accept = force_accept
    for t, img in enumerate(frames):
        vo(t, img, INTR)
    n, counter = vo.n, int(vo.st.counter)
    poses, tstamps = vo.terminate()
    assert np.array_equal(tstamps, np.arange(len(frames)))
    pts = vo.point_cloud()
    assert pts.shape == (n * vo.M, 3) and np.isfinite(pts).all()
    clr = vo.colors()
    assert clr.shape == (n, vo.M, 3) and clr.dtype == np.uint8
    return poses, n, counter, clr


def _check_slice(mixed):
    frames = _frames(16)
    jp, jn, jc, jclr = _run_jax(frames, True, MIXED_PRECISION=mixed)
    tp, tn, tc, tclr = _run_torch(frames, True, MIXED_PRECISION=mixed)
    assert (tn, tc) == (jn, jc)
    assert tn <= 16 - 4                   # keyframes were removed
    assert np.isfinite(tp).all() and tp.shape == (16, 7)
    np.testing.assert_allclose(tp, jp, rtol=0,
                               atol=POSE_TOL_BF16 if mixed else POSE_TOL)
    assert np.abs(tp[:, :3]).max() > 1e-2          # the camera moved
    # colors(): the live keyframes' patch colors, channels reversed; the
    # float color may land on either side of an integer before the cast
    assert np.abs(tclr.astype(int) - jclr).max() <= 1


def test_whole_slice_matches_jax():
    _check_slice(mixed=False)


@pytest.mark.parametrize('n', [287, 288])
def test_median_matches_jnp(n):
    """jnp.median averages the two middle values of an even count;
    torch.median would return the lower one."""
    import jax.numpy as jnp
    import torch
    from dpvo_torch.runtime.device_vo import _median
    x = np.random.RandomState(n).rand(n).astype(np.float32)
    assert float(_median(torch.from_numpy(x))) == float(jnp.median(x))


SHIFTED = ('poses', 'tstamps', 'colors', 'centers', 'fslot', 'depth')


@pytest.mark.parametrize('rm', [True, False])
@pytest.mark.parametrize('n, k', [(6, 2), (6, 5), (64, 60), (64, 63)])
def test_keyframe_removal_shifts_whole_frames(n, k, rm):
    """Removing keyframe k moves every per-frame row after it down by one
    frame, depth included (reference dpvo.py keyframe removal moves whole
    patch rows). dpvo_tpu's flat depth buffer is rolled by one element
    instead (runtime/device_vo.py:257), so depths after a removal differ
    between the packages; the whole-slice test compares poses.

    _shift_frames takes k, n and rm as device scalars and rewrites only
    the span = 4 rows from k; held here against a whole-buffer shift on
    the host, with rm true and false, k at both ends of the window (n - k
    = span, and n - k = 1, where nothing moves), at the buffer's start and
    at its end (n = BUFFER_SIZE = 64, where the window is clamped)."""
    import torch
    from dpvo_torch.runtime.device_vo import _shift_frames, init_state
    c = _cfg(torch_cfg)
    M, N, span = c.PATCHES_PER_FRAME, c.BUFFER_SIZE, 4
    st = init_state(c, H, W, INTR, 'cpu', torch.float32)
    rng = np.random.RandomState(n + k)
    for name in SHIFTED:
        buf = getattr(st, name)
        buf.copy_(torch.from_numpy(rng.permutation(buf.numel()).reshape(
            buf.shape)))
    before = {name: getattr(st, name).numpy().copy() for name in SHIFTED}
    _shift_frames(st, torch.tensor(k), torch.tensor(n), torch.tensor(rm), M,
                  span)
    for name in SHIFTED:
        want = before[name].reshape(N, -1).copy()
        if rm:
            want[k:n - 1] = want[k + 1:n]
        np.testing.assert_array_equal(
            getattr(st, name).numpy().reshape(N, -1), want, err_msg=name)
    if (n, k) == (6, 2):
        moved = st.fslot[:n].tolist()
        assert moved == before['fslot'][[0, 1, 3, 4, 5, 5] if rm else
                                        list(range(n))].tolist()


def test_device_vo_signature_and_viz(tmp_path, monkeypatch):
    """DeviceVO takes viz fifth, as dpvo_tpu's does; viz=True builds the
    headless viewer (viz/viewer.py), which terminate() joins. A viewer that
    fails to start raises: dpvo_tpu warns and runs on without one."""
    import inspect
    from dpvo_torch.runtime import DeviceVO
    from dpvo_torch.viz import viewer
    assert list(inspect.signature(DeviceVO).parameters) == [
        'cfg', 'network', 'ht', 'wd', 'viz', 'seed', 'device']
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv('DISPLAY', raising=False)
    vo = DeviceVO(_cfg(torch_cfg), NPZ, H, W, True, device='cpu')
    assert isinstance(vo.viewer, viewer.Viewer) and not vo.viewer.live
    vo(0, _frames(1)[0], INTR)
    vo.terminate()
    assert not vo.viewer.thread.is_alive()
    assert (tmp_path / 'viewer_out' / 'frame_000000.jpg').exists()

    def broken(*args, **kwargs):
        raise PermissionError('viewer_out is not writable')
    monkeypatch.setattr(viewer, 'Viewer', broken)
    with pytest.raises(PermissionError, match='viewer_out'):
        DeviceVO(_cfg(torch_cfg), NPZ, H, W, True, device='cpu')


def test_buffer_guard():
    """BUFFER_SIZE bounds keyframes: with removal off (threshold 0) the
    runtime refuses the frame that would overflow it."""
    vo = TorchDPVO(_cfg(torch_cfg, BUFFER_SIZE=8, KEYFRAME_THRESH=0.0), NPZ,
                   ht=H, wd=W, seed=0, device='cpu')
    vo.force_accept = True
    frames = _frames(8)
    with pytest.raises(RuntimeError, match='buffer size'):
        for t, img in enumerate(frames):
            vo(t, img, INTR)
    assert vo.n == 6


@pytest.mark.parametrize('key, value, ported', [
    ('LOOP_CLOSURE', True, True), ('CLASSIC_LOOP_CLOSURE', True, True),
    ('CENTROID_SEL_STRAT', 'GRADIENT_BIAS', True)])
def test_hybrid_configs_not_ported(key, value, ported):
    """Configs that are not pure VO go to the hybrid runtime: GRADIENT_BIAS
    centroids and both loop closures are ported."""
    from dpvo_torch.runtime import HybridVO
    c = _cfg(torch_cfg, **{key: value})
    if ported:
        vo = TorchDPVO(c, NPZ, ht=H, wd=W, device='cpu')
        assert isinstance(vo, HybridVO)
        if vo.long_term_lc is not None:
            vo.long_term_lc.close()
        return
    with pytest.raises(NotImplementedError, match='ROADMAP.md'):
        TorchDPVO(c, NPZ, ht=H, wd=W, device='cpu')
