"""Multi-stream VO: dpvo_torch's MultiStreamVO on devices=['cpu', 'cpu']
against dpvo_tpu's on a 2-device slice of the CPU mesh, the same frames,
seed and weights (artifacts/micro_vonet.npz), f32, with
test_torch_runtime.py's small config.

Both draw the same host randoms in the same order (per stream a randint of
the coordinates, then one rand(B, M) of the seeds), so each stream sees the
same patches on both sides. Each stream watches its own crop of a moving
texture, 12 lockstep frames. Two runs:
  * through the motion probe: with these weights the probe rejects every
    pre-init frame on both sides (as test_torch_runtime_mixed.py's probe
    path shows for DeviceVO), so each stream keeps one keyframe;
  * with force_accept (the port's attribute; dpvo_tpu's vo_frame keyword,
    passed by wrapping the vo_frame its streams module calls): bootstrap at
    frame 8 (12 updates), then one update per frame and keyframe tests.

Tolerance: equal keyframe counts per stream and poses[:n] within 1e-3 per
component (test_torch_runtime.py's f32 bound: the same ops, f32 on both
sides, sums in another order). At 64x96 dpvo_tpu's portable correlation
takes the exact XLA path and the port its plain K1 version."""
import functools

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from dpvo_torch.config import cfg as torch_cfg
from dpvo_torch.parallel.streams import MultiStreamVO as TorchMultiStream
from dpvo_tpu.config import cfg as jax_cfg
from dpvo_tpu.parallel import streams as jax_streams
from dpvo_tpu.runtime import HybridVO as JaxHybridVO
from dpvo_tpu.runtime.device_vo import vo_frame as jax_vo_frame
from test_torch_runtime import H, INTR, NPZ, POSE_TOL, W, _cfg, torch_threads

B, T = 2, 12


def _stream_frames(seed=3, step=(3, 2)):
    """(T, B, H, W, 3): stream b sees the crop of one texture starting
    (0, 16 b) px in, moving `step` px per frame."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.RandomState(seed)
    sx, sy = step
    tex = gaussian_filter(rng.rand(H + sy * T, W + sx * T + 16 * B, 3),
                          (2, 2, 0))
    tex = ((tex - tex.min()) / np.ptp(tex) * 255).astype(np.uint8)
    return np.stack([np.stack([tex[sy * t:sy * t + H,
                                   sx * t + 16 * b:sx * t + 16 * b + W]
                               for b in range(B)]) for t in range(T)])


def _run_jax(frames, force_accept, monkeypatch):
    if force_accept:
        monkeypatch.setattr(jax_streams, 'vo_frame', functools.partial(
            jax_vo_frame, force_accept=True))
    holder = type('Weights', (), {})()
    JaxHybridVO.load_weights(holder, NPZ)
    mesh = Mesh(np.array(jax.devices()[:B]), ('dp',))
    mv = jax_streams.MultiStreamVO(_cfg(jax_cfg), holder.params, H, W, INTR,
                                   mesh=mesh)
    for t in range(T):
        mv(np.full(B, float(t)), frames[t])
    n = np.asarray(mv.states.n)
    poses = np.asarray(mv.states.poses)
    return [int(x) for x in n], [poses[b, :n[b]] for b in range(B)]


def _run_torch(frames, force_accept):
    with torch_threads(2):
        mv = TorchMultiStream(_cfg(torch_cfg), NPZ, H, W, INTR,
                              devices=['cpu', 'cpu'])
        mv.force_accept = force_accept
        for t in range(T):
            mv(np.full(B, float(t)), frames[t])
    assert len(mv.networks) == B and mv.networks[0] is mv.networks[1]
    n = [int(st.n) for st in mv.states]
    return mv, (n, [st.poses[:k].numpy().copy()
                    for st, k in zip(mv.states, n)])


@pytest.mark.parametrize('force_accept', [False, True],
                         ids=['probe', 'forced'])
def test_multistream_matches_jax(force_accept, monkeypatch):
    frames = _stream_frames()
    jn, jposes = _run_jax(frames, force_accept, monkeypatch)
    mv, (tn, tposes) = _run_torch(frames, force_accept)
    assert tn == jn, (tn, jn)
    if force_accept:
        assert all(n > 1 for n in tn), tn      # left bootstrap
    else:
        assert tn == [1] * B
    for b in range(B):
        assert np.isfinite(tposes[b]).all()
        np.testing.assert_allclose(tposes[b], jposes[b], atol=POSE_TOL,
                                   rtol=0)
    if force_accept:
        # the streams saw different crops, so they tracked apart
        assert not np.allclose(tposes[0], tposes[1], atol=1e-6)
        # each stream's DeviceVO ends as DeviceVO does: a pose per frame
        with torch_threads(2):
            out = mv.terminate()
        for poses, tstamps in out:
            assert poses.shape == (T, 7) and np.isfinite(poses).all()
            np.testing.assert_array_equal(tstamps, np.arange(T))


def test_default_devices_need_cuda():
    """With no devices given the port takes every visible CUDA device, as
    dpvo_tpu takes every device; a host without one raises rather than
    running on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default is valid here')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        TorchMultiStream(_cfg(torch_cfg), NPZ, H, W, INTR)
