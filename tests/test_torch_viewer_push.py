"""The runtimes' viewer snapshots: dpvo_torch's DeviceVO and HybridVO under
viz=True against dpvo_tpu's, with a recording stub put in place of each
package's Viewer (monkeypatch; nothing in dpvo_tpu is edited). Same frames,
seed and weights (artifacts/micro_vonet.npz), f32, test_torch_runtime.py's
small config at 64x96, the motion probe forced (these weights never pass
it).

DeviceVO pushes every 10th frame and at terminate (one read-back each);
HybridVO pushes from its host mirrors after each keyframe test that leaves
a keyframe count divisible by 3. Both sides must push the same number of
snapshots of the same keyframe counts, and each snapshot's poses, points
and colors must agree within 1e-3 per component (f32 on both sides, sums
in another order; test_torch_runtime.py's bound), with one exception.

DeviceVO runs twice. 'DeviceVO_keep' keeps every keyframe (KEYFRAME_THRESH
0), so every point of every snapshot is held to dpvo_tpu's. 'DeviceVO'
runs test_torch_runtime.py's config, which removes a keyframe at every
frame after bootstrap. dpvo_tpu's removal rolls the flat depth buffer by
one element instead of one frame (ROADMAP.md queue 3,
dpvo_tpu/runtime/device_vo.py:257), which garbles the depths of the
keyframes from the removed one k = n - KEYFRAME_INDEX to the newest. There
those KEYFRAME_INDEX - 1 newest keyframes' points are not held to
dpvo_tpu's (they differ by up to ~24 here); poses, colors and the older
keyframes' points still are. HybridVO keeps every keyframe (KEYFRAME_THRESH
0): with a removal at every frame its keyframe count would stay at 8 and
never reach a multiple of 3, so it would push nothing."""
import numpy as np
import pytest

from dpvo_torch.config import cfg as torch_cfg
from dpvo_torch.runtime import DPVO as TorchDPVO
from dpvo_torch.runtime import DeviceVO as TorchDeviceVO
from dpvo_torch.runtime import HybridVO as TorchHybridVO
from dpvo_torch.viz import viewer as tviewer
from dpvo_tpu.config import cfg as jax_cfg
from dpvo_tpu.runtime import DPVO as JaxDPVO
from dpvo_tpu.runtime.device_driver import DeviceVO as JaxDeviceVO
from dpvo_tpu.viz import viewer as jviewer
from test_torch_runtime import (H, INTR, NPZ, W, _cfg, _frames,
                                torch_threads)

TOL = 1e-3


class RecordingViewer:
    """The Viewer's producer API, recording what the runtime pushes."""

    def __init__(self, *args, **kwargs):
        self.images = 0
        self.states = []
        self.joined = False

    def update_image(self, image):
        assert image.shape == (H, W, 3)
        self.images += 1

    def update_state(self, poses_wfc, points, colors):
        self.states.append(tuple(np.array(a, np.float32)
                                 for a in (poses_wfc, points, colors)))

    def join(self):
        self.joined = True


def _drive(vo, frames, force):
    force(vo)
    for t, img in enumerate(frames):
        vo(t, img, INTR)
    vo.terminate()
    assert vo.viewer.joined and vo.viewer.images == len(frames)
    return vo.viewer.states


def _force_device(vo):
    if isinstance(vo, TorchDeviceVO):
        vo.force_accept = True
    else:
        vo._static['force_accept'] = True


def _force_hybrid(vo):
    vo.motion_probe = lambda: 100.0


def _jax_device(c):
    return JaxDeviceVO(c(jax_cfg), NPZ, H, W, True, 0)


def _torch_device(c):
    return TorchDeviceVO(c(torch_cfg), NPZ, H, W, True, 0, device='cpu')


KEEP = dict(KEYFRAME_THRESH=0.0)
# DeviceVO is built directly (the DPVO constructor sends viz to HybridVO)
CASES = {
    'DeviceVO': (_jax_device, _torch_device, _force_device, {}),
    'DeviceVO_keep': (_jax_device, _torch_device, _force_device, KEEP),
    'HybridVO': (lambda c: JaxDPVO(c(jax_cfg), NPZ, H, W, viz=True, seed=0),
                 lambda c: TorchDPVO(c(torch_cfg), NPZ, H, W, viz=True,
                                     seed=0, device='cpu'),
                 _force_hybrid, KEEP),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_viewer_snapshots_match_jax(case, monkeypatch):
    build_jax, build_torch, force, kw = CASES[case]

    def cfg(base):
        return _cfg(base, **kw)
    monkeypatch.setattr(jviewer, 'Viewer', RecordingViewer)
    monkeypatch.setattr(tviewer, 'Viewer', RecordingViewer)
    frames = _frames(16)
    want = _drive(build_jax(cfg), frames, force)
    with torch_threads(2):
        vo = build_torch(cfg)
        assert type(vo).__name__ == case.split('_')[0]
        got = _drive(vo, frames, force)
    assert len(got) == len(want) >= 2
    M, kf_index = vo.M, vo.cfg.KEYFRAME_INDEX
    for g, w in zip(got, want):
        n = len(g[0])
        assert len(w[0]) == n and g[1].shape == (n * M, 3)
        # keyframes whose depths dpvo_tpu's removal garbles (docstring)
        garbled = kf_index - 1 if not kw else 0
        for name, a, b in zip(('poses', 'points', 'colors'), g, w):
            assert a.shape == b.shape, (name, a.shape, b.shape)
            assert np.isfinite(a).all(), name
            if name == 'points':
                a, b = a[:(n - garbled) * M], b[:(n - garbled) * M]
            np.testing.assert_allclose(a, b, atol=TOL, rtol=0,
                                       err_msg=f'{case} {name} n={n}')
    if case == 'DeviceVO':
        assert vo.n < len(frames)          # keyframes were removed
        np.testing.assert_allclose(got[-1][1], vo.point_cloud(), atol=1e-5,
                                   rtol=0)
    elif case == 'DeviceVO_keep':
        assert [len(g[0]) for g in got] == [10, 16]
    else:
        assert [len(g[0]) for g in got] == [9, 12, 15]


@pytest.mark.parametrize('runtime', [TorchDeviceVO, TorchHybridVO],
                         ids=['DeviceVO', 'HybridVO'])
def test_viewer_failure_to_start_raises(runtime, monkeypatch):
    """dpvo_tpu prints a warning and runs on without a viewer that fails to
    start; the port raises."""
    def broken(*args, **kwargs):
        raise OSError('no place for the viewer output')

    monkeypatch.setattr(tviewer, 'Viewer', broken)
    with pytest.raises(OSError, match='viewer output'):
        runtime(_cfg(torch_cfg), NPZ, H, W, viz=True, device='cpu')
