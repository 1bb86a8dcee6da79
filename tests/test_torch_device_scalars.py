"""The pure-VO state machine reads nothing back after the bootstrap frame.

DeviceVO keeps the keyframe count, the input counter and the init flag as
tensors on its device and decides the motion model, the depth init, the
slot allocation, the pair append and the keyframe removal there
(runtime/device_vo.py). On a GPU a read of a device value syncs the host
with the card; on the CPU the same reads go through the Tensor methods
below, so the test counts their calls, and from the bootstrap frame on
makes each of them raise: bool(), operator.index() (slices, range),
int(), float(), .item(), .tolist(), .numpy(), .cpu().

Each case runs 20 frames of 64x96 (test_torch_runtime.py's config, micro
weights, the motion probe forced; BUFFER_SIZE 64, so the keyframe guard
never reads): frames 0-7 up to the bootstrap, counted, then frames 8-19
under the raising methods, one by one through __call__ or in chunks of 4
through track_frames. The window holds at least 2 keyframe removals and
one update iteration per frame, whose correlation (or oracle) call is
counted. Cases: K1's plain version (onepass), K2 + K3's (fused; their
D_MIN gate lowered so that they run at this size, where DeviceVO would
take the exact correlation), and the target oracle of the accuracy tests
(accuracy.plane_oracle on its plane scene, with removals in its dwell).

One read is not the state machine's: K1's plain version (ops/corr.py),
which stands in for the kernel on the CPU only, reads the live-edge count
nv to slice the live edges. K1 takes nv as a 0-d device tensor and reads
it on the card (ops/corr_onepass.py), so reads inside the plain version
are let through; chip_smoke.py's phases 4, 6 and 9 count the card's syncs.

Before initialization the host follows the keyframe count itself: with
the probe forced no frame reads, and without it each frame after the
first reads one value, the probe's accept decision (test_pre_init_reads;
the micro weights reject every frame).
"""
import numpy as np
import pytest
import torch

from dpvo_torch import accuracy as acc
from dpvo_torch.config import cfg as torch_cfg
from dpvo_torch.ops import corr_fused, corr_onepass
from dpvo_torch.runtime import DeviceVO
from test_torch_runtime import H, INTR, NPZ, W, _cfg, _frames, \
    one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')
READS = ('__bool__', '__index__', '__int__', '__float__', 'item', 'tolist',
         'numpy', 'cpu')
FRAMES, BOOT, CHUNK = 20, 8, 4


class Reads:
    """Counts the calls of the Tensor methods that read a value back; with
    `strict` set, each call raises instead. Calls inside a function
    wrapped by `let_through` are neither counted nor refused."""

    def __init__(self, monkeypatch):
        self.n = 0
        self.strict = False
        self._through = 0
        for name in READS:
            monkeypatch.setattr(torch.Tensor, name, self._wrap(
                name, getattr(torch.Tensor, name)))

    def _wrap(self, name, orig):
        def read(t, *args, **kwargs):
            if not self._through:
                if self.strict:
                    raise AssertionError(f'Tensor.{name} read a value back')
                self.n += 1
            return orig(t, *args, **kwargs)
        return read

    def let_through(self, fn):
        def through(*args, **kwargs):
            self._through += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self._through -= 1
        return through


def _counting(monkeypatch, module, name, counts):
    """Wrap module.name so that each call adds one to counts[name]."""
    orig = getattr(module, name)

    def counted(*args, **kwargs):
        counts[name] = counts.get(name, 0) + 1
        return orig(*args, **kwargs)
    monkeypatch.setattr(module, name, counted)


def _runtime(case, monkeypatch, counts, reads):
    """(DeviceVO, frames, intrinsics) of one case, its correlation or
    oracle calls counted in `counts`, K1's plain version let through by
    `reads`."""
    if case == 'oracle':
        H_, W_ = acc.ORACLE_HW
        vo = DeviceVO(acc.oracle_cfg(0.8), None, H_, W_, seed=3,
                      device='cpu')
        oracle = acc.plane_oracle(acc.plane_gt_poses(FRAMES, dwell=(10, 17)))

        def counted(*args):
            counts['oracle'] = counts.get('oracle', 0) + 1
            return oracle(*args)
        vo._oracle = counted
        vo.rng = acc.ConstDepthRng(vo.rng)
        rng = np.random.RandomState(1)
        frames = [rng.randint(0, 255, (H_, W_, 3), np.uint8)
                  for _ in range(FRAMES)]
        intr = acc.ORACLE_INTR
    else:
        if case == 'fused':
            monkeypatch.setenv('DPVO_CORR_IMPL', 'fused')
            monkeypatch.setattr(corr_fused, 'D_MIN', 1)
            _counting(monkeypatch, corr_fused, 'planes_plain', counts)
            _counting(monkeypatch, corr_fused, 'select_plain', counts)
        monkeypatch.setattr(corr_onepass, '_plain_two_level',
                            reads.let_through(corr_onepass._plain_two_level))
        _counting(monkeypatch, corr_onepass, '_plain_two_level', counts)
        vo = DeviceVO(_cfg(torch_cfg), NPZ, ht=H, wd=W, seed=0,
                      device='cpu')
        frames, intr = _frames(FRAMES), INTR
    vo.force_accept = True
    return vo, frames, intr


def _feed(vo, frames, t0, intr, chunk):
    """Frames t0.. through __call__ (chunk None) or track_frames."""
    if chunk is None:
        for t, img in enumerate(frames, t0):
            vo(t, img, intr)
    else:
        for s in range(0, len(frames), chunk):
            vo.track_frames(list(range(t0 + s, t0 + s + chunk)),
                            np.stack(frames[s:s + chunk]), intr)


# the plain versions each update iteration calls once (K3: once per level)
PER_ITERATION = {'onepass': {'_plain_two_level': 1},
                 'fused': {'planes_plain': 1, 'select_plain': 2},
                 'oracle': {'oracle': 1}}


@pytest.mark.parametrize('chunk', [None, CHUNK])
@pytest.mark.parametrize('case', ['onepass', 'fused', 'oracle'])
def test_steady_state_reads_nothing(case, chunk, monkeypatch):
    counts = {}
    reads = Reads(monkeypatch)
    vo, frames, intr = _runtime(case, monkeypatch, counts, reads)
    _feed(vo, frames[:BOOT], 0, intr, chunk)
    assert reads.n == 0                   # the probe is forced: no read
    assert vo.st.host_n is None           # the bootstrap frame ran
    counts.clear()
    reads.strict = True
    _feed(vo, frames[BOOT:], BOOT, intr, chunk)
    reads.strict = False
    steady = FRAMES - BOOT
    assert counts == {k: v * steady for k, v in PER_ITERATION[case].items()}
    n = vo.n
    assert FRAMES - n >= 2                # keyframes removed in the window
    assert int(vo.st.counter) == FRAMES
    assert torch.isfinite(vo.st.poses[:n]).all()
    assert torch.isfinite(vo.st.depth[:n * vo.M]).all()


@pytest.mark.parametrize('force_accept', [True, False])
def test_pre_init_reads(force_accept, monkeypatch):
    vo = DeviceVO(_cfg(torch_cfg), NPZ, ht=H, wd=W, seed=0, device='cpu')
    vo.force_accept = force_accept
    reads = Reads(monkeypatch)
    monkeypatch.setattr(corr_onepass, '_plain_two_level',
                        reads.let_through(corr_onepass._plain_two_level))
    per_frame = []
    for t, img in enumerate(_frames(BOOT)):
        n0 = reads.n
        vo(t, img, INTR)
        per_frame.append(reads.n - n0)
    if force_accept:
        assert per_frame == [0] * BOOT and vo.st.host_n is None
    else:
        assert per_frame == [0] + [1] * (BOOT - 1)
        assert vo.st.host_n == 1          # every probe rejected its frame
    assert vo.n == (BOOT if force_accept else 1)
