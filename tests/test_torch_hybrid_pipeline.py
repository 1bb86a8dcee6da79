"""HybridVO with MIRROR_PIPELINE > 1: dpvo_torch against dpvo_tpu on the
CPU (the read-back handle it rests on: test_torch_transfer.py).

At MIRROR_PIPELINE = k up to k frames' packed mirrors are in flight; a call
reads the oldest back only when k are, then runs its keyframe test, the
viewer push and the classic backend's turn. A keyframe removal applies
every mirror in flight first and drops their keyframe tests
(dpvo_tpu/runtime/dpvo.py:645-660), so at k > 1 the run keeps keyframes
that the synchronous one removes (12 of 16 at k = 2 on these frames,
against 8).

The runs are test_torch_hybrid.py's (64x96 texture, micro weights, f32,
GRADIENT_BIAS, the probe forced). dpvo_tpu's keyframe removal rolls its
flat patch_xy / depth buffers by one patch instead of one frame
(runtime/state.py:261-262, :305-306; ROADMAP.md §3), which moves the
trajectories by up to ~0.8 on 24 frames here. So the port is held to a
dpvo_tpu whose removal moves whole frames, patched in this process
(shift_frames and _shift_frames_impl; its files stay as they are), which
isolates the pipeline: the same keyframe count, input frame count,
keyframe timestamps and terminate() timestamps, poses within 1e-4 (the
f32 sums run in another order: measured up to 3.8e-6). Run as a script,
the file prints each case's keyframes and its distance to both dpvo_tpus
(python tests/test_torch_hybrid_pipeline.py); the distance to dpvo_tpu
as it is is not held.

The hook order is recorded with stub hooks on both sides: each drained
frame's keyframe test, removals, viewer pushes and the classic backend's
calls, in order.
"""
import contextlib
import os
import sys
from functools import partial

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]   # as a script: repo, tests

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpvo_torch.config import cfg as torch_cfg
from dpvo_torch.runtime import DPVO as TorchDPVO
from dpvo_torch.runtime import HybridVO
from dpvo_tpu.config import cfg as jax_cfg
from dpvo_tpu.runtime import DPVO as JaxDPVO
from dpvo_tpu.runtime import dpvo as jdpvo
from dpvo_tpu.runtime import state as jstate
from test_torch_runtime import H, INTR, NPZ, W, _cfg, _frames, torch_threads

PIPE_TOL = 1e-4


def _whole_frame_impl(orig):
    """dpvo_tpu's _shift_frames_impl with patch_xy and depth moved by a
    whole frame (M rows) over [k M, (n - 1) M), as the port does."""
    def impl(poses, patch_xy, depth, intr, imap, gmap, fmap1, fmap2, k, n,
             M, pmem, mem):
        out = list(orig(poses, patch_xy, depth, intr, imap, gmap, fmap1,
                        fmap2, k, n, M, pmem, mem))
        for i, buf in ((1, patch_xy), (2, depth)):
            idx = jnp.arange(buf.shape[0])
            live = (idx >= k * M) & (idx < (n - 1) * M)
            out[i] = jnp.where(live.reshape((-1,) + (1,) * (buf.ndim - 1)),
                               jnp.roll(buf, -M, axis=0), buf)
        return tuple(out)
    return impl


@contextlib.contextmanager
def whole_frame_shift():
    """dpvo_tpu's keyframe removal moving whole frames, in this process.
    jax's caches are cleared around it, so that no compiled frame_step
    outlives the patch."""
    orig_impl, orig_shift = jstate._shift_frames_impl, jdpvo.shift_frames
    impl = _whole_frame_impl(orig_impl)

    @partial(jax.jit, static_argnames=('M', 'pmem', 'mem'))
    def shift(poses, patch_xy, depth, intr, imap, gmap, fmap1, fmap2, k, n,
              *, M, pmem, mem):
        return impl(poses, patch_xy, depth, intr, imap, gmap, fmap1, fmap2,
                    k, n, M, pmem, mem)

    jax.clear_caches()
    jstate._shift_frames_impl, jdpvo.shift_frames = impl, shift
    try:
        yield
    finally:
        jstate._shift_frames_impl, jdpvo.shift_frames = orig_impl, orig_shift
        jax.clear_caches()


class Hooks:
    """Stub viewer and classic backend that record, with the keyframe
    test, what runs when: (event, keyframe count, input frame count)."""

    def __init__(self, vo):
        self.vo, self.log = vo, []
        keyframe = vo.keyframe

        def test():
            self._rec('keyframe test')
            keyframe()
        vo.keyframe = test
        vo.viewer = self
        vo.cfg.CLASSIC_LOOP_CLOSURE = True
        vo.long_term_lc = self

    def _rec(self, event, *args):
        self.log.append((event, self.vo.n, self.vo.counter) + args)

    def update_image(self, image):
        self._rec('image')

    def update_state(self, poses, points, colors):
        self._rec('viewer push')

    def join(self):
        self._rec('join')

    def __call__(self, image, n):
        self._rec('retrieval', n)

    def keyframe(self, k):
        self._rec('removal', k)

    def attempt_loop_closure(self, n):
        self._rec('attempt', n)

    def lc_callback(self):
        self._rec('callback')

    def terminate(self, n):
        self._rec('lc terminate', n)


def _run(build, base, k, T):
    vo = build(_cfg(base, CENTROID_SEL_STRAT='GRADIENT_BIAS',
                    MIRROR_PIPELINE=k), NPZ, ht=H, wd=W, seed=0)
    vo.motion_probe = lambda: 100.0
    hooks = Hooks(vo)
    for t, img in enumerate(_frames(T)):
        vo(t, img, INTR)
    poses, tstamps = vo.terminate()
    return dict(vo=vo, poses=poses, tstamps=tstamps, log=hooks.log)


CASES = [(2, 16), (2, 24), (3, 16)]


def make_runs(raw=False):
    """{case: [port, dpvo_tpu with the whole-frame shift (, dpvo_tpu as it
    is)]}."""
    out = {}
    with torch_threads(2):
        for case in CASES:
            out[case] = [_run(lambda *a, **kw: TorchDPVO(*a, device='cpu',
                                                         **kw),
                              torch_cfg, *case)]
        with whole_frame_shift():
            for case in CASES:
                out[case].append(_run(JaxDPVO, jax_cfg, *case))
        for case in CASES if raw else ():
            out[case].append(_run(JaxDPVO, jax_cfg, *case))
    return out


@pytest.fixture(scope='module')
def runs():
    return make_runs()


@pytest.mark.parametrize('k, T', CASES)
def test_pipeline_matches_dpvo_tpu(runs, k, T):
    t, j = runs[k, T]
    tv, jv = t['vo'], j['vo']
    assert isinstance(tv, HybridVO) and tv._pipeline == k
    assert (tv.n, tv.counter, tv.m) == (jv.n, jv.counter, jv.m)
    np.testing.assert_array_equal(tv.tstamps_[:tv.n], jv.tstamps_[:jv.n])
    np.testing.assert_array_equal(t['tstamps'], j['tstamps'])
    assert np.isfinite(t['poses']).all() and t['poses'].shape == (T, 7)
    err = float(np.abs(t['poses'] - j['poses']).max())
    assert err <= PIPE_TOL, err
    if (k, T) == (2, 16):
        assert tv.n == 12               # 8 at MIRROR_PIPELINE=1
    assert np.abs(t['poses'][:, :3]).max() > 1e-2      # the camera moved


def test_hook_order_matches_dpvo_tpu(runs):
    """k = 2: the keyframe tests, removals, viewer pushes and the classic
    backend's calls run in dpvo_tpu's order, at the same keyframe and
    input frame counts."""
    t, j = runs[2, 16]
    assert t['log'] == j['log']
    events = [e[0] for e in t['log']]
    for event in ('keyframe test', 'removal', 'viewer push', 'attempt',
                  'callback', 'lc terminate', 'join'):
        assert event in events, event
    # each keyframe test (and its removal) is followed by the push (when
    # n % 3 == 0), then the classic backend's turn
    for i, event in enumerate(events):
        if event == 'keyframe test':
            after = [e for e in events[i + 1:i + 5] if e != 'removal']
            assert after[:2] in (['attempt', 'callback'],
                                 ['viewer push', 'attempt']), after


def test_pgo_result_lands_after_the_mirrors_in_flight():
    """A pose-graph result applied with two mirrors in flight (k = 2):
    apply_pgo_result applies them first, so the host mirrors follow the
    device rows it wrote, and their keyframe tests still run, at their
    drains. (dpvo_tpu applies the result with the mirrors still in flight,
    which then land over the fresh rows: ROADMAP.md §3.)"""
    from dpvo_torch.loop_closure.pgo import apply_pgo_result, se3_to_sim3
    from dpvo_torch.runtime import numpy_se3 as nse3
    vo = HybridVO(_cfg(torch_cfg, CENTROID_SEL_STRAT='GRADIENT_BIAS',
                       MIRROR_PIPELINE=2, KEYFRAME_THRESH=-1.0), NPZ, ht=H,
                  wd=W, seed=0, device='cpu')
    vo.motion_probe = lambda: 100.0
    tests = []
    keyframe = vo.keyframe

    def test():
        tests.append(vo.n)
        keyframe()
    vo.keyframe = test
    with torch_threads(2):
        for t, img in enumerate(_frames(11)):
            vo(t, img, INTR)
        assert len(vo._deferred) == 2 and all(
            e[0] is not None for e in vo._deferred)
        before = len(tests)
        safe_i = vo.n - 3
        apply_pgo_result(vo, se3_to_sim3(nse3.inv(vo.poses_np[:safe_i])))
        assert [e[0] for e in vo._deferred] == [None, None]
        np.testing.assert_array_equal(vo.poses_np, vo.st.poses.numpy())
        np.testing.assert_array_equal(vo.depth_np, vo.st.depth.numpy())
        assert vo.colors_np[vo.n - 1].any()     # the newest frame's colors
        vo._drain()
    assert len(tests) == before + 2 and not vo._deferred


if __name__ == '__main__':
    import conftest  # noqa: F401  (jax on the CPU)
    port = partial(TorchDPVO, device='cpu')
    cases = [(k, T) for T in (16, 24) for k in (1, 2)] + [(3, 16)]
    with torch_threads(2):
        got = {c: _run(port, torch_cfg, *c) for c in cases}
        raw = {c: _run(JaxDPVO, jax_cfg, *c) for c in cases}
        with whole_frame_shift():
            fixed = {c: _run(JaxDPVO, jax_cfg, *c) for c in cases}

    def d(a, b):
        return f'{np.abs(a["poses"] - b["poses"]).max():.3g}'
    print('k  frames  keyframes: port / dpvo_tpu / patched   max |pose '
          'difference|: port - dpvo_tpu, port - patched, dpvo_tpu - '
          'dpvo_tpu at k = 1')
    for k, T in cases:
        c = (k, T)
        print(f'{k}  {T:6d}  {got[c]["vo"].n:4d} / {raw[c]["vo"].n} / '
              f'{fixed[c]["vo"].n}   {d(got[c], raw[c])}, '
              f'{d(got[c], fixed[c])}, {d(raw[c], raw[1, T])}')
