"""Where the two DeviceVOs part at TartanAir's camera: the port and dpvo_tpu
frame by frame on the CPU in f32 (micro weights, M = 8, probe forced,
64x96 texture frames), with the evaluation protocol's fixed intrinsics
[320, 320, 320, 240], whose principal point lies far outside the frame.

After every frame the two states are compared: the keyframe count and
which input frames are keyframes (the keyframe decisions), the poses and
the patch depths.
- Against dpvo_tpu as it is, they agree to f32 noise until the first
  keyframe removal. There dpvo_tpu's _shift_frames rolls the flat depth
  buffer by one patch instead of one frame of M patches (ROADMAP.md §3),
  the depths part by O(1), and the poses drift apart from the next frame
  on.
- Against dpvo_tpu with only that line changed (a whole frame, patched in
  this process; dpvo_tpu's file stays as it is) they agree to f32 noise
  on every frame: no step of the port is at fault.

The test holds the second over 16 frames with removals: bounds 1e-5 on
the poses and 1e-4 on the depths after every frame (both sides run the
same f32 math in another order; measured ~2e-7 and ~1.3e-6 over 16
frames).

Run as a script for the per-frame table (python
tests/test_torch_tartan_drift.py [frames] [fx,fy,cx,cy]).
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]   # as a script: repo, tests

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from dpvo_torch.config import cfg as torch_cfg  # noqa: E402
from dpvo_torch.runtime import DeviceVO as TorchDeviceVO  # noqa: E402
from dpvo_tpu.config import cfg as jax_cfg  # noqa: E402
from dpvo_tpu.runtime import device_vo as jdv  # noqa: E402
from dpvo_tpu.runtime.device_driver import DeviceVO as JaxDeviceVO  # noqa
from test_torch_cli import _small_cfg, _texture_frames  # noqa: E402
from test_torch_runtime import NPZ, torch_threads  # noqa: E402

TARTAN = np.array([320.0, 320.0, 320.0, 240.0], np.float32)
H, W, M = 64, 96, 8


def _whole_frame_shift(orig):
    """dpvo_tpu's _shift_frames with the depth buffer rolled by one frame
    (M patches) over [k M, (n - 1) M), as the port and the reference do."""
    def shift(st, k, n, M, pmem, mem):
        depth = st.depth
        st = orig(st, k, n, M, pmem, mem)
        idx = jnp.arange(depth.shape[0])
        live = (idx >= k * M) & (idx < (n - 1) * M)
        st.depth = jnp.where(live, jnp.roll(depth, -M, axis=0), depth)
        return st
    return shift


def per_frame(T, intr, patched, final=False):
    """Both runtimes over T frames; one row per frame: (keyframe decisions
    equal, keyframe count, max |pose difference|, max |depth difference|).
    patched: dpvo_tpu's depth shift by a whole frame. final: also return
    the max |difference| of terminate()'s trajectories. jax's caches are
    cleared around the run, so no compiled vo_frame outlives the patch."""
    orig = jdv._shift_frames
    jax.clear_caches()
    if patched:
        jdv._shift_frames = _whole_frame_shift(orig)
    try:
        jv = JaxDeviceVO(_small_cfg(jax_cfg), NPZ, ht=H, wd=W)
        jv._static['force_accept'] = True
        tv = TorchDeviceVO(_small_cfg(torch_cfg), NPZ, ht=H, wd=W,
                           device='cpu')
        tv.force_accept = True
        rows = []
        for t, img in enumerate(_texture_frames(T, H=H, W=W)):
            jv(t, img, intr)
            tv(t, img, intr)
            js, ts = jv.st, tv.st
            n = int(np.asarray(js.n))
            same = n == int(ts.n) and np.array_equal(
                np.asarray(js.tstamps[:n]), ts.tstamps[:n].numpy())
            dp = np.abs(np.asarray(js.poses[:n]) - ts.poses[:n].numpy())
            dd = np.abs(np.asarray(js.depth[:n * M]) -
                        ts.depth[:n * M].numpy())
            rows.append((same, n, float(dp.max()), float(dd.max())))
        if not final:
            return rows
        return rows, float(np.abs(jv.terminate()[0] -
                                  tv.terminate()[0]).max())
    finally:
        jdv._shift_frames = orig
        jax.clear_caches()


def test_port_matches_dpvo_tpu_with_whole_frame_shift():
    """16 frames (bootstrap at 7, the first removal at 8, more after): the
    same keyframe decisions on every frame, poses and depths at f32 noise
    after every frame. The port's state machine keeps its scalars on the
    device and removes keyframes by a masked shift of whole frames; this
    holds it to dpvo_tpu's in-graph one. (dpvo_tpu as it is parts at frame
    8's depths: the script's table and test_torch_runtime.py::
    test_keyframe_removal_shifts_whole_frames.)"""
    with torch_threads(2):
        rows = per_frame(16, TARTAN, patched=True)
    n = [n for _, n, _, _ in rows]
    assert n[:10] == [1, 2, 3, 4, 5, 6, 7, 8, 8, 8]
    assert 16 - n[-1] >= 2                         # keyframes removed
    for t, (same, _, dp, dd) in enumerate(rows):
        assert same and dp < 1e-5 and dd < 1e-4, t


if __name__ == '__main__':
    import conftest  # noqa: F401  (jax on the CPU)
    T = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    intr = (np.array(sys.argv[2].split(','), np.float32)
            if len(sys.argv) > 2 else TARTAN)
    runs = {p: per_frame(T, intr, p, final=True) for p in (False, True)}
    print('frame  n  kf_equal  |dpose| |ddepth| (dpvo_tpu)  '
          '|dpose| |ddepth| (patched)')
    for t in range(T):
        (s0, n, p0, d0), (s1, _, p1, d1) = runs[False][0][t], runs[True][0][t]
        print(f'{t:5d} {n:2d}  {s0 and s1!s:8}  {p0:.2e} {d0:.2e}'
              f'             {p1:.2e} {d1:.2e}')
    print(f'terminate(): |dtrajectory| {runs[False][1]:.2e} (dpvo_tpu), '
          f'{runs[True][1]:.2e} (patched)')
