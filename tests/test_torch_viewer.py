"""The viewer, the writers and the readers: dpvo_torch's copies against
dpvo_tpu's on the same numpy inputs, made from a seed (no JAX compiles).

Tolerances: the writers (save_ply, save_output_for_COLMAP,
save_trajectory_tum_format, save_html_viewer) write byte-identical files;
the headless viewers write the same set of files and equal ply bytes; the
readers (image_stream, video_stream, the TUM and EuRoC trajectory readers)
give equal arrays, exactly."""
import os
import queue
import time

import cv2
import numpy as np
import pytest

from dpvo_torch import evaluation as tev
from dpvo_torch import plot_utils as tplot
from dpvo_torch import stream as tstream
from dpvo_torch.viz import html_viewer as thtml
from dpvo_torch.viz import viewer as tviewer
from dpvo_tpu import evaluation as jev
from dpvo_tpu import plot_utils as jplot
from dpvo_tpu import stream as jstream
from dpvo_tpu.viz import html_viewer as jhtml
from dpvo_tpu.viz import viewer as jviewer


def _snapshot(seed=0, n=12, m=300):
    """World-from-camera poses (n, 7) with unit quaternions, points (m, 3)
    in front of them, uint8 colors (m, 3), timestamps (n,)."""
    rng = np.random.RandomState(seed)
    q = rng.randn(n, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    poses = np.concatenate([np.cumsum(0.1 * rng.randn(n, 3), 0), q],
                           1).astype(np.float32)
    pts = (rng.randn(m, 3) + [0, 0, 3]).astype(np.float32)
    clr = rng.randint(0, 255, (m, 3)).astype(np.uint8)
    return poses, pts, clr, np.arange(n, dtype=np.float64) * 0.05


def _write_ply(mod, d, poses, pts, clr, traj):
    mod.save_ply(str(d / 'c.ply'), pts, clr)


def _write_colmap(mod, d, poses, pts, clr, traj):
    mod.save_output_for_COLMAP(str(d / 'colmap'), traj, pts, clr,
                               320.0, 321.0, 160.5, 120.5, H=240, W=320)


def _write_tum(mod, d, poses, pts, clr, traj):
    ev = tev if mod is tplot else jev
    ev.save_trajectory_tum_format(traj, str(d / 't.txt'))


def _write_html(mod, d, poses, pts, clr, traj):
    html = thtml if mod is tplot else jhtml
    html.save_html_viewer(str(d / 'v.html'), poses, pts, clr, title='run')


def _files(d):
    return {p.relative_to(d).as_posix(): p.read_bytes()
            for p in sorted(d.rglob('*')) if p.is_file()}


@pytest.mark.parametrize('write', [_write_ply, _write_colmap, _write_tum,
                                   _write_html],
                         ids=['ply', 'colmap', 'tum', 'html'])
def test_writers_byte_identical(write, tmp_path):
    poses, pts, clr, ts = _snapshot()
    out = {}
    for name, mod, ev in (('torch', tplot, tev), ('tpu', jplot, jev)):
        d = tmp_path / name
        d.mkdir()
        write(mod, d, poses, pts, clr, ev.poses_to_trajectory(poses, ts))
        out[name] = _files(d)
    assert out['torch'] and all(out['torch'].values())
    assert out['torch'] == out['tpu']


def test_headless_viewers_write_the_same_files(tmp_path):
    """Both viewers, fed the same frames, state snapshot and cloud, each
    push once the queue is empty (dpvo_tpu's viewer drops a cloud pushed
    into a full queue): the same file names (jpg frame, 3D render, html,
    ply) and equal ply bytes."""
    os.environ['MPLBACKEND'] = 'Agg'
    poses, pts, clr, _ = _snapshot(1)
    rng = np.random.RandomState(2)
    imgs = rng.randint(0, 255, (3, 48, 64, 3)).astype(np.uint8)
    files = {}
    for name, mod in (('torch', tviewer), ('tpu', jviewer)):
        d = tmp_path / name
        v = mod.Viewer(outdir=str(d), live=False)

        def settle():
            deadline = time.time() + 60
            while not v.q.empty() and time.time() < deadline:
                time.sleep(0.05)
        for img in imgs:
            v.update_image(img)
            settle()
        v.update_state(poses, pts, clr.astype(np.float32))
        settle()
        v.update_points(pts, clr)
        settle()
        v.join()
        assert not v.thread.is_alive()
        files[name] = _files(d)
    assert set(files['torch']) == set(files['tpu'])
    assert {'frame_000000.jpg', 'cloud.ply', 'viewer.html',
            'traj3d_000000.png'} <= set(files['torch'])
    assert files['torch']['cloud.ply'] == files['tpu']['cloud.ply']


def test_viewer_join_waits_for_a_slow_render(tmp_path, monkeypatch):
    """join() stops the render thread only after everything queued before
    it: a 3D render slower than the old 5 s drain (a first matplotlib
    import on a loaded host) no longer drops the final cloud."""
    monkeypatch.setattr(tviewer.Viewer, '_render_3d',
                        lambda self, *a: time.sleep(6))
    v = tviewer.Viewer(outdir=str(tmp_path), live=False)
    pts, clr = np.zeros((4, 3), np.float32), np.zeros((4, 3), np.uint8)
    v.update_state(np.zeros((2, 7), np.float32), pts, clr)
    v.update_points(pts, clr)
    v.join()
    assert not v.thread.is_alive()
    assert (tmp_path / 'cloud.ply').exists()


def test_viewer_update_points_waits_for_room(tmp_path):
    """The cloud is pushed once at the end of a run: with the queue full of
    frames it waits for the render thread instead of being dropped."""
    v = tviewer.Viewer(outdir=str(tmp_path), live=False)
    img = np.zeros((16, 16, 3), np.uint8)
    for _ in range(8):
        v.update_image(img)
    pts, clr = np.zeros((4, 3), np.float32), np.zeros((4, 3), np.uint8)
    v.update_points(pts, clr)
    v.join()
    assert (tmp_path / 'cloud.ply').exists()


def test_plot_trajectory_writes_a_pdf(tmp_path):
    poses, _, _, ts = _snapshot(3)
    est = tev.poses_to_trajectory(poses, ts)
    gt = tev.poses_to_trajectory(poses * [2, 2, 2, 1, 1, 1, 1], ts)
    path = tmp_path / 'plots' / 'p.pdf'
    tplot.plot_trajectory(est, gt, title='t', filename=str(path))
    assert path.read_bytes()[:4] == b'%PDF' and path.stat().st_size > 1000


def _image_dir(d, n=5, H=70, W=100):
    """n PNG frames whose sizes are not multiples of 16 (the reader
    crops), and a jpg, which the reader also lists."""
    rng = np.random.RandomState(4)
    d.mkdir()
    for t in range(n):
        ext = 'jpg' if t == 2 else 'png'
        cv2.imwrite(str(d / f'{t:06d}.{ext}'),
                    rng.randint(0, 255, (H, W, 3)).astype(np.uint8))
    return d


def _drain(reader, *args):
    q = queue.Queue()
    reader(q, *args)
    out = []
    while not q.empty():
        out.append(q.get())
    return out


def _assert_same_items(a, b):
    assert len(a) == len(b) > 1 and a[-1][0] == b[-1][0] == -1
    for (ta, ia, ka), (tb, ib, kb) in zip(a, b):
        assert ta == tb
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(ka, kb)


@pytest.mark.parametrize('calib', ['60.0 61.0 48.0 32.0',
                                   '60.0 61.0 48.0 32.0 -0.2 0.05 0.001 '
                                   '0.0005'],
                         ids=['pinhole', 'distorted'])
@pytest.mark.parametrize('stride, skip', [(1, 0), (2, 1)])
def test_image_stream_matches(calib, stride, skip, tmp_path):
    d = _image_dir(tmp_path / 'seq')
    cpath = tmp_path / 'calib.txt'
    cpath.write_text(calib)
    got = _drain(tstream.image_stream, str(d), str(cpath), stride, skip)
    want = _drain(jstream.image_stream, str(d), str(cpath), stride, skip)
    _assert_same_items(got, want)
    assert got[0][1].shape == (64, 96, 3)


def test_video_stream_matches(tmp_path):
    """A video read at half size (intrinsics halved), stride 2."""
    path = str(tmp_path / 'v.avi')
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*'MJPG'), 10,
                         (200, 140))
    assert vw.isOpened(), 'cv2 cannot write an MJPG avi here'
    rng = np.random.RandomState(5)
    for _ in range(7):
        vw.write(rng.randint(0, 255, (140, 200, 3)).astype(np.uint8))
    vw.release()
    cpath = tmp_path / 'calib.txt'
    cpath.write_text('100.0 101.0 100.0 70.0 -0.1 0.01 0.0 0.0')
    got = _drain(tstream.video_stream, path, str(cpath), 2, 1)
    want = _drain(jstream.video_stream, path, str(cpath), 2, 1)
    _assert_same_items(got, want)
    assert got[0][1].shape == (64, 96, 3)


def test_trajectory_readers_agree(tmp_path):
    poses, _, _, ts = _snapshot(6)
    tum = tmp_path / 'traj.txt'
    tev.save_trajectory_tum_format(tev.poses_to_trajectory(poses, ts + 1e3),
                                   str(tum))
    rng = np.random.RandomState(7)
    csv = tmp_path / 'data.csv'
    rows = np.concatenate([(1e18 + 5e7 * np.arange(9))[:, None],
                           rng.randn(9, 7), rng.randn(9, 9)], 1)
    np.savetxt(csv, rows, delimiter=',', header='#timestamp,...',
               comments='')
    for got, want in ((tev.read_tum_trajectory_file(str(tum)),
                       jev.read_tum_trajectory_file(str(tum))),
                      (tev.read_euroc_csv_trajectory(str(csv)),
                       jev.read_euroc_csv_trajectory(str(csv)))):
        for key in ('positions_xyz', 'orientations_quat_wxyz', 'timestamps'):
            np.testing.assert_array_equal(getattr(got, key),
                                          getattr(want, key))
    np.testing.assert_allclose(
        tev.read_tum_trajectory_file(str(tum)).positions_xyz, poses[:, :3],
        rtol=1e-6)


def test_timer_records_the_section(capsys):
    from dpvo_torch.utils import Timer, all_times
    before = len(all_times)
    with Timer('section', device='cpu'):
        time.sleep(0.01)
    with Timer('off', enabled=False, device='cpu'):
        pass
    assert len(all_times) == before + 1 and all_times[-1] >= 10.0
    assert capsys.readouterr().out.startswith('section ')
