"""The entry points: dpvo_torch.demo and the evaluation CLIs against the
root scripts, on small inputs written to tmp_path (no dataset is in the
repo), on the CPU.

* demo.run: the port's and the root's on one generated image directory
  (64x96, a calib file, stride 1, artifacts/micro_vonet.npz,
  MIXED_PRECISION False, BUFFER_SIZE 64, M = 8), each through its spawn
  reader process. These weights never pass the motion probe, so both runs
  build the runtime with it forced (each package's DPVO wrapped). Bound:
  trajectories within 1e-3 per component (test_torch_runtime.py's f32
  bound) and the same point count.
* python -m dpvo_torch.demo --device cpu with every writer, cwd=tmp_path.
The evaluation CLIs are in test_torch_eval_cli.py.
"""
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
from scipy.ndimage import gaussian_filter

import demo as root_demo
from dpvo_torch import demo as tdemo
from dpvo_torch.config import cfg as torch_cfg
from dpvo_tpu.config import cfg as jax_cfg
from test_torch_runtime import NPZ, POSE_TOL, REPO, torch_threads

H, W = 64, 96


def _texture_frames(n, H=H, W=W, seed=0, step=(3, 2)):
    rng = np.random.RandomState(seed)
    sx, sy = step
    tex = gaussian_filter(rng.rand(H + sy * n, W + sx * n, 3), (2, 2, 0))
    tex = ((tex - tex.min()) / np.ptp(tex) * 255).astype(np.uint8)
    return [tex[sy * t:sy * t + H, sx * t:sx * t + W] for t in range(n)]


def _write_frames(d, names, H=H, W=W):
    d.mkdir(parents=True)
    for name, img in zip(names, _texture_frames(len(names), H, W)):
        cv2.imwrite(str(d / name), img)
    return d


def _small_cfg(base):
    c = base.clone()
    c.merge_from_file(os.path.join(REPO, 'config', 'default.yaml'))
    c.merge_from_list(['BUFFER_SIZE', '64', 'PATCHES_PER_FRAME', '8',
                       'MIXED_PRECISION', 'False'])
    return c


def _forced(build):
    """The package's DPVO constructor, with the motion probe forced."""
    def make(*args, **kwargs):
        slam = build(*args, **kwargs)
        if hasattr(slam, 'force_accept'):
            slam.force_accept = True
        else:
            slam._static['force_accept'] = True      # dpvo_tpu's DeviceVO
        return slam
    return make


def test_demo_run_matches_root(tmp_path, monkeypatch):
    seq = _write_frames(tmp_path / 'seq', [f'{t:06d}.png' for t in range(16)])
    calib = tmp_path / 'calib.txt'
    calib.write_text('60.0 60.0 48.0 32.0')
    monkeypatch.setattr(root_demo, 'DPVO', _forced(root_demo.DPVO))
    monkeypatch.setattr(tdemo, 'DPVO', _forced(tdemo.DPVO))
    (jp, jt), (jpts, jclr, jcal) = root_demo.run(
        _small_cfg(jax_cfg), NPZ, str(seq), str(calib), 1)
    with torch_threads(2):
        (tp, tt), (tpts, tclr, tcal) = tdemo.run(
            _small_cfg(torch_cfg), NPZ, str(seq), str(calib), 1,
            device='cpu')
    assert tp.shape == jp.shape == (16, 7)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tp, jp, atol=POSE_TOL, rtol=0)
    assert np.abs(tp[-1, :3]).max() > 1e-3          # it tracked
    assert tpts.shape == jpts.shape and tclr.shape == jclr.shape
    assert tclr.dtype == np.uint8 and np.isfinite(tpts).all()
    assert tuple(tcal) == tuple(jcal)


def test_demo_cli_writes_every_artifact(tmp_path):
    seq = _write_frames(tmp_path / 'seq', [f'{t:06d}.png' for t in range(12)])
    (tmp_path / 'calib.txt').write_text('60.0 60.0 48.0 32.0')
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='2')
    env.pop('DISPLAY', None)
    r = subprocess.run(
        [sys.executable, '-m', 'dpvo_torch.demo', '--device', 'cpu',
         '--imagedir', str(seq), '--calib', 'calib.txt', '--network', NPZ,
         '--stride', '1', '--name', 'cli', '--config',
         os.path.join(REPO, 'config', 'default.yaml'), '--save_trajectory',
         '--plot', '--save_ply', '--save_html', '--save_colmap', '--viz',
         '--opts', 'BUFFER_SIZE', '64', 'PATCHES_PER_FRAME', '8'],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f'stdout:\n{r.stdout}\nstderr:\n{r.stderr}'
    rows = (tmp_path / 'saved_trajectories' / 'cli.txt').read_text().split(
        '\n')
    rows = [x.split() for x in rows if x]
    assert len(rows) == 12 and all(len(x) == 8 for x in rows)
    for rel in ('trajectory_plots/cli.pdf', 'cli.ply', 'cli.html',
                'cli/points3D.txt', 'cli/images.txt', 'cli/cameras.txt',
                'viewer_out/cloud.ply', 'viewer_out/frame_000000.jpg'):
        assert (tmp_path / rel).stat().st_size > 0, rel
    assert '<canvas' in (tmp_path / 'cli.html').read_text()


def test_entry_points_refuse_a_missing_gpu(tmp_path):
    """--device cuda on a host with no GPU raises before any frame is read;
    nothing falls back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tdemo.run(_small_cfg(torch_cfg), NPZ, str(tmp_path), 'calib.txt')


@pytest.mark.parametrize('bad', ['empty', 'unreadable'])
def test_demo_run_raises_when_the_reader_dies(bad, tmp_path):
    """A reader process that ends before its sentinel (an empty image
    directory, an image cv2 cannot read) makes demo.run raise instead of
    waiting for frames that never come."""
    seq = tmp_path / 'seq'
    seq.mkdir()
    if bad == 'unreadable':
        (seq / '000000.png').write_bytes(b'not an image')
    calib = tmp_path / 'calib.txt'
    calib.write_text('60.0 60.0 48.0 32.0')
    with pytest.raises(RuntimeError, match='frame reader ended'):
        tdemo.run(_small_cfg(torch_cfg), NPZ, str(seq), str(calib), 1,
                  device='cpu')
