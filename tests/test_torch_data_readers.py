"""dpvo_torch's data readers (dpvo_torch/data_readers/) and logger against
dpvo_tpu's, on the CPU, on the same seeded numpy inputs:

- rgbd_utils: induced_flow and compute_distance_matrix_flow within rtol
  1e-5 (chunked and not); loadtum's associations equal;
- RGBDAugmentor: the port's, given a generator, against dpvo_tpu's with its
  generator seeded alike: the same clip within 1e-5, over seeds and with a
  generator that takes every branch (jitter, grayscale, invert, scale);
- frame_utils: .flo written byte-equal, .flo / .pfm / KITTI PNG read back
  equal by both packages' readers;
- TartanAir on test_data_readers.py:make_scene's layout: the scene info,
  the frame graph and the first items equal dpvo_tpu's with both
  generators seeded alike; no cache directory made when scene_info_path
  is given; the validation split reserved;
- Synthetic bit-equal to dpvo_tpu's; dataset_factory / ConcatDataset
  indexing;
- Logger: the same printed lines as dpvo_tpu's.
"""
import numpy as np
import pytest

from dpvo_torch.data_readers import augmentation as taug
from dpvo_torch.data_readers import base as tbase
from dpvo_torch.data_readers import factory as tfactory
from dpvo_torch.data_readers import frame_utils as tfu
from dpvo_torch.data_readers import rgbd_utils as trgbd
from dpvo_torch.data_readers import synthetic as tsyn
from dpvo_torch.data_readers import tartan as ttartan
from dpvo_torch.runtime import numpy_se3 as nse3
from dpvo_tpu.data_readers import augmentation as jaug
from dpvo_tpu.data_readers import frame_utils as jfu
from dpvo_tpu.data_readers import rgbd_utils as jrgbd
from dpvo_tpu.data_readers import synthetic as jsyn
from dpvo_tpu.data_readers import tartan as jtartan
from test_data_readers import make_scene


def _poses_disps(n=6, h=8, w=10, seed=0):
    rng = np.random.RandomState(seed)
    xi = np.concatenate([rng.randn(n, 3) * 0.3, rng.randn(n, 3) * 0.05], 1)
    poses = nse3.exp(xi.astype(np.float32)).astype(np.float32)
    disps = rng.uniform(0.2, 1.0, (n, h, w)).astype(np.float32)
    intr = np.tile(np.array([9.0, 9.0, w / 2, h / 2], np.float32), (n, 1))
    return poses, disps, intr


def test_induced_flow_matches_jax():
    poses, disps, intr = _poses_disps()
    ii = np.array([0, 1, 2, 5, 3])
    jj = np.array([1, 0, 4, 2, 3])
    got = trgbd.induced_flow(poses, disps, intr, ii, jj)
    ref = jrgbd.induced_flow(poses, disps, intr, ii, jj)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6)
    assert got[1].min() == 0 or got[1].all()


@pytest.mark.parametrize('chunk', [7, 512])
def test_distance_matrix_matches_jax(chunk):
    poses, disps, intr = _poses_disps(n=7, seed=1)
    got = trgbd.compute_distance_matrix_flow(poses, disps, intr, chunk=chunk)
    ref = jrgbd.compute_distance_matrix_flow(poses, disps, intr, chunk=chunk)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    f = np.isfinite(ref)
    np.testing.assert_allclose(got[f], ref[f], rtol=1e-5)
    assert f.sum() > 7


def test_loadtum_matches_jax(tmp_path, monkeypatch):
    """dpvo_tpu's loadtum reads with np.unicode_, which numpy 2 dropped for
    np.str_ (the same type): patched in for its run."""
    monkeypatch.setattr(np, 'unicode_', np.str_, raising=False)
    ts = np.arange(6) * 0.1
    (tmp_path / 'rgb.txt').write_text(''.join(
        f'{t:.4f} rgb/{i}.png\n' for i, t in enumerate(ts)))
    (tmp_path / 'depth.txt').write_text(''.join(
        f'{t + 0.01:.4f} depth/{i}.png\n' for i, t in enumerate(ts[::2])))
    (tmp_path / 'groundtruth.txt').write_text(
        '# t tx ty tz qx qy qz qw\n' + ''.join(
            f'{t - 0.02:.4f} {i} 0 0 0 0 0 1\n' for i, t in enumerate(ts)))
    got = trgbd.loadtum(str(tmp_path))
    ref = jrgbd.loadtum(str(tmp_path))
    # the odd images' nearest depth lies 0.09 s off, past max_dt 0.08
    assert got[0] == ref[0] and got[1] == ref[1] and len(got[0]) == 3
    np.testing.assert_array_equal(np.array(got[2]), np.array(ref[2]))
    assert trgbd.loadtum(str(tmp_path / 'none')) == (None, None, None)


@pytest.mark.parametrize('seed', range(6))
def test_augmentor_matches_jax(seed):
    rng = np.random.RandomState(100 + seed)
    T, H, W = 3, 40, 56
    images = rng.randint(0, 255, (T, H, W, 3)).astype(np.float32)
    poses = rng.randn(T, 7).astype(np.float32)
    disps = rng.uniform(0.1, 2.0, (T, H, W)).astype(np.float32)
    intr = np.tile(np.array([50.0, 50.0, W / 2, H / 2], np.float32), (T, 1))
    crop = (32, 48)
    got = taug.RGBDAugmentor(crop, rng=np.random.RandomState(seed))(
        images, poses, disps, intr)
    ja = jaug.RGBDAugmentor(crop)
    ja.rng = np.random.RandomState(seed)
    ref = ja(images, poses, disps, intr)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5)
    # a seed gives the generator it names
    again = taug.RGBDAugmentor(crop, rng=seed)(images, poses, disps, intr)
    for g, a in zip(got, again):
        np.testing.assert_array_equal(g, a)


class _Low(np.random.RandomState):
    """A generator whose scalar rand() is always 0.05: every branch of the
    augmentor is taken (jitter, grayscale, invert, up-scale)."""

    def rand(self, *shape):
        return super().rand(*shape) if shape else 0.05


def test_augmentor_every_branch_matches_jax():
    rng = np.random.RandomState(7)
    T, H, W = 2, 40, 56
    images = rng.randint(0, 255, (T, H, W, 3)).astype(np.float32)
    poses = rng.randn(T, 7).astype(np.float32)
    disps = rng.uniform(0.1, 2.0, (T, H, W)).astype(np.float32)
    intr = np.tile(np.array([50.0, 50.0, W / 2, H / 2], np.float32), (T, 1))
    got = taug.RGBDAugmentor((32, 48), rng=_Low(5))(images, poses, disps,
                                                     intr)
    ja = jaug.RGBDAugmentor((32, 48))
    ja.rng = _Low(5)
    ref = ja(images, poses, disps, intr)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5)
    img = got[0]
    assert np.array_equal(img[..., 0], img[..., 1])     # grayscale


def test_frame_utils_round_trips_match_jax(tmp_path):
    rng = np.random.RandomState(3)
    uv = rng.randn(9, 13, 2).astype(np.float32)
    tfu.writeFlow(str(tmp_path / 't.flo'), uv)
    jfu.writeFlow(str(tmp_path / 'j.flo'), uv)
    assert (tmp_path / 't.flo').read_bytes() == \
        (tmp_path / 'j.flo').read_bytes()
    for read in (tfu.readFlow, jfu.readFlow):
        np.testing.assert_array_equal(read(str(tmp_path / 't.flo')), uv)
    np.testing.assert_array_equal(tfu.read_gen(str(tmp_path / 't.flo')),
                                  jfu.read_gen(str(tmp_path / 't.flo')))

    for shape in ((7, 11), (7, 11, 3)):
        img = rng.randn(*shape).astype(np.float32)
        tfu.writePFM(str(tmp_path / 'a.pfm'), img)
        for read in (tfu.readPFM, jfu.readPFM):
            np.testing.assert_array_equal(read(str(tmp_path / 'a.pfm')), img)
        np.testing.assert_array_equal(tfu.read_gen(str(tmp_path / 'a.pfm')),
                                      jfu.read_gen(str(tmp_path / 'a.pfm')))

    flow = np.round(rng.randn(6, 10, 2) * 640) / 64
    tfu.writeFlowKITTI(str(tmp_path / 'k.png'), flow)
    (fj, vj), (ft, vt) = (jfu.readFlowKITTI(str(tmp_path / 'k.png')),
                          tfu.readFlowKITTI(str(tmp_path / 'k.png')))
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, flow.astype(np.float32))
    assert (vt == 1).all()
    dt, okt = tfu.readDispKITTI(str(tmp_path / 'k.png'))
    dj, okj = jfu.readDispKITTI(str(tmp_path / 'k.png'))
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(okt, okj)
    with pytest.raises(ValueError):
        tfu.readFlow(str(tmp_path / 'a.pfm'))


@pytest.fixture(scope='module')
def scene_root(tmp_path_factory):
    root = tmp_path_factory.mktemp('tartan')
    make_scene(root)
    return root


def _tartan_pair(root, tmp_path, monkeypatch, **kw):
    """The port's and dpvo_tpu's TartanAir on one layout, each with its own
    scene-info pickle, the generators seeded alike (seed 0 / 1)."""
    monkeypatch.setattr(tbase, 'CACHE_DIR', str(tmp_path / 'no_cache'))
    args = dict(datapath=str(root), n_frames=4, crop_size=(48, 64),
                fmin=0.1, fmax=1e9, **kw)
    tdb = ttartan.TartanAir(scene_info_path=str(tmp_path / 't.pickle'),
                            seed=0, **args)
    jdb = jtartan.TartanAir(scene_info_path=str(tmp_path / 'j.pickle'),
                            **args)
    jdb.rng = np.random.RandomState(0)
    if jdb.aug is not None:
        jdb.aug.rng = np.random.RandomState(1)
    assert not (tmp_path / 'no_cache').exists()
    return tdb, jdb


@pytest.mark.parametrize('aug', [True, False], ids=['aug', 'no_aug'])
def test_tartan_matches_jax(scene_root, tmp_path, monkeypatch, aug):
    tdb, jdb = _tartan_pair(scene_root, tmp_path, monkeypatch, aug=aug)
    assert tdb.dataset_index == jdb.dataset_index and len(tdb) == 5
    (scene, t_info), = tdb.scene_info.items()
    j_info = jdb.scene_info[scene]
    assert t_info['images'] == j_info['images']
    assert t_info['depths'] == j_info['depths']
    np.testing.assert_array_equal(t_info['poses'], j_info['poses'])
    np.testing.assert_array_equal(np.array(t_info['intrinsics']),
                                  np.array(j_info['intrinsics']))
    assert sorted(t_info['graph']) == sorted(j_info['graph'])
    for i, (tj, td) in t_info['graph'].items():
        jj, jd = j_info['graph'][i]
        np.testing.assert_array_equal(tj, jj)
        np.testing.assert_allclose(td, jd, rtol=1e-5)
    for index in (0, 3, 1):
        for got, ref in zip(tdb[index], jdb[index]):
            assert got.shape == ref.shape
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # the pickle is read back the same
    again = ttartan.TartanAir(
        datapath=str(scene_root), n_frames=4, crop_size=(48, 64),
        scene_info_path=str(tmp_path / 't.pickle'))
    assert again.dataset_index == tdb.dataset_index


def test_tartan_reserves_the_validation_split(tmp_path, capsys):
    scene = 'abandonedfactory/abandonedfactory/Easy/P011'
    info = {f'/data/{scene}': dict(graph={i: ([], []) for i in range(70)}),
            '/data/x/x/Easy/P000': dict(graph={i: ([], []) for i in
                                               range(67)})}
    db = ttartan.TartanAir.__new__(ttartan.TartanAir)
    db.scene_info = info
    db._build_dataset_index()
    assert db.dataset_index == [('/data/x/x/Easy/P000', 0),
                                ('/data/x/x/Easy/P000', 1)]
    assert f'Reserving /data/{scene} for validation' in capsys.readouterr().out
    assert ttartan.test_split == jtartan.test_split
    assert ttartan.TartanAir.DEPTH_SCALE == 5.0
    np.testing.assert_array_equal(ttartan.TartanAirTest.intrinsics(),
                                  [320.0, 320.0, 320.0, 240.0])


def test_synthetic_matches_jax():
    tdb = tsyn.Synthetic(n_scenes=3, n_frames=4, H=24, W=32)
    jdb = jsyn.Synthetic(n_scenes=3, n_frames=4, H=24, W=32)
    assert len(tdb) == len(jdb) == 3
    for i in (0, 2, 4):
        for got, ref in zip(tdb[i], jdb[i]):
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)


def test_dataset_factory_and_concat(capsys):
    db = tfactory.dataset_factory(['synthetic', 'synthetic'], n_scenes=2,
                                  n_frames=3, H=16, W=16, datapath='unused')
    assert 'Dataset synthetic has 2 images' in capsys.readouterr().out
    assert len(db) == 4 and db.lengths == [2, 2]
    for i in range(4):
        got = db[i]
        ref = db.datasets[i // 2][i % 2]
        assert all(g is r for g, r in zip(got, ref))
    with pytest.raises(IndexError):
        db[4]
    cat = tfactory.ConcatDataset([[10, 11, 12], [20]])
    assert [cat[i] for i in range(len(cat))] == [10, 11, 12, 20]


def test_logger_prints_like_jax(tmp_path, monkeypatch, capsys):
    from dpvo_torch import logger as tlog
    from dpvo_tpu import logger as jlog
    monkeypatch.chdir(tmp_path)
    rng = np.random.RandomState(0)
    metrics = [dict(loss=float(rng.rand()), tr=float(rng.rand()),
                    ro=float(rng.rand())) for _ in range(250)]
    lines = []
    for mod in (jlog, tlog):
        log = mod.Logger('run')
        for m in metrics:
            log.push(m)
        log.write_dict({'val/AUC': 0.5})
        log.close()
        out = capsys.readouterr().out.splitlines()
        lines.append([x for x in out if x.startswith('[run')])
    assert lines[1] == lines[0] and len(lines[0]) == 2
    assert (tmp_path / 'runs' / 'run').is_dir()


def test_logger_without_tensorboard_prints_once(tmp_path, monkeypatch,
                                                capsys):
    import builtins
    from dpvo_torch import logger as tlog
    monkeypatch.chdir(tmp_path)
    real = builtins.__import__

    def no_tb(name, *a, **k):
        if name.startswith('torch.utils.tensorboard'):
            raise ImportError('no tensorboard')
        return real(name, *a, **k)
    monkeypatch.setattr(builtins, '__import__', no_tb)
    log = tlog.Logger('quiet')
    for i in range(2 * tlog.SUM_FREQ):
        log.push({'loss': 1.0})
    log.write_dict({'x': 1.0})
    out = capsys.readouterr().out
    assert out.count('no TensorBoard scalars') == 1
    assert out.count('[quiet') == 2
    assert not (tmp_path / 'runs').exists()
