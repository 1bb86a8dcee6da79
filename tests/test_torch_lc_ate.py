"""The loop-closure accuracy gates on the port (dpvo_torch.accuracy), on the
CPU, at the JAX package's bars, against dpvo_tpu's runs of the same gates.

Both run on make_sequence(950, T=40, 64x96, loop=True), an out-and-back
path whose second half revisits the first, with accuracy.lc_cfg (M = 8,
windows of 6 / 12 / 10 frames, no keyframe removal, GLOBAL_OPT_FREQ 8,
BACKEND_THRESH 64, f32).

Oracle (tests/test_oracle_lc.py; ground-truth reprojection targets from
the sequence's poses and inverse depths replace the learned update):
proximity proposes loop edges; VO and LC ATE each < 0.001 x the path; LC
<= 2 x VO + 1e-4. The port's LC trajectory is within 1e-3 of dpvo_tpu's
(measured 6.4e-7), with the same loop edges, global-BA frames and inactive
store, whose target / weight rows agree within 1e-5 (the oracle's targets
do not depend on the state).

Learned (tests/test_dpv_slam_learned.py, artifacts/micro_vonet.npz; VO is
DeviceVO, LC HybridVO): proximity proposes loop edges; LC ATE <= 1.05 x VO
+ 1e-4, and < VO where VO drifts more than 1% of the path (it does: 0.69
of a 4.76 path); the port's LC ATE within 10% of dpvo_tpu's or 1e-3 x the
path, whichever is larger (test_torch_oracle_ate.py's rule).

Each dpvo_tpu run is made once per module (module-scoped fixtures).
"""
import numpy as np
import pytest

from dpvo_torch import accuracy as acc
from dpvo_torch.data_readers.synthetic import make_sequence
from test_torch_runtime import NPZ, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')


@pytest.fixture(scope='module')
def seq():
    return make_sequence(950, T=40, H=64, W=96, step=0.12, loop=True)


def _jax_lc(seq, network, oracle):
    """dpvo_tpu's run of the gate: test_oracle_lc.py's or
    test_dpv_slam_learned.py's runtime and config (kept in lc_cfg)."""
    from dpvo_tpu.config import cfg as base_cfg
    from dpvo_tpu.runtime import DPVO, HybridVO
    from test_oracle_lc import make_gt_oracle
    images = seq['images']
    T, H, W, _ = images.shape
    cfg, ours = base_cfg.clone(), acc.lc_cfg(True)
    for k in ('BUFFER_SIZE', 'PATCHES_PER_FRAME', 'PATCH_LIFETIME',
              'REMOVAL_WINDOW', 'OPTIMIZATION_WINDOW', 'KEYFRAME_THRESH',
              'MIXED_PRECISION', 'LOOP_CLOSURE', 'GLOBAL_OPT_FREQ',
              'BACKEND_THRESH'):
        cfg[k] = ours[k]
    if oracle:
        slam = HybridVO(cfg, None, ht=H, wd=W, seed=7)
        slam._oracle = make_gt_oracle(seq)
    else:
        slam = DPVO(cfg, network, ht=H, wd=W, seed=7)
    slam.motion_probe = lambda: 100.0
    for t in range(T):
        slam(t, images[t], seq['intrinsics'])
    poses, tstamps = slam.terminate()
    return dict(poses=poses, ate=acc.trajectory_ate(poses, tstamps,
                                                    seq['wfc']),
                slam=slam)


@pytest.fixture(scope='module')
def oracle_runs(seq):
    return (acc.lc_run(seq, False, device='cpu', oracle=True),
            acc.lc_run(seq, True, device='cpu', oracle=True),
            _jax_lc(seq, None, oracle=True))


@pytest.fixture(scope='module')
def learned_runs(seq):
    return (acc.lc_run(seq, False, device='cpu', network=NPZ),
            acc.lc_run(seq, True, device='cpu', network=NPZ),
            _jax_lc(seq, NPZ, oracle=False))


def test_oracle_lc_gate(oracle_runs):
    vo, lc, _ = oracle_runs
    path = lc['path']
    assert np.isfinite(vo['ate']) and np.isfinite(lc['ate'])
    assert lc['n_loop'] > 0, 'proximity proposed no loop edges on a revisit'
    assert lc['slam'].ran_global_ba.any() and len(lc['slam'].ii_inac) > 0
    assert vo['ate'] < 0.001 * path, (vo['ate'], path)
    assert lc['ate'] < 0.001 * path, (lc['ate'], path)
    assert lc['ate'] <= 2.0 * vo['ate'] + 1e-4, (lc['ate'], vo['ate'])


def test_oracle_lc_matches_jax(oracle_runs):
    _, lc, jx = oracle_runs
    ts, js = lc['slam'], jx['slam']
    assert lc['n_loop'] == js._n_loop_edges
    assert np.array_equal(np.flatnonzero(ts.ran_global_ba),
                          np.flatnonzero(js.ran_global_ba))
    np.testing.assert_allclose(lc['poses'], jx['poses'], rtol=0, atol=1e-3)
    ni = len(js.ii_inac)
    assert len(ts.ii_inac) == ni > 0
    for k in ('ii_inac', 'jj_inac', 'kk_inac'):
        assert np.array_equal(getattr(ts, k), getattr(js, k)), k
    np.testing.assert_allclose(ts._inac_tw[:ni].numpy(),
                               np.asarray(js._inac_tw_dev)[:ni], rtol=0,
                               atol=1e-5)


def test_learned_lc_gate(learned_runs):
    vo, lc, _ = learned_runs
    err_vo, err_lc, path = vo['ate'], lc['ate'], lc['path']
    assert np.isfinite(err_vo) and np.isfinite(err_lc)
    assert lc['n_loop'] > 0, 'proximity proposed no loop edges on a revisit'
    assert err_lc <= err_vo * 1.05 + 1e-4, (err_lc, err_vo)
    if err_vo > 0.01 * path:
        assert err_lc < err_vo, (err_lc, err_vo)


def test_learned_lc_matches_jax(learned_runs):
    _, lc, jx = learned_runs
    assert lc['n_loop'] == jx['slam']._n_loop_edges
    assert abs(lc['ate'] - jx['ate']) <= max(0.1 * jx['ate'],
                                             1e-3 * lc['path']), (
        lc['ate'], jx['ate'])


def test_make_sequence_loop_copy_is_bit_equal():
    from dpvo_tpu.data_readers.synthetic import make_sequence as jax_seq
    for seed, T in ((950, 6), (3, 5)):
        a = make_sequence(seed, T=T, H=64, W=96, step=0.12, loop=True)
        b = jax_seq(seed, T=T, H=64, W=96, step=0.12, loop=True)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
