"""Global bundle adjustment (pair-block E, DPV-SLAM's backend): dpvo_tpu's
ba_global against dpvo_torch's on the CPU, same numpy inputs.

* build_pair_tables: array-equal, row order included, on random edge sets
  and on the edge cases (one edge; a source frame with a single pair).
* global_ba on tests/test_ba.py:make_problem (perfect targets from ground
  truth, noisy initial poses and depths; poses move by up to 0.08): within
  1e-4 of dpvo_tpu's poses and 1e-3 of its depths, on the 8-frame problem
  and on a 40-frame one (both in one 128-frame W bucket); within 2e-4 /
  2e-3 of the port's own dense windowed BA (test_ba_global.py's bounds).
  The port solves in f64 on the f32 state: the pose blocks reach ~1e6 and
  the Schur complement cancels most of them, and an all-f32 port landed
  1.9e-4 from dpvo_tpu on the 8-frame problem (each is ~1e-4 from an f64
  solve there, in different directions); in f64 it is 3.8e-5 away.
* a system that is not positive definite gives a zero update, not NaN.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpvo_torch import ba as tba
from dpvo_torch import ba_global as tg
from dpvo_tpu import ba_global as jg
from test_ba import make_problem
from test_torch_runtime import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')


def _random_edges(E, frames, seed):
    rng = np.random.RandomState(seed)
    ii = rng.randint(0, frames, E)
    jj = np.clip(ii + rng.randint(-6, 7, E), 0, frames - 1)
    M = 4
    return ii, jj, ii * M + rng.randint(0, M, E), M


@pytest.mark.parametrize('case', ['one_edge', 'single_pair_source',
                                  'E50', 'E700', 'E6000'])
def test_pair_tables_match_jax(case):
    if case == 'one_edge':
        ii, jj, kk, M = np.array([3]), np.array([5]), np.array([13]), 4
    elif case == 'single_pair_source':
        # frame 2's only pair is its self pair; frame 0 has three pairs
        ii, jj = np.array([0, 0, 2, 0, 0]), np.array([1, 3, 2, 1, 0])
        kk, M = ii * 4 + np.array([0, 1, 2, 3, 0]), 4
    else:
        E = int(case[1:])
        ii, jj, kk, M = _random_edges(E, max(E // 40, 3), E)
    ours = tg.build_pair_tables(ii, jj, kk, M)
    theirs = jg.build_pair_tables(ii, jj, kk, M)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        if isinstance(v, np.ndarray):
            assert ours[k].dtype == v.dtype and np.array_equal(ours[k], v), k
        else:
            assert ours[k] == v, k
    if case == 'single_pair_source':
        assert ours['n_pairs'] == 4 and ours['n_rows'] == 3 * 3 + 1


def _problem_args(p):
    E = len(p['ii'])
    return (p['poses0'], p['xy'], p['depth0'], p['intr'], p['target'],
            np.ones((E, 2), np.float32), p['ii'], p['jj'], p['kk'])


def _port(args, t0, t1, M):
    *dense, ii, jj, kk = args
    poses, xy, depth, intr, target, weight = (torch.from_numpy(np.array(a))
                                              for a in dense)
    out = tg.global_ba(poses, xy, depth, intr, target, weight, ii, jj, kk,
                       t0, t1, M, iterations=2)
    return [o.numpy() for o in out]


@pytest.mark.parametrize('n_frames, M', [(8, 6), (40, 5)])
def test_global_ba_matches_jax(n_frames, M):
    p = make_problem(n_frames=n_frames, M=M)
    args = _problem_args(p)
    poses, depth = _port(args, 1, n_frames, M)
    *dense, ii, jj, kk = args
    jp, jd = jg.global_ba(*(jnp.asarray(a) for a in dense[:4]), *dense[4:],
                          ii, jj, kk, 1, n_frames, M=M, iterations=2)
    assert np.abs(poses[:n_frames] - p['poses0'][:n_frames]).max() > 1e-2
    np.testing.assert_allclose(poses, np.asarray(jp), rtol=0, atol=1e-4)
    np.testing.assert_allclose(depth, np.asarray(jd), rtol=0, atol=1e-3)
    # pose 0 is outside the window [1, n_frames): held fixed
    assert np.array_equal(poses[0], p['poses0'][0])


def test_global_ba_matches_dense():
    n, M = 8, 6
    p = make_problem(n_frames=n, M=M)
    args = _problem_args(p)
    poses, depth = _port(args, 1, n, M)
    E = len(p['ii'])
    t = {k: torch.from_numpy(np.array(p[k])) for k in
         ('poses0', 'xy', 'depth0', 'intr', 'target', 'ii', 'jj', 'kk')}
    dp, dd = tba.bundle_adjust(
        t['poses0'], t['xy'], t['depth0'], t['intr'], t['target'],
        torch.ones(E, 2), 1e-4, t['ii'].long(), t['jj'].long(),
        t['kk'].long(), torch.ones(E, dtype=torch.bool), 1, n, 0, W=n,
        PC=n * M, iterations=2)
    np.testing.assert_allclose(poses[:n], dp.numpy()[:n], rtol=0, atol=2e-4)
    np.testing.assert_allclose(depth[:n * M], dd.numpy()[:n * M], rtol=0,
                               atol=2e-3)


def test_non_pd_system_gives_zero_update():
    """Negative weights make the damped system indefinite: the Cholesky
    fails, and poses and depths come back unchanged (dpvo_tpu's cho_factor
    would return NaN there, which it then zeroes too)."""
    n, M = 8, 6
    p = make_problem(n_frames=n, M=M)
    *dense, ii, jj, kk = _problem_args(p)
    dense[5] = np.full_like(dense[5], -100.0)
    poses, depth = _port((*dense, ii, jj, kk), 1, n, M)
    assert np.isfinite(poses).all() and np.isfinite(depth).all()
    assert np.array_equal(poses, p['poses0'])
    assert np.array_equal(depth, p['depth0'])
