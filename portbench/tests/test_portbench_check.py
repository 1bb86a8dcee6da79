"""The check that decides `correct`, driven as a run drives it (a client
built as the benchmark builds it, its window, its check, the verdict
against the committed limits), on the CPU at a tiny size: the plain
reference agrees with the program; a timed path broken underneath, and
the control in the program's place, come out not correct."""
from __future__ import annotations

import time

import pytest
import torch

from portbench.check import Judge, judge, limits_of, verdict
from portbench.client import Client

from .conftest import tiny_cell


def run(mixed=False, fault=None, monkeypatch=None, seed=2 ** 40 + 3):
    _, config, traffic, _ = tiny_cell(mixed=mixed)
    c = Client(dict(config=config, traffic=traffic, seed=seed, index=1,
                    trace=0, device='cpu'))
    c.warm_up()
    if fault:
        fault(monkeypatch)
    now = time.monotonic()
    w = c.window(dict(t0=now, deadline=now + 1e-3))
    for t in range(c.warm + w['frames'], c.rec.step_frame + 1):
        c.track(t)
    assert c.rec.post is not None
    got = c.check()['numbers']
    return verdict(got, limits_of(config['name'])['numbers'])[0], got


def test_the_reference_follows_the_program_in_f32():
    # the same arithmetic in the same precision: gaps are rounding only
    ok, got = run(mixed=False)
    assert ok
    assert got['boot.state'] == 0 and got['step.state'] == 0
    assert got['step.replay'] == 0
    for k in ('patchify', 'net', 'weight'):
        assert got[f'boot.{k}'] < 1e-4 and got[f'step.{k}'] < 1e-4, k
    assert got['boot.net1'] < 1e-4 and got['boot.weight1'] < 1e-4
    for k in ('delta', 'pose', 'depth'):
        assert got[f'boot.{k}'] < 1e-2 and got[f'step.{k}'] < 1e-2, k


def unchanged(mp):
    """The step returns its state as it found it."""
    from dpvo_torch.runtime import device_driver
    mp.setattr(device_driver, 'vo_frame_packed1',
               lambda network, st, buf, **kw: st)


def half_batch(mp):
    """Half of the edges left out of the update, its means over the rest."""
    from dpvo_torch.models.vonet import VONet
    orig = VONet.update_op

    def update_op(self, net, inp, corr, ix, jx, kk, pairs, num_segments,
                  edge_mask, **kw):
        half = torch.arange(edge_mask.shape[0], device=edge_mask.device) % 2
        return orig(self, net, inp, corr, ix, jx, kk, pairs, num_segments,
                    edge_mask & (half == 0), **kw)
    mp.setattr(VONet, 'update_op', update_op)


def altered(mp):
    """An answer altered where it is produced: bundle adjustment's
    retraction moves the poses half as far again as its step says."""
    from dpvo_torch import lie
    orig = lie.se3_retr
    mp.setattr(lie, 'se3_retr', lambda data, xi: orig(data, 1.5 * xi))


@pytest.mark.parametrize('fault', [unchanged, half_batch, altered])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    ok, got = run(mixed=False, fault=fault, monkeypatch=monkeypatch)
    assert not ok, got


def test_the_control_is_not_correct():
    _, config, traffic, _ = tiny_cell(mixed=True)
    c = Client(dict(config=config, traffic=traffic, seed=5, index=0,
                    trace=0, device='cpu'))
    c.warm_up()
    for t in range(c.warm, c.rec.step_frame + 1):
        c.track(t)
    j = Judge(config, c.seq, c.seeds['weights'], c.seeds['vo'], c.dev)
    lim = limits_of(config['name'])
    got = judge(j, c.rec, control=True, band=lim['keyframe_band'])
    ok, rows = verdict(got, lim['numbers'])
    assert not ok, rows
