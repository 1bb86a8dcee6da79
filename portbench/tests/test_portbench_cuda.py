"""A client on the card, at a tiny size: the program's kernels (K1 on bf16
maps) run, and the check's exact numbers hold. Skips without a card."""
from __future__ import annotations

import math

import pytest

from portbench.check import Judge, judge
from portbench.client import Client

from .conftest import tiny_cell


@pytest.mark.cuda
def test_a_client_on_the_card_keeps_the_exact_numbers(cuda_device):
    _, config, traffic, _ = tiny_cell(mixed=True, M=16)
    c = Client(dict(config=config, traffic=traffic, seed=31, index=0,
                    trace=0, device=cuda_device))
    c.warm_up()
    for t in range(c.warm, c.rec.step_frame + 1):
        c.track(t)
    c.sync()
    j = Judge(config, c.seq, c.seeds['weights'], c.seeds['vo'], c.dev)
    got = judge(j, c.rec)
    assert got['boot.state'] == 0 and got['step.state'] == 0
    assert got['step.replay'] == 0
    assert all(math.isfinite(v) for v in got.values())
