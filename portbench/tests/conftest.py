"""Shared pieces of the benchmark's CPU tests: a tiny copy of a cell
(small frames and few patches; every width as configured) for runs on
the CPU."""
from __future__ import annotations

import json

import pytest

from portbench import spec


def tiny_cell(workload='dpvo-default.clients', mixed=False, M=8):
    cell, config, traffic, metrics = spec.resolve(spec.benchmark(), workload)
    config = json.loads(json.dumps(config))
    config['height'], config['width'] = 64, 96
    config['dpvo']['PATCHES_PER_FRAME'] = M
    config['dpvo']['MIXED_PRECISION'] = mixed
    traffic = dict(traffic, warmup_frames=12,
                   check_frame={'first': 1, 'span': 2})
    return cell, config, traffic, metrics


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips where there is none (decided here, not
    while the module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the program runs its CUDA kernels '
                    'there)')
    return 'cuda:0'
