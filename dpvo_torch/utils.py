"""Wall-clock section timing around device work.

The port of dpvo_tpu/utils/timing.py:Timer (the reference's dpvo/utils.py:
8-29): a host clock around the section. On a CUDA device the timer
synchronizes the device at entry and exit, so the time covers the
section's device work and not only its launches.
"""
from __future__ import annotations

import time
from contextlib import ContextDecorator

import torch

all_times = []


class Timer(ContextDecorator):
    """`with Timer('SLAM', enabled=timeit, device=dev):` prints the
    section's ms and appends it to all_times."""

    def __init__(self, name, enabled=True, device=None):
        self.name = name
        self.enabled = enabled
        self.cuda = device is not None and torch.device(device).type == 'cuda'

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def __enter__(self):
        if self.enabled:
            self._sync()
            self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            self._sync()
            elapsed = (time.perf_counter() - self.start) * 1000.0
            all_times.append(elapsed)
            print(f'{self.name} {elapsed:.03f}')
        return False
