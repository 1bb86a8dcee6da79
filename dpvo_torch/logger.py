"""Metrics logger: running means + optional TensorBoard.

Copy of dpvo_tpu/logger.py, which mirrors reference dpvo/logger.py:8-57:
the running mean of each metric printed every SUM_FREQ pushes, as the same
line. TensorBoard scalars go to runs/<name> where torch.utils.tensorboard
imports; where it does not, the logger says so once and only prints
(dpvo_tpu's swallows every error of the writer silently).
"""
from __future__ import annotations

SUM_FREQ = 100


class Logger:
    def __init__(self, name, scheduler=None):
        self.total_steps = 0
        self.running_loss = {}
        self.writer = None
        self.name = name
        self.scheduler = scheduler

    def _maybe_writer(self):
        if self.writer is None:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                print(f'Logger: no TensorBoard scalars ({e}); printing only')
                self.writer = False
            else:
                self.writer = SummaryWriter(log_dir=f'runs/{self.name}')
        return self.writer

    def _print_training_status(self):
        metrics_data = [self.running_loss[k] / SUM_FREQ
                        for k in sorted(self.running_loss.keys())]
        metrics_str = ('{:10.4f}, ' * len(metrics_data)).format(*metrics_data)
        print(f'[{self.name}  {self.total_steps + 1:6d}] {metrics_str}')

        w = self._maybe_writer()
        for k in self.running_loss:
            if w:
                w.add_scalar(k, self.running_loss[k] / SUM_FREQ,
                             self.total_steps)
            self.running_loss[k] = 0.0

    def push(self, metrics):
        for key in metrics:
            self.running_loss[key] = self.running_loss.get(key, 0.0) + \
                float(metrics[key])
        if self.total_steps % SUM_FREQ == SUM_FREQ - 1:
            self._print_training_status()
            self.running_loss = {}
        self.total_steps += 1

    def write_dict(self, results):
        w = self._maybe_writer()
        if w:
            for key in results:
                w.add_scalar(key, results[key], self.total_steps)

    def close(self):
        if self.writer:
            self.writer.close()
