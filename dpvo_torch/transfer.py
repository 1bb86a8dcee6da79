"""Host <-> device copies that do not wait for the device.

In PyTorch a host-to-device copy with non_blocking=False, `.cpu()`,
`.item()` and `float(tensor)` synchronize the stream: the host waits for
every kernel queued before them. The hybrid runtime keeps the host ahead
of the device instead:

  * `upload` copies a host array into a fresh page-locked buffer
    (`pin_memory`, the caching host allocator) and sends that with
    non_blocking=True; the allocator does not hand the buffer out again
    before the copy has run, and the caller's array is never read by a
    copy in flight, so the host may rewrite it at once;
  * `Readback` starts device-to-host copies that are read later:
    dpvo_tpu's `copy_to_host_async` + fetch (runtime/dpvo.py:518-534,
    :847-848).

On the CPU both are plain: the upload is the array itself and a read-back
handle is the tensor.
"""
from __future__ import annotations

import numpy as np
import torch


def upload(a, device, dtype=None):
    """Host array `a` (cast to `dtype`) as a tensor on `device`, without
    waiting for the device: see the module docstring. On the CPU the
    tensor shares the array's memory."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype))
    device = torch.device(device)
    if device.type != 'cuda':
        return t
    return t.pin_memory().to(device, non_blocking=True)


class Readback:
    """Device-to-host copies that are read later.

    `start(t)` copies the tensor t with copy_(non_blocking=True) into a
    fresh page-locked buffer (the caching host allocator) and records an
    event behind the copy on the current stream of t's device, the stream
    the copy runs on; the handle owns its buffer, so nothing rewrites it
    before `read(h)`, which waits on that event alone (the device goes on
    with whatever was queued after the copy) and returns the values as a
    numpy array. On the CPU the handle is the tensor itself and `read` is
    `.numpy()`. `reads` counts the reads of CUDA copies, each one wait on
    an event."""

    def __init__(self):
        self.reads = 0

    def start(self, t):
        if t.device.type != 'cuda':
            return t
        buf = torch.empty(t.numel(), dtype=t.dtype, pin_memory=True)
        buf.copy_(t.reshape(-1), non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(t.device))
        return buf, event

    def read(self, handle):
        if isinstance(handle, torch.Tensor):
            return handle.numpy()
        buf, event = handle
        event.synchronize()
        self.reads += 1
        return buf.numpy()
