"""dpvo_torch/transfer.py: uploads and read-backs that do not wait for the
device.

On the CPU both are plain: the upload is the array itself and a read-back
handle is the tensor. On the card (marked cuda, skipped elsewhere; run it
on a GPU host with `python -m pytest tests/test_torch_transfer.py -q`):
each read-back owns a fresh page-locked buffer, so a read returns the
values its copy started with while the source moves on and other copies
are in flight, also when the copy was started on a side stream; an upload
never reads the host array after it returns.
"""
import numpy as np
import pytest
import torch

from dpvo_torch.transfer import Readback, upload


def test_readback_on_the_cpu_is_the_tensor():
    rb, t = Readback(), torch.arange(4.0)
    assert rb.start(t) is t
    np.testing.assert_array_equal(rb.read(t), [0, 1, 2, 3])
    assert rb.reads == 0


def test_upload_on_the_cpu_is_the_array():
    a = np.arange(6, dtype=np.int32)
    t = upload(a, 'cpu', np.int64)
    assert t.dtype == torch.int64 and t.tolist() == list(range(6))
    b = np.ones(3, np.float32)
    upload(b, torch.device('cpu'))[0] = 5.0      # shares b's memory
    assert b[0] == 5.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: page-locked copies and events')
    return torch.device('cuda', torch.cuda.device_count() - 1)


@pytest.mark.cuda
def test_readback_handle_owns_its_buffer(cuda):
    rb = Readback()
    x = torch.arange(1 << 20, dtype=torch.float32, device=cuda)
    want = x.cpu().numpy()
    side = torch.cuda.Stream(cuda)
    handles = [rb.start(x)]
    x.add_(1.0)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        torch.cuda._sleep(100_000_000)    # the side stream's copy lands late
        handles.append(rb.start(x))       # its event on the side stream
        x.mul_(-1.0)
    torch.cuda.current_stream(cuda).wait_stream(side)
    handles.append(rb.start(x[:7]))
    assert len({h[0].data_ptr() for h in handles}) == 3
    assert all(h[0].is_pinned() for h in handles)
    np.testing.assert_array_equal(rb.read(handles[1]), want + 1.0)
    np.testing.assert_array_equal(rb.read(handles[0]), want)
    np.testing.assert_array_equal(rb.read(handles[2]), -(want[:7] + 1.0))
    assert rb.reads == 3


@pytest.mark.cuda
def test_upload_does_not_read_the_array_later(cuda):
    a = np.arange(1 << 20, dtype=np.float32)
    t = upload(a, cuda)
    a[:] = -1.0
    torch.cuda.synchronize(cuda)
    np.testing.assert_array_equal(t.cpu().numpy(),
                                  np.arange(1 << 20, dtype=np.float32))
