"""The plain reference of DeviceVO's frame step: VONet (model.py), the
local correlation (corr.py), pair-blocked bundle adjustment (ba.py), the
state machine (vo.py), its integer bookkeeping replayed from keyframe
decisions (books.py) and the Lie group (lie.py). Plain PyTorch in float32
with TF32 off; it imports nothing of the program (dpvo_torch) and takes
none of its weights or tables.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def plain_numerics():
    """float32 matmuls and convolutions without TF32, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8(t):
    """t rounded to float8 e4m3 under one scale per tensor (its largest
    magnitude maps to 448), returned in t's dtype: the control's
    precision, the step below the configuration's bfloat16."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def bf16(t):
    """t rounded to bfloat16, returned in t's dtype: the control's
    precision for what the configuration computes in other float32 (bundle
    adjustment)."""
    return t.to(torch.bfloat16).to(t.dtype)
