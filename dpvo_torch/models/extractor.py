"""RAFT-style residual CNN feature encoder (BasicEncoder4), as nn.Modules.

Port of dpvo_tpu/models/extractor.py:24-85 (reference dpvo/extractor.py:
200-264). Module and parameter names are the reference's, so a dpvo.pth
state_dict loads as-is. NCHW convs; the instance norm (fnet) computes its
statistics in f32 whatever the conv dtype, as dpvo_tpu does. The inet uses
no norm.

BasicEncoder4 = 7x7 s2 conv -> [2 residual blocks @32ch] ->
[2 residual blocks @64ch, first s2] -> 1x1 conv; output stride 4.
"""
from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

DIM = 32  # base channel count (reference extractor.py:115)


class InstanceNorm32(nn.Module):
    """Per-sample per-channel normalization over H, W (no affine), f32."""

    def forward(self, x):
        return F.instance_norm(x.float(), eps=1e-5).to(x.dtype)


def _norm(norm_fn):
    return InstanceNorm32() if norm_fn == 'instance' else nn.Sequential()


class ResidualBlock(nn.Module):
    def __init__(self, in_planes, planes, norm_fn, stride=1, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, padding=1, stride=stride,
                               device=device)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, device=device)
        self.relu = nn.ReLU()
        self.norm1 = _norm(norm_fn)
        self.norm2 = _norm(norm_fn)
        if stride == 1:
            self.downsample = None
        else:
            self.norm3 = _norm(norm_fn)
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride, device=device),
                self.norm3)

    def forward(self, x):
        y = self.relu(self.norm1(self.conv1(x)))
        y = self.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return self.relu(x + y)


class BasicEncoder4(nn.Module):
    """(N, 3, H, W) -> (N, output_dim, H/4, W/4)."""

    def __init__(self, output_dim, norm_fn, device=None):
        super().__init__()
        self.norm1 = _norm(norm_fn)
        self.conv1 = nn.Conv2d(3, DIM, 7, stride=2, padding=3, device=device)
        self.relu1 = nn.ReLU()
        self.layer1 = nn.Sequential(
            ResidualBlock(DIM, DIM, norm_fn, 1, device),
            ResidualBlock(DIM, DIM, norm_fn, 1, device))
        self.layer2 = nn.Sequential(
            ResidualBlock(DIM, 2 * DIM, norm_fn, 2, device),
            ResidualBlock(2 * DIM, 2 * DIM, norm_fn, 1, device))
        self.conv2 = nn.Conv2d(2 * DIM, output_dim, 1, device=device)

    def forward(self, x):
        x = self.relu1(self.norm1(self.conv1(x)))
        x = self.layer2(self.layer1(x))
        return self.conv2(x)
