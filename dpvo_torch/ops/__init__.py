"""Patchify, segment scatter and correlation ops (plain PyTorch + the CUDA
correlation kernels behind corr_onepass and corr_fused)."""
from .patchify import extract_patches, avg_pool2d, pyramidify
from .corr import corr
from .scatter import segment_softmax, segment_sum, segment_mean

__all__ = [
    'extract_patches', 'avg_pool2d', 'pyramidify', 'corr',
    'segment_softmax', 'segment_sum', 'segment_mean',
]
