"""The operation and byte counters on small cases worked by hand."""
from __future__ import annotations

import pytest
import torch

from portbench import flops
from portbench.bounds import k1


def test_encoder_flops_by_hand():
    # 16 x 16 frame, base width 1, output width 2: the 7x7 stride-2 conv at
    # 8 x 8, four 3x3 convs at 8 x 8, then at 4 x 4 the stride-2 3x3 (1 ->
    # 2), a 3x3 (2 -> 2), the 1x1 projection (1 -> 2), two 3x3 (2 -> 2),
    # the 1x1 output conv (2 -> 2)
    want = 2 * (3 * 1 * 49 * 64 + 4 * 1 * 1 * 9 * 64 + 1 * 2 * 9 * 16 +
                2 * 2 * 9 * 16 + 1 * 2 * 16 + 2 * 2 * 2 * 9 * 16 +
                2 * 2 * 16)
    assert flops.encoder_flops(16, 16, 1, 2) == want


def test_update_k1_and_ba_flops_by_hand():
    # one edge, dim 1, corr_in 1, one pair, one group: per edge 1 + 2
    # (corr) + 4 + 4 + 6 + 4 (heads) multiply-adds, h of both aggregations
    # once each
    assert flops.update_flops(1, 1, 1, 1, 1) == 2 * (21 + 2)
    assert flops.k1_flops(1) == 2 * 9 * 64 * 128 * 2 + 9 * 49 * 7 * 2
    assert flops.k1_flops(0) == 0
    n = 6
    schur = 2 * n * n * 1 + 2 * n * 1 + n ** 3 // 3 + 2 * n * n
    assert flops.ba_flops(0, 1, 1, steps=1) == schur
    # per edge: three 6 x 6 blocks of 2 residuals, two 6-vectors of the
    # pose-depth products, three depth terms, all multiply-adds
    per_edge = 3 * 2 * 36 * 2 + 2 * 2 * 6 * 2 + 3 * 2 * 2
    assert flops.ba_flops(2, 1, 1, steps=2) == 2 * (2 * per_edge + schur)


def test_frame_flops_grows_with_the_live_edges():
    from portbench import spec
    _, config, _, _ = spec.resolve(spec.benchmark(), 'dpvo-default.clients')
    a = flops.frame_flops(config, 0)
    b = flops.frame_flops(config, 96)
    enc = flops.encoder_flops(480, 640, 32, 128) + \
        flops.encoder_flops(480, 640, 32, 384)
    assert a > enc and b > a
    # the encoders of one 640 x 480 frame: about 24 GFLOP
    assert 20e9 < enc < 30e9


def test_k1_bound_counts_each_byte_once():
    # two live edges of one source patch into one 16 x 16 map, both
    # windows at the same place: the map pixels count once
    E, C = 3, 128
    co = torch.full((E, 3, 3, 2), 8.5)
    kk = torch.zeros(E, dtype=torch.int32)
    jj = torch.zeros(E, dtype=torch.int32)
    gmap = torch.zeros((4, 3, 3, C), dtype=torch.bfloat16)
    f1 = torch.zeros((1, 16, 16, C), dtype=torch.bfloat16)
    f2 = torch.zeros((1, 4, 4, C), dtype=torch.bfloat16)
    rec = k1.capture((gmap, f1, f2, co, kk, jj),
                     dict(nv=torch.tensor(2), out_dtype=torch.bfloat16))
    sec, nv = k1.seconds(rec)
    assert nv == 2
    # level 1: rows / columns 5..12 (8 x 8 = 64 pixels); level 2 at 2.125:
    # taps -1..6 clipped to 0..3, 16 pixels
    nb = 2 * 9 * 2 * 4 + 2 * 2 * 4 + E * 49 * 9 * 2 * 2 + 1 * 9 * C * 2 + \
        (64 + 16) * C * 2
    want = max(nb / flops.HBM_BYTES_PER_S,
               flops.k1_flops(2) / flops.BF16_FLOP_PER_S)
    assert sec == pytest.approx(want, rel=1e-12)
