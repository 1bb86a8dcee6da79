"""The planes kernel (K2) and the tap-select kernel (K3) against their plain
PyTorch versions, on the card. Skips where no CUDA device exists (the
kernels have no CPU or interpret mode); run it on a GPU host with
`python -m pytest tests/test_torch_corr_fused_cuda.py -q`.

Bounds: K2 vs plain, one bf16 rounding of each plane entry (both sum the
same f32 products in another order): 2^-7 |plain| + 1e-5 max|plain|. K3 vs
plain: the same f32 operations on the same planes, 1e-6 max|plain|, also
on the pixels whose spread overflows the window (exact zeros). K2 + K3
vs the exact correlation on edges whose spread fits: 2^-8 max|plane| +
1e-5 max|exact| (the planes' bf16 rounding)."""
import numpy as np
import pytest
import torch

from chip_smoke import corr_case
from dpvo_torch.ops import corr_fused as cf
from dpvo_torch.ops import corr_onepass
from dpvo_torch.ops.corr import corr_two_level as corr_exact

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels run only on the card')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _inputs(dev, dtype, E=1536, F=3, H1=120, W1=160, Ng=64, seed=0):
    gmap, f1, f2, coords, kk, jj = corr_case(E, F, H1, W1, Ng, seed)
    g, f1, f2 = (torch.from_numpy(a).to(dev).to(dtype)
                 for a in (gmap, f1, f2))
    co, kk, jj = (torch.from_numpy(a).to(dev) for a in (coords, kk, jj))
    return g, f1, f2, co, kk, jj


def _window(co, f1, f2):
    H1, W1 = f1.shape[1:3]
    H2, W2 = f2.shape[1:3]
    return (cf.window_base(co, H1, W1, 8), cf.window_base(co / 4.0, H2, W2, 4),
            (H1, W1), (H2, W2))


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_planes_kernel_matches_plain(cuda, dtype):
    g, f1, f2, co, kk, jj = _inputs(cuda, dtype)
    w1, w2, _, _ = _window(co, f1, f2)
    args = (g.reshape(-1, 9, 128), f1, f2, kk, jj, w1[4], w1[5], w2[4],
            w2[5])
    before = cf.plane_launches
    got = cf.planes(*args)
    torch.cuda.synchronize()
    assert cf.plane_launches == before + 1
    for a, b in zip(got, cf.planes_plain(*args)):
        a, b = a.float(), b.float()
        bound = 2 ** -7 * b.abs() + 1e-5 * b.abs().max()
        assert bool(((a - b).abs() <= bound).all()), (a - b).abs().max()


@pytest.mark.parametrize('level', [1, 2])
def test_select_kernel_matches_plain(cuda, level):
    g, f1, f2, co, kk, jj = _inputs(cuda, torch.bfloat16, seed=1)
    w1, w2, hw1, hw2 = _window(co, f1, f2)
    planes = cf.planes(g.reshape(-1, 9, 128), f1, f2, kk, jj, w1[4], w1[5],
                       w2[4], w2[5])
    xi, yi, fx, fy, _, _, oy, ox = w1 if level == 1 else w2
    H, W = hw1 if level == 1 else hw2
    args = (planes[level - 1], yi, xi, fy, fx, oy, ox, H, W)
    before = cf.select_launches
    got = cf.select_taps(*args)
    torch.cuda.synchronize()
    assert cf.select_launches == before + 1
    ref = cf.select_plain(*args)
    E = co.shape[0]
    assert got.shape == ref.shape == (E, 7, 7, 3, 3)
    bound = 1e-6 * ref.abs().max().item()
    assert (got - ref).abs().max().item() <= bound
    # corr_case's wide-spread edges: pixels whose tap block overflows the
    # window take K3's zeroing branch
    Wy, Wx = planes[level - 1].shape[2:]
    over = (oy > Wy - 8) | (ox > Wx - 8)
    assert int(over.sum()) > 0
    per_pix = got.permute(0, 3, 4, 1, 2).reshape(E, 9, 49)
    ref_pix = ref.permute(0, 3, 4, 1, 2).reshape(E, 9, 49)
    assert (per_pix - ref_pix)[over].abs().max().item() <= bound
    assert not per_pix[over].any()


def test_corr_fused_matches_exact(cuda):
    g, f1, f2, co, kk, jj = _inputs(cuda, torch.bfloat16, seed=2)
    w1, w2, _, _ = _window(co, f1, f2)
    fits = ((w1[6] <= cf.WY - 8) & (w1[7] <= cf.WX - 8) &
            (w2[6] <= cf.WY2 - 8) & (w2[7] <= cf.WX2 - 8)).all(1)
    c1, c2 = cf.corr_fused(g, f1, f2, co, kk, jj)
    ex = corr_exact(g, f1, f2, co, kk, jj)
    planes = cf.planes(g.reshape(-1, 9, 128), f1, f2, kk, jj, w1[4], w1[5],
                       w2[4], w2[5])
    pmax = max(p.float().abs().max().item() for p in planes)
    err = (torch.stack([c1, c2], -1) - ex)[fits].abs().max().item()
    assert fits.float().mean().item() > 0.9
    assert err <= 2 ** -8 * pmax + 1e-5 * ex.abs().max().item()


def test_small_maps_take_the_exact_kernel(cuda):
    """Below D_MIN corr_fused runs the one-pass kernel (K1), exact up to
    the f32 sum order."""
    g, f1, f2, co, kk, jj = _inputs(cuda, torch.bfloat16, H1=48, W1=64,
                                    seed=3)
    before = (corr_onepass.launches, cf.plane_launches)
    c1, c2 = cf.corr_fused(g, f1, f2, co, kk, jj)
    torch.cuda.synchronize()
    assert (corr_onepass.launches, cf.plane_launches) == (before[0] + 1,
                                                           before[1])
    ex = corr_exact(g, f1, f2, co, kk, jj)
    got = torch.stack([c1, c2], -1)
    assert (got - ex).abs().max().item() <= 1e-5 * ex.abs().max().item()
    assert np.isfinite(got.cpu().numpy()).all()
