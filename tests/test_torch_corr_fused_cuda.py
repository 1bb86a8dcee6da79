"""The planes kernel (K2) and the tap-select kernel (K3) against their plain
PyTorch versions, on the card. Skips where no CUDA device exists (the
kernels have no CPU or interpret mode); run it on a GPU host with
`python -m pytest tests/test_torch_corr_fused_cuda.py -q`.

Bounds: K2 vs plain, one bf16 rounding of each plane entry (both sum the
same f32 products in another order): 2^-7 |plain| + 1e-5 max|plain|, and
exact zeros outside the map. K2's bf16 kernel (corr_planes_ring, a
persistent grid) is also run at edge counts around its grid, with window
bases at every border and far outside, with out-of-range kk / jj and on a
side stream. K3 vs
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


def _planes_case(dev, dtype, E, seed, F=3, Ng=64, H1=120, W1=160):
    """Seeded maps and window bases: corr_case's windows, then, on the
    first edges, every border of both maps exactly and one past, far
    outside at either end, and kk / jj out of range (-1, Ng, F)."""
    g, f1, f2, co, kk, jj = _inputs(dev, dtype, E=E, F=F, H1=H1, W1=W1,
                                    Ng=Ng, seed=seed)
    w1, w2, (H1, W1), (H2, W2) = _window(co, f1, f2)
    by1, bx1, by2, bx2 = (t.clone() for t in (w1[4], w1[5], w2[4], w2[5]))
    kk, jj = kk.clone(), jj.clone()
    border = [(-11, -16, -9, -12), (H1 - 1, W1 - 8, H2 - 1, W2 - 4),
              (0, -8, 0, -4), (H1 - 12, W1 - 24, H2 - 10, W2 - 16),
              (-10 ** 6, 10 ** 6, 10 ** 6, -10 ** 6),
              (10 ** 6, -10 ** 6, -10 ** 6, 10 ** 6)]
    for i, b in enumerate(border[:E]):
        for t, v in zip((by1, bx1, by2, bx2), b):
            t[i] = v
    bad = [(-1, 0), (0, -1), (Ng, 0), (0, F), (Ng + 3, F + 7)]
    for i, (k, j) in enumerate(bad[:max(0, E - len(border))]):
        e = len(border) + i
        kk[e] = k if k else kk[e]
        jj[e] = j if j else jj[e]
    return (g.reshape(-1, 9, 128), f1, f2, kk, jj, by1, bx1, by2, bx2)


def _assert_planes(got, ref):
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.bfloat16
        a, b = a.float(), b.float()
        bound = 2 ** -7 * b.abs() + 1e-5 * b.abs().max()
        assert bool(torch.isfinite(a).all())
        assert bool(((a - b).abs() <= bound).all()), (a - b).abs().max()
        assert bool((a[b == 0] == 0).all())


def test_planes_shape(cuda):
    """The bf16 kernel's launch shape: the ring of ops/corr_fused.py, its
    shared memory, a persistent grid of as many blocks as fit."""
    sh = cf.planes_shape(49152)
    props = torch.cuda.get_device_properties(cuda)
    assert (sh['stages'], sh['rows'], sh['warps']) == (
        cf.RING_STAGES, cf.RING_ROWS, cf.RING_WARPS)
    assert sh['threads'] == 32 * (cf.RING_WARPS + 1)
    assert sh['smem'] == cf.ring_smem()
    assert sh['resident'] >= 1 and 0 < sh['regs'] <= 255
    assert sh['grid'] == sh['resident'] * props.multi_processor_count
    assert cf.planes_shape(5)['grid'] == 5


@pytest.mark.parametrize('around', [-1, 0, 1])
def test_ring_edges_around_the_grid(cuda, around):
    """E one below, at and one above the persistent grid: every block takes
    one edge, or one block takes two."""
    E = cf.planes_shape(49152)['grid'] + around
    args = _planes_case(cuda, torch.bfloat16, E, seed=10 + around)
    _assert_planes(cf.planes(*args), cf.planes_plain(*args))


@pytest.mark.parametrize('E', [1, 2, 3, 17, 2000])
def test_ring_borders_and_bad_edges(cuda, E):
    """Windows at every border and far outside, and out-of-range kk / jj
    (all-zero planes), at small and larger edge counts."""
    args = _planes_case(cuda, torch.bfloat16, E, seed=E)
    got = cf.planes(*args)
    _assert_planes(got, cf.planes_plain(*args))
    if E >= 11:
        for p in got:
            assert not p[6:11].any()        # the out-of-range kk / jj


def test_ring_on_a_side_stream(cuda):
    args = _planes_case(cuda, torch.bfloat16, 3000, seed=5)
    ref = cf.planes_plain(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = cf.planes(*args)
    torch.cuda.current_stream().wait_stream(side)
    _assert_planes(got, ref)


@pytest.mark.parametrize('dtype,kernel', [
    (torch.bfloat16, 'corr_planes_ring'), (torch.float32, 'corr_planes_kernel')])
def test_maps_dtype_picks_the_kernel(cuda, dtype, kernel):
    """bf16 maps launch the ring kernel, f32 maps the FMA kernel (by the
    names in a profiler trace), both against planes_plain. One launch
    before the profiler's window builds and loads the kernel, so that the
    traced launch is not the first (CUPTI starts lazily)."""
    from torch.profiler import ProfilerActivity, profile
    args = _planes_case(cuda, dtype, 1000, seed=7)
    cf.planes(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = cf.planes(*args)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    assert any(kernel in n for n in names), names
    other = {'corr_planes_ring', 'corr_planes_kernel'} - {kernel}
    assert not any(o in n for n in names for o in other), names
    _assert_planes(got, cf.planes_plain(*args))
