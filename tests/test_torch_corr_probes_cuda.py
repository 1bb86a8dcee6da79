"""The correlation probe kernels (K4-K8, csrc/corr_probes.cu) against their
plain PyTorch versions, on the card. Skips where no CUDA device exists (the
kernels have no CPU or interpret mode); run it on a GPU host with
`python -m pytest tests/test_torch_corr_probes_cuda.py -q`.

Bounds: bf16 outputs one bf16 rounding apart, |kernel - plain| <= 2^-7
|plain| + 1e-5 max|plain| (both sum the same f32 products of bf16 values in
another order, then round); f32 outputs (dots, first49) <= 1e-5
max|plain| (the sum order only). Window bases reach outside the maps, so
the zero fill is checked too. K6's persistent dots kernel is also run at
edge counts around its grid, on windows of other lengths and on a side
stream."""
import numpy as np
import pytest
import torch

from dpvo_torch.ops import corr_probes as cp

pytestmark = pytest.mark.cuda

C, P2 = 128, 9


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels run only on the card')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _close(got, ref):
    """Kernel outputs against plain ones, each output's type deciding its
    bound (module docstring)."""
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        m = b.float().abs().max()
        d = (a.float() - b.float()).abs()
        bound = (2 ** -7 * b.float().abs() + 1e-5 * m
                 if b.dtype == torch.bfloat16 else 1e-5 * m)
        assert bool((d <= bound).all()), d.max()


def _maps(dev, E=1536, F=3, H=120, W=160, seed=0):
    rng = np.random.RandomState(seed)

    def bf(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            dev).bfloat16()

    def ints(lo, hi):
        return torch.from_numpy(rng.randint(lo, hi, E).astype(np.int32)).to(
            dev)

    g9, f1, f2 = bf(E, P2, C), bf(F, H, W, C), bf(F, H // 4, W // 4, C)
    # bases from well outside the map to past its far edge; jj includes
    # one frame out of range (all zero)
    jj = torch.sort(ints(0, F + 1)).values.int().contiguous()
    return (g9, f1, f2, jj, ints(-14, H), ints(-26, W), ints(-12, H // 4),
            ints(-18, W // 4))


def _counted(key, fn):
    before = cp.launches[key]
    out = fn()
    torch.cuda.synchronize()
    assert cp.launches[key] == before + 1
    return out


def test_planes_pair(cuda):
    args = _maps(cuda)
    got = _counted('planes_pair', lambda: cp.planes_pair(*args))
    _close(got, cp.planes_pair_plain(*args))
    # an odd edge count leaves the last block's second edge empty
    g9, f1, f2, *ints = args
    odd = (g9[:-1], f1, f2, *(t[:-1] for t in ints))
    _close(cp.planes_pair(*odd), cp.planes_pair_plain(*odd))


def test_planes_roll(cuda):
    args = _maps(cuda, seed=1)
    E = args[0].shape[0]
    rng = np.random.RandomState(2)
    sh1 = torch.from_numpy(rng.randint(-300, 600, E).astype(np.int32)).to(
        cuda)
    sh2 = torch.from_numpy(rng.randint(-20, 20, E).astype(np.int32)).to(cuda)
    got = _counted('planes_roll', lambda: cp.planes_roll(*args, sh1, sh2))
    _close(got, cp.planes_roll_plain(*args, sh1, sh2))


def test_planes_first49_and_streams(cuda):
    args = _maps(cuda, seed=3)
    R = args[0].shape[0] * P2
    g = torch.Generator(device=cuda).manual_seed(4)
    streams = (torch.randint(-2 ** 31, 2 ** 31 - 1, (R, 1), device=cuda,
                             generator=g, dtype=torch.int32),
               torch.randn(R, 2, device=cuda, generator=g),
               torch.randint(-2 ** 31, 2 ** 31 - 1, (R, 1), device=cuda,
                             generator=g, dtype=torch.int32),
               torch.randn(R, 2, device=cuda, generator=g),
               torch.randn(7 * 24, 49, device=cuda, generator=g),
               torch.randn(7 * 16, 49, device=cuda, generator=g))
    a = _counted('planes_first49', lambda: cp.planes_first49(*args))
    _close(a, cp.planes_first49_plain(*args))
    b = _counted('planes_first49_streams',
                 lambda: cp.planes_first49(*args, streams=streams))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize('fixed', [False, True])
def test_planes_w12x16(cuda, fixed):
    args = _maps(cuda, seed=5)
    if fixed:
        got = _counted('planes_fixedw', lambda: cp.planes_fixedw(*args[:4]))
        _close(got, cp.planes_fixedw_plain(*args[:4]))
    else:
        got = _counted('planes_w12x16', lambda: cp.planes_w12x16(*args))
        _close(got, cp.planes_w12x16_plain(*args))


def _dots_inputs(dev, E, W=384, seed=6):
    rng = np.random.RandomState(seed)
    g9 = torch.from_numpy(rng.randn(E, P2, C).astype(np.float32)).to(
        dev).bfloat16()
    win = torch.from_numpy(rng.randn(E, W, C).astype(np.float32)).to(
        dev).bfloat16()
    return g9, win


def _check_dots(g9, win):
    """dots (if win has 384 rows) and dots2 against their plain versions,
    each launched once."""
    E = g9.shape[0]
    if win.shape[1] == 384:
        got = _counted('dots', lambda: cp.dots(g9, win))
        assert got.shape == (E, P2, 384) and got.dtype == torch.float32
        _close([got], [cp.dots_plain(g9, win)])
    got = _counted('dots2', lambda: cp.dots2(g9, win))
    assert got.shape == (E, P2, 256) and got.dtype == torch.bfloat16
    _close([got], [cp.dots2_plain(g9, win)])


def test_dots(cuda):
    _check_dots(*_dots_inputs(cuda, 1024))


@pytest.mark.parametrize('E', [1, 131, 133, 1029, 4099])
def test_dots_edge_counts(cuda, E):
    """Fewer edges than the persistent grid, not a multiple of it, and a
    few edges past it."""
    _check_dots(*_dots_inputs(cuda, E, seed=E))


def test_dots_around_the_grid(cuda):
    """E one below, at, and one above the grid, and one past twice it:
    the last blocks take one edge more or less than the others."""
    for key in ('dots', 'dots2'):
        grid = cp.dots_shape(key, 1 << 20)['grid']
        for E in (grid - 1, grid, grid + 1, 2 * grid + 1):
            g9, win = _dots_inputs(cuda, E, seed=E)
            fn = cp.dots if key == 'dots' else cp.dots2
            plain = cp.dots_plain if key == 'dots' else cp.dots2_plain
            _close([_counted(key, lambda: fn(g9, win))], [plain(g9, win)])


@pytest.mark.parametrize('W', [256, 384, 400])
def test_dots2_window_rows(cuda, W):
    """dots2 reads the first 256 rows of windows of W rows."""
    _check_dots(*_dots_inputs(cuda, 777, W=W, seed=W))


def test_dots_on_a_side_stream(cuda):
    g9, win = _dots_inputs(cuda, 999, seed=9)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        a = cp.dots(g9, win)
        b = cp.dots2(g9, win)
    torch.cuda.current_stream().wait_stream(s)
    _close([a, b], [cp.dots_plain(g9, win), cp.dots2_plain(g9, win)])


def test_dots_write_every_entry_and_repeat(cuda):
    """Outputs laid over NaN-filled memory come out finite (every entry
    written), and a second call on the same inputs and the reused buffer
    gives the same bits."""
    g9, win = _dots_inputs(cuda, 2048, seed=10)
    for key, fn in (('dots', cp.dots), ('dots2', cp.dots2)):
        n = 384 if key == 'dots' else 256
        dt = torch.float32 if key == 'dots' else torch.bfloat16
        outs = []
        for _ in range(2):
            torch.full((2048, P2, n), float('nan'), dtype=dt, device=cuda)
            outs.append(fn(g9, win))
            torch.cuda.synchronize()
            assert bool(torch.isfinite(outs[-1]).all())
            outs[-1] = outs[-1].clone()
        assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize('key', ['dots', 'dots2'])
def test_dots_launch_shape(cuda, key):
    """The persistent grid is min(E, blocks per SM x SMs), and the shape
    is the ring's: one producer warp beside the consumers, the stages and
    the g double buffer with their barriers in dynamic shared memory."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    sh = cp.dots_shape(key, 1)
    assert sh['threads'] == 32 * (sh['warps'] + 1)
    assert sh['smem'] == sh['stages'] * sh['rows'] * 256 + 2 * P2 * 256 \
        + 8 * (2 * sh['stages'] + 4)
    assert (256 if key == 'dots2' else 384) % sh['rows'] == 0
    full = sh['resident'] * sms
    for E in (1, 7, full - 1, full, full + 1, 49152, 49152 + 13):
        assert cp.dots_shape(key, E)['grid'] == min(E, full), E


def test_slab(cuda):
    rng = np.random.RandomState(7)
    E, H, W = 1024, 120, 160
    g9 = torch.from_numpy(rng.randn(E, P2, C).astype(np.float32)).to(
        cuda).bfloat16()
    fmap = torch.from_numpy(rng.randn(H, W, C).astype(np.float32)).to(
        cuda).bfloat16()
    by = torch.from_numpy(rng.randint(-20, H, E).astype(np.int32)).to(cuda)
    bx = torch.from_numpy(rng.randint(-20, W, E).astype(np.int32)).to(cuda)
    got = _counted('slab', lambda: cp.slab(g9, fmap, by, bx))
    _close([got], [cp.slab_plain(g9, fmap, by, bx)])


def test_wrappers_raise_instead_of_falling_back(cuda):
    g9, f1, f2, jj, by1, bx1, by2, bx2 = _maps(cuda, E=64)
    before = dict(cp.launches)
    with pytest.raises(TypeError):
        cp.planes_pair(g9.float(), f1, f2, jj, by1, bx1, by2, bx2)
    with pytest.raises(ValueError):
        cp.planes_roll(g9, f1, f2, jj, by1, bx1, by2, bx2, by1.long(), bx1)
    with pytest.raises(ValueError):
        cp.dots(g9, torch.zeros(64, 256, C, device=cuda,
                                dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        cp.dots2(g9, torch.zeros(64, 200, C, device=cuda,
                                 dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        cp.slab(g9, f1, by1, bx1)
    assert cp.launches == before
