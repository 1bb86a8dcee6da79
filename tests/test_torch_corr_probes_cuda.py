"""The correlation probe kernels (K4-K8, csrc/corr_probes.cu) against their
plain PyTorch versions, on the card. Skips where no CUDA device exists (the
kernels have no CPU or interpret mode); run it on a GPU host with
`python -m pytest tests/test_torch_corr_probes_cuda.py -q`.

Bounds: bf16 outputs one bf16 rounding apart, |kernel - plain| <= 2^-7
|plain| + 1e-5 max|plain| (both sum the same f32 products of bf16 values in
another order, then round); f32 outputs (dots, first49) <= 1e-5
max|plain| (the sum order only). Window bases reach outside the maps, so
the zero fill is checked too. The persistent kernels (K6 dots, K5 / K7 /
K8 on K2's ring, K4's tile kernels) are also run at edge counts around
their grids, on a side stream and over NaN-filled memory; K6 dots on
windows of other lengths; K4 with unsorted edges, every edge in one bin,
maps smaller and taller than its tiles, and under
torch.cuda.set_sync_debug_mode('error'), so that a host synchronize in its
chain fails; the work items its chain makes (corr_probes.pair_work) equal
the emulation's (test_torch_corr_tiles.bin_items). K6 slab likewise: bases
across every border, bx off the 8-grid, every edge on one window, edge
counts around its cap and grid and the probe's E = 49,152, a side stream,
NaN-filled memory, sync debug mode 'error', and its work items
(corr_probes.slab_work) against test_torch_corr_tiles.slab_items."""
import numpy as np
import pytest
import torch

from dpvo_torch.ops import corr_probes as cp
from test_torch_corr_tiles import _slab_case, bin_work, slab_items

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


RING_KEYS = ('planes_roll', 'planes_w12x16', 'planes_fixedw',
             'planes_first49', 'planes_first49_streams')


def _streams(E, dev, seed):
    """Seeded inputs of K7's STREAMS=1 variant for E edges."""
    R = E * P2
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randint(-2 ** 31, 2 ** 31 - 1, (R, 1), device=dev,
                          generator=g, dtype=torch.int32),
            torch.randn(R, 2, device=dev, generator=g),
            torch.randint(-2 ** 31, 2 ** 31 - 1, (R, 1), device=dev,
                          generator=g, dtype=torch.int32),
            torch.randn(R, 2, device=dev, generator=g),
            torch.randn(7 * 24, 49, device=dev, generator=g),
            torch.randn(7 * 16, 49, device=dev, generator=g))


def _ring_calls(key, args, seed):
    """(kernel, plain) of the ring instantiation `key` on _maps' args; K5's
    rolls zero, odd, negative, at and past the level's positions and at
    the int32 extremes; K7 STREAMS=1 with seeded streams."""
    if key == 'planes_first49':
        return (lambda: cp.planes_first49(*args),
                lambda: cp.planes_first49_plain(*args))
    if key == 'planes_first49_streams':
        st = _streams(args[0].shape[0], args[0].device, seed)
        return (lambda: cp.planes_first49(*args, streams=st),
                lambda: cp.planes_first49_plain(*args))
    if key == 'planes_fixedw':
        return (lambda: cp.planes_fixedw(*args[:4]),
                lambda: cp.planes_fixedw_plain(*args[:4]))
    if key == 'planes_w12x16':
        return (lambda: cp.planes_w12x16(*args),
                lambda: cp.planes_w12x16_plain(*args))
    E, dev = args[0].shape[0], args[0].device
    rng = np.random.RandomState(seed)
    sh = []
    for n in (cp.WY * cp.WX, cp.WY2 * cp.WX2):
        v = rng.randint(-3 * n, 3 * n, E)
        ext = [0, 1, -1, -7, n, n + 3, 2 * n - 1, -n, 2 ** 31 - 1, -2 ** 31]
        v[:len(ext)] = ext[:E]
        sh.append(torch.from_numpy(v.astype(np.int32)).to(dev))
    return (lambda: cp.planes_roll(*args, *sh),
            lambda: cp.planes_roll_plain(*args, *sh))


@pytest.mark.parametrize('key', RING_KEYS)
def test_ring_probe_edge_counts(cuda, key):
    """E = 1, one below and one above the persistent grid, and 4,099, with
    windows across every border and a missing frame (jj = F)."""
    grid = cp.planes_ring_shape(key, 1 << 20)['grid']
    for E in (1, grid - 1, grid + 1, 4099):
        args = _maps(cuda, E=E, seed=E)
        fn, plain = _ring_calls(key, args, E)
        _close(_counted(key, fn), plain())


@pytest.mark.parametrize('key', RING_KEYS)
def test_ring_probe_writes_every_entry_and_repeats(cuda, key):
    """Outputs laid over NaN-filled memory come out finite (every entry
    written, zeros outside the map and for the missing frame), and a second
    call gives the same bits."""
    args = _maps(cuda, E=2048, seed=11)
    fn, plain = _ring_calls(key, args, 11)
    outs = []
    for _ in range(2):
        if key in cp.FIRST49:
            shapes, dt = [(2048 * P2, 49)] * 2, torch.float32
        else:
            n1 = 288 if key == 'planes_roll' else 192
            n2 = 160 if key == 'planes_roll' else 192
            shapes, dt = [(2048, P2, n1), (2048, P2, n2)], torch.bfloat16
        for shape in shapes:
            torch.full(shape, float('nan'), dtype=dt, device=cuda)
        got = _counted(key, fn)
        assert all(bool(torch.isfinite(o).all()) for o in got)
        outs.append([o.clone() for o in got])
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    _close(outs[0], plain())


@pytest.mark.parametrize('key', RING_KEYS)
def test_ring_probe_on_a_side_stream(cuda, key):
    args = _maps(cuda, E=999, seed=12)
    fn, plain = _ring_calls(key, args, 12)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        got = fn()
    torch.cuda.current_stream().wait_stream(s)
    _close(got, plain())


@pytest.mark.parametrize('key', RING_KEYS)
def test_ring_probe_launch_shape(cuda, key):
    """K2's ring shape for each probe: one producer warp beside the
    consumers, the ring of PLANES_RING and its slots and barriers in
    dynamic shared memory, the grid min(E, blocks per SM x SMs)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    stages, rows, warps, blocks = cp.PLANES_RING[key]
    sh = cp.planes_ring_shape(key, 1)
    assert (sh['stages'], sh['rows'], sh['warps']) == (stages, rows, warps)
    assert sh['threads'] == 32 * (warps + 1)
    assert sh['smem'] == cp.ring_smem(key)
    assert 1 <= sh['resident'] <= blocks
    full = sh['resident'] * sms
    for E in (1, 7, full - 1, full, full + 1, 49152, 49152 + 13):
        assert cp.planes_ring_shape(key, E)['grid'] == min(E, full), E


@pytest.mark.parametrize('E', [1, 100, 4099])
def test_first49_streams_equal_plain_variant(cuda, E):
    """K7 STREAMS=1 gives STREAMS=0's planes bit for bit, below, around and
    past the grid (the streams' reads cover S1 / S2 with a stride of the
    edges when E is small)."""
    args = _maps(cuda, E=E, seed=20 + E)
    a = _counted('planes_first49', lambda: cp.planes_first49(*args))
    b = _counted('planes_first49_streams', lambda: cp.planes_first49(
        *args, streams=_streams(E, cuda, E)))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    _close(a, cp.planes_first49_plain(*args))


def _pair_check(args):
    """K4 launched once against its plain version."""
    _close(_counted('planes_pair', lambda: cp.planes_pair(*args)),
           cp.planes_pair_plain(*args))


def _unsorted(args, seed):
    """_maps' args with the edges in a seeded random order."""
    perm = torch.from_numpy(np.random.RandomState(seed).permutation(
        args[0].shape[0])).to(args[0].device)
    return (args[0][perm].contiguous(), args[1], args[2],
            *(t[perm].contiguous() for t in args[3:]))


def test_planes_pair_around_the_grid(cuda):
    """E = 1, one below and above each tile kernel's grid, and 4,099, the
    edges unsorted, windows across every border and a missing frame."""
    grids = [cp.pair_shape(level, 1 << 20)['grid'] for level in (1, 2)]
    for E in sorted({1, *(g + d for g in grids for d in (-1, 1)), 4099}):
        _pair_check(_unsorted(_maps(cuda, E=E, seed=E), E))


def test_planes_pair_one_bin(cuda):
    """Every edge at one base of one frame (one bin of 3,000 edges at each
    level, split into items of PAIR_CAP), and every edge at one base with
    half of them in a missing frame."""
    g9, f1, f2, jj, by1, bx1, by2, bx2 = _maps(cuda, E=3000, seed=13)
    for j in (1, None):
        jj2 = torch.full_like(jj, 1)
        if j is None:
            jj2[::2] = 7
        _pair_check((g9, f1, f2, jj2, torch.full_like(by1, 50),
                     torch.full_like(bx1, 64), torch.full_like(by2, -3),
                     torch.full_like(bx2, 30)))


@pytest.mark.parametrize('H,W', [(10, 12), (120, 160), (200, 72)])
def test_planes_pair_map_sizes(cuda, H, W):
    """Maps smaller than the windows (one row bin at each level), the
    probe's 120x160 and a map whose level-2 map (50 rows) is taller than a
    level-2 tile, so that it takes several row bins; unsorted edges."""
    _pair_check(_unsorted(_maps(cuda, E=2000, H=H, W=W, seed=H), H))


def test_planes_pair_writes_every_entry_and_repeats(cuda):
    """Outputs over NaN-filled memory come out finite (zeros outside the
    map and for the missing frame), and a second call (its scratch
    reused) gives the same bits."""
    args = _unsorted(_maps(cuda, E=2048, seed=14), 14)
    outs = []
    for _ in range(2):
        for n in (288, 160):
            torch.full((2048, P2, n), float('nan'), dtype=torch.bfloat16,
                       device=cuda)
        got = _counted('planes_pair', lambda: cp.planes_pair(*args))
        assert all(bool(torch.isfinite(o).all()) for o in got)
        outs.append([o.clone() for o in got])
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    _close(outs[0], cp.planes_pair_plain(*args))


def test_planes_pair_on_a_side_stream(cuda):
    args = _unsorted(_maps(cuda, E=999, seed=15), 15)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        got = cp.planes_pair(*args)
    torch.cuda.current_stream().wait_stream(s)
    _close(got, cp.planes_pair_plain(*args))


def test_planes_pair_never_synchronizes(cuda):
    """The chain (binning, scan, scatter, both tile kernels) runs with no
    host synchronize or read-back: under sync debug mode 'error' any
    synchronizing call in the wrapper raises."""
    args = _maps(cuda, E=3000, seed=16)
    cp.planes_pair(*args)           # the library built, the shapes cached
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        got = cp.planes_pair(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _close(got, cp.planes_pair_plain(*args))


def test_planes_pair_items_match_emulation(cuda):
    """The work items K4's chain leaves on the card (first sorted
    position, edges, bin, tile positions) are the emulation's, item for
    item: unsorted edges across every border with a missing frame, maps
    smaller and taller than the tiles, every edge in one bin, and the
    probe's own inputs (micro_fused_v2)."""
    from dpvo_torch.scripts import micro_fused_v2
    cases = [_unsorted(_maps(cuda, E=2000, H=H, W=W, seed=H), H)
             for H, W in ((10, 12), (120, 160), (200, 72))]
    g9, f1, f2, jj, by1, bx1, by2, bx2 = _maps(cuda, E=3000, seed=13)
    cases.append((g9, f1, f2, torch.full_like(jj, 1),
                  torch.full_like(by1, 50), torch.full_like(bx1, 64),
                  torch.full_like(by2, -3), torch.full_like(bx2, 30)))
    cases.append(micro_fused_v2.inputs(cuda, 0.25, 0)['args'])
    for args in cases:
        work = _counted('planes_pair', lambda: cp.pair_work(*args))
        F, H1, W1 = args[1].shape[:3]
        ref = bin_work(*(t.cpu() for t in args[3:]), F, H1, W1,
                       *args[2].shape[1:3])
        for got, want in zip(work, ref):
            assert torch.equal(got, want)


@pytest.mark.parametrize('level', [1, 2])
def test_planes_pair_launch_shape(cuda, level):
    """Each tile kernel: one producer warp beside the consumers, the tile
    of PAIR_TILE, its slots and barriers in dynamic shared memory, the grid
    min(E, blocks per SM x SMs)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    rows, warps, blocks, unit = cp.PAIR_TILE[level]
    sh = cp.pair_shape(level, 1)
    assert (sh['rows'], sh['warps'], sh['cap'], sh['unit']) == (
        rows, warps, cp.PAIR_CAP, unit)
    assert sh['threads'] == 32 * (warps + 1)
    assert sh['smem'] == cp.pair_smem(level)
    assert 1 <= sh['resident'] <= blocks
    full = sh['resident'] * sms
    for E in (1, 7, full - 1, full, full + 1, 43008):
        assert cp.pair_shape(level, E)['grid'] == min(E, full), E


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


def _slab_args(dev, seed, E=160, H=40, W=56):
    """test_torch_corr_tiles._slab_case's inputs (bases across every
    border, bx off the 8-grid, shared windows) as CUDA tensors."""
    g, fmap, by, bx = _slab_case(seed, E=E, H=H, W=W)
    return (torch.from_numpy(g).to(dev).bfloat16(),
            torch.from_numpy(fmap).to(dev).bfloat16(),
            torch.from_numpy(by).to(dev), torch.from_numpy(bx).to(dev))


def _slab_check(args):
    """K6 slab launched once against its plain version."""
    _close([_counted('slab', lambda: cp.slab(*args))],
           [cp.slab_plain(*args)])


@pytest.mark.parametrize('seed,H,W', [(7, 40, 56), (8, 120, 160),
                                      (9, 10, 12), (10, 200, 72)])
def test_slab(cuda, seed, H, W):
    """Bases across every border (negative, half and wholly outside, far
    outside), bx off the 8-grid, shared windows; maps smaller than a
    window, the probe's 120x160, and taller and wider ones."""
    _slab_check(_slab_args(cuda, seed, E=3000, H=H, W=W))


def test_slab_probe_inputs(cuda):
    """The probe's own inputs, E = 49,152 (micro_corr_floor)."""
    from dpvo_torch.scripts import micro_corr_floor
    _slab_check(micro_corr_floor.slab_inputs(cuda))


def test_slab_edge_counts(cuda):
    """No edge (no launch), one, one below, at and above the cap, one
    below and above the tile kernel's grid, and 4,099."""
    g9, fmap, by, bx = _slab_args(cuda, 11, E=1)
    before = cp.launches['slab']
    out = cp.slab(g9[:0], fmap, by[:0], bx[:0])
    assert out.shape == (0, P2, 256) and cp.launches['slab'] == before
    cap, grid = cp.SLAB_TILE[1], cp.slab_shape(1 << 20)['grid']
    for E in (1, cap - 1, cap, cap + 1, grid - 1, grid + 1, 4099):
        _slab_check(_slab_args(cuda, E, E=E))


def test_slab_one_window(cuda):
    """Every edge on one window (one bin of 3,000 edges split into items
    of the cap), inside the map and across its corner."""
    g9, fmap, by, bx = _slab_args(cuda, 12, E=3000)
    for y, x in ((9, 24), (-5, -9)):
        _slab_check((g9, fmap, torch.full_like(by, y),
                     torch.full_like(bx, x)))


def test_slab_writes_every_entry_and_repeats(cuda):
    """Outputs over NaN-filled memory come out finite (zeros outside the
    map), and a second call (its scratch reused) gives the same bits."""
    args = _slab_args(cuda, 13, E=2048)
    outs = []
    for _ in range(2):
        torch.full((2048, P2, 256), float('nan'), dtype=torch.bfloat16,
                   device=cuda)
        got = _counted('slab', lambda: cp.slab(*args))
        assert bool(torch.isfinite(got).all())
        outs.append(got.clone())
    assert torch.equal(*outs)
    _close([outs[0]], [cp.slab_plain(*args)])


def test_slab_on_a_side_stream(cuda):
    args = _slab_args(cuda, 14, E=999)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        got = cp.slab(*args)
    torch.cuda.current_stream().wait_stream(s)
    _close([got], [cp.slab_plain(*args)])


def test_slab_never_synchronizes(cuda):
    """The chain (binning, scan, scatter, tile kernel) runs with no host
    synchronize or read-back (sync debug mode 'error')."""
    args = _slab_args(cuda, 15, E=3000)
    cp.slab(*args)              # the library built, the shape cached
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        got = cp.slab(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _close([got], [cp.slab_plain(*args)])


def test_slab_items_match_emulation(cuda):
    """The work items the slab's chain leaves on the card (first sorted
    position, edges, coarse bin, tile positions) are the emulation's,
    item for item: bases across every border on maps smaller and larger
    than a tile, every edge on one window, and the probe's own inputs."""
    from dpvo_torch.scripts import micro_corr_floor
    cases = [_slab_args(cuda, H, E=2000, H=H, W=W)
             for H, W in ((10, 12), (120, 160), (200, 72))]
    g9, fmap, by, bx = cases[1]
    cases.append((g9, fmap, torch.full_like(by, 9), torch.full_like(bx, 24)))
    cases.append(micro_corr_floor.slab_inputs(cuda))
    for args in cases:
        work = _counted('slab', lambda: cp.slab_work(*args))
        H, W = args[1].shape[:2]
        assert torch.equal(work, slab_items(args[2].cpu(), args[3].cpu(), H,
                                            W))


def test_slab_launch_shape(cuda):
    """The tile kernel: one producer warp beside the consumers, the tile
    of SLAB_TILE, its stage and barriers in dynamic shared memory, the grid
    min(E, blocks per SM x SMs)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    rows, cap, warps, blocks, unit_rows, unit, npass = cp.SLAB_TILE
    sh = cp.slab_shape(1)
    assert (sh['rows'], sh['cap'], sh['warps'], sh['unit_rows'], sh['unit'],
            sh['pass']) == (rows, cap, warps, unit_rows, unit, npass)
    assert sh['threads'] == 32 * (warps + 1)
    assert sh['smem'] == cp.slab_smem()
    assert 1 <= sh['resident'] <= blocks
    full = sh['resident'] * sms
    for E in (1, 7, full - 1, full, full + 1, 49152):
        assert cp.slab_shape(E)['grid'] == min(E, full), E


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
    fmap = f1[0]
    with pytest.raises(TypeError):
        cp.slab(g9.float(), fmap, by1, bx1)
    with pytest.raises(TypeError):
        cp.slab(g9, fmap.cpu(), by1, bx1)
    with pytest.raises(ValueError):
        cp.slab(g9, fmap, by1.long(), bx1)
    with pytest.raises(ValueError):
        cp.slab(g9, fmap, by1[:-1], bx1)
    assert cp.launches == before
