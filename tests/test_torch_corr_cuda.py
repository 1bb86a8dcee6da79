"""The hand-written correlation kernel against its plain PyTorch version,
on the card. Skips where no CUDA device exists (the kernel has no CPU or
interpret mode); run it on a GPU host with
`python -m pytest tests/test_torch_corr_cuda.py -q`.

With bf16 maps the kernel takes a pixel's taps from its edge's union box in
shared memory or, where the window overflows the box, from global memory;
ops/corr_onepass.py:box_fits says which, and the cases below hold each
branch against the plain version on its own."""
import numpy as np
import pytest
import torch

from chip_smoke import corr_case as make_case
from dpvo_torch.ops import corr_onepass
from dpvo_torch.ops.corr import corr_two_level as corr_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel runs only on the card')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _run(case, dev, dtype, out_dtype, nv):
    gmap, f1, f2, coords, kk, jj = case
    t = [torch.from_numpy(a).to(dev) for a in (gmap, f1, f2)]
    t = [a.to(dtype) for a in t]
    co, kk_t, jj_t = (torch.from_numpy(a).to(dev) for a in (coords, kk, jj))
    before = corr_onepass.launches
    out = corr_onepass.corr_two_level(*t, co, kk_t, jj_t, nv=nv,
                                      out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert corr_onepass.launches == before + 1
    ref = corr_plain(*t, co, kk_t, jj_t, nv=nv, out_dtype=torch.float32)
    return out.float(), ref


@pytest.mark.parametrize('dtype, out_dtype', [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
def test_kernel_matches_plain(cuda, dtype, out_dtype):
    E, nv = 1536, 1237
    case = make_case(E, F=3, H1=120, W1=160, Ng=64, seed=0)
    out, ref = _run(case, cuda, dtype, out_dtype, nv)
    scale = ref.abs().max().item()
    # f32 out: the kernel and the plain version sum the same f32 products
    # in another order (~1e-6 relative); bf16 out adds one rounding (2^-8)
    tol = 1e-5 * scale if out_dtype == torch.float32 else 2 ** -8 * scale
    err = (out[:nv] - ref[:nv]).abs().max().item()
    assert err <= tol, (err, tol)
    assert bool((out[nv:] == 0).all())
    # every border / outside class produced exact zeros where the plain did
    assert bool(((ref == 0) == (out == 0)).float().mean() > 0.999)


def test_kernel_contiguous_rows_m48(cuda):
    """M = 48 (fast.yaml): pair-blocked kk rows that straddle any 32-edge
    block — the kernel reads each edge's own row."""
    M, G = 48, 24
    kk = (np.repeat(np.arange(G) % 7, M) * M + np.tile(np.arange(M), G))
    case = make_case(M * G, F=4, H1=120, W1=160, Ng=7 * M, seed=1, kk=kk)
    out, ref = _run(case, cuda, torch.bfloat16, torch.float32, M * G)
    scale = ref.abs().max().item()
    assert (out - ref).abs().max().item() <= 1e-5 * scale


def _spread_case(E, sp_lo, sp_hi, seed, H1=120, W1=160):
    """corr_case's maps with every edge's 3x3 pixel spread drawn from
    [sp_lo, sp_hi] px (times 2 over the patch) around interior centres."""
    gmap, f1, f2, _, kk, jj = make_case(E, F=3, H1=H1, W1=W1, Ng=64,
                                        seed=seed)
    rng = np.random.RandomState(seed + 100)
    c = np.stack([rng.uniform(8, W1 - 9, E), rng.uniform(8, H1 - 9, E)], -1)
    sp = rng.uniform(sp_lo, sp_hi, (E, 1, 1))
    off = np.linspace(-1.0, 1.0, 3)
    coords = np.stack(np.broadcast_arrays(
        c[:, 0, None, None] + sp * off[None, None, :],
        c[:, 1, None, None] + sp * off[None, :, None]), -1)
    coords += rng.uniform(-.3, .3, coords.shape)
    return gmap, f1, f2, coords.astype(np.float32), kk, jj


def _branch_errors(case, dev, dtype, out_dtype, nv):
    """max |kernel - plain| over the live pixels of each branch (fit, overflow)
    and the tolerance, from one launch."""
    out, ref = _run(case, dev, dtype, out_dtype, nv)
    H1, W1 = case[1].shape[1:3]
    fits = corr_onepass.box_fits(torch.from_numpy(case[3]).to(dev), H1, W1,
                                 H1 // 4, W1 // 4)
    live = torch.arange(out.shape[0], device=dev)[:, None, None, None] < nv
    d = (out - ref).abs()
    scale = ref.abs().max().item()
    tol = 1e-5 * scale if out_dtype == torch.float32 else 2 ** -8 * scale
    # masks (E, 1, 1, 3, 3, 2) over out's (E, dx, dy, py, px, lvl)
    errs = [d.masked_fill(~(m & live)[:, None, None], 0).max().item()
            for m in (fits, ~fits)]
    assert bool((out[nv:] == 0).all())
    return fits[:nv], errs, tol


@pytest.mark.parametrize('dtype, out_dtype', [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
def test_both_branches_match_plain(cuda, dtype, out_dtype):
    """corr_case: 1/16 of the edges spread up to ~18 px, so some pixels
    overflow their box at both levels; every other edge fits. f32 maps take
    the unchanged f32 kernel; the same pixels are held apart all the same."""
    E, nv = 3072, 2900
    case = make_case(E, F=3, H1=120, W1=160, Ng=64, seed=2)
    fits, (err_fit, err_ovf), tol = _branch_errors(case, cuda, dtype,
                                                   out_dtype, nv)
    for lvl in range(2):
        assert fits[..., lvl].any() and not fits[..., lvl].all(), lvl
    assert err_fit <= tol, (err_fit, tol)
    assert err_ovf <= tol, (err_ovf, tol)


def test_every_edge_overflows(cuda):
    """Spreads of 24-40 px: every edge has pixels outside its box at both
    levels."""
    E = 768
    case = _spread_case(E, 12.0, 20.0, seed=3)
    fits, (err_fit, err_ovf), tol = _branch_errors(
        case, cuda, torch.bfloat16, torch.float32, E)
    assert not fits.reshape(E, 9, 2).all(1).any()
    assert err_fit <= tol and err_ovf <= tol, (err_fit, err_ovf, tol)


def test_no_edge_overflows(cuda):
    """Spreads under 2 px: every pixel's window fits its box."""
    E = 768
    case = _spread_case(E, 0.2, 0.7, seed=4)
    fits, (err_fit, err_ovf), tol = _branch_errors(
        case, cuda, torch.bfloat16, torch.float32, E)
    assert fits.all()
    assert err_fit <= tol and err_ovf == 0.0, (err_fit, err_ovf, tol)
