"""The hand-written correlation kernel against its plain PyTorch version,
on the card. Skips where no CUDA device exists (the kernel has no CPU or
interpret mode); run it on a GPU host with
`python -m pytest tests/test_torch_corr_cuda.py -q`."""
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
