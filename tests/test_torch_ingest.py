"""I420 ingest (UPLOAD_FORMAT=yuv420) in the port, against cv2 and dpvo_tpu.

Host side: dpvo_torch.runtime.i420.rgb_to_i420 is numpy, and must give
cv2.COLOR_RGB2YUV_I420's bytes exactly (dpvo_tpu packs with cv2), so the
port's uploads are the reference's bytes. Device side:
device_vo.i420_to_rgb against dpvo_tpu's _i420_to_rgb (the same f32
operations: within 1e-4) and against cv2's inverse (which rounds to uint8:
within 1.0).

Runs: the port's DeviceVO and HybridVO on yuv420 against dpvo_tpu's on
yuv420, the 16-frame slices of test_torch_runtime.py and
test_torch_hybrid.py, with their tolerances (poses within 1e-3 in f32,
1e-2 in bf16 for DeviceVO). Each dpvo_tpu run is made once per module.
"""
import numpy as np
import pytest
import torch

from dpvo_torch.config import cfg as torch_cfg
from dpvo_torch.runtime import DPVO as TorchDPVO
from dpvo_torch.runtime import DeviceVO, HybridVO
from dpvo_torch.runtime.device_vo import i420_to_rgb, unpack_frame
from dpvo_torch.runtime.i420 import rgb_to_i420
from test_torch_hybrid import check_slice
from test_torch_runtime import (H, INTR, NPZ, POSE_TOL, POSE_TOL_BF16, W,
                                _cfg, _frames, _run_jax, _run_torch,
                                one_torch_thread)  # noqa: F401

cv2 = pytest.importorskip('cv2')

pytestmark = pytest.mark.usefixtures('one_torch_thread')
YUV = dict(UPLOAD_FORMAT='yuv420')


@pytest.mark.parametrize('hw', [(48, 64), (64, 96), (480, 640)])
def test_rgb_to_i420_bit_exact_with_cv2(hw):
    for seed in range(2):
        img = np.random.RandomState(seed).randint(0, 256, hw + (3,),
                                                  np.uint8)
        np.testing.assert_array_equal(
            rgb_to_i420(img), cv2.cvtColor(img, cv2.COLOR_RGB2YUV_I420))


def test_rgb_to_i420_refuses_odd_dims():
    with pytest.raises(ValueError, match='even'):
        rgb_to_i420(np.zeros((63, 96, 3), np.uint8))


def test_i420_to_rgb_matches_jax_and_cv2():
    import jax.numpy as jnp
    from dpvo_tpu.runtime.device_vo import _i420_to_rgb
    img = np.random.RandomState(7).randint(0, 255, (48, 64, 3), np.uint8)
    yuv = cv2.cvtColor(img, cv2.COLOR_RGB2YUV_I420)
    got = i420_to_rgb(torch.from_numpy(yuv.ravel()), 48, 64).numpy()
    ref = np.asarray(_i420_to_rgb(jnp.asarray(yuv.ravel()), 48, 64))
    assert got.dtype == np.float32 and got.shape == (48, 64, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    want = cv2.cvtColor(yuv, cv2.COLOR_YUV2RGB_I420).astype(np.float32)
    assert np.abs(got - want).max() < 1.0


@pytest.mark.parametrize('offset', [0, 1])
def test_unpack_frame_reads_aux_at_any_offset(offset):
    """The aux bytes are reinterpreted in place at a 4-byte-aligned offset
    and copied first at any other; both give the packed values."""
    M, ht, wd = 8, 6, 10
    rng = np.random.RandomState(offset)
    img = rng.randint(0, 255, (ht, wd, 3), np.uint8)
    aux = rng.rand(M, 4).astype(np.float32)
    for upload, pix in (('rgb', img), ('yuv420', rgb_to_i420(img))):
        row = np.concatenate([pix.ravel(), aux.view(np.uint8).ravel()])
        buf = torch.from_numpy(np.concatenate([np.zeros(offset, np.uint8),
                                               row]))[offset:]
        image, got = unpack_frame(buf, ht=ht, wd=wd, M=M, upload=upload)
        np.testing.assert_array_equal(got.numpy(), aux)
        want = (torch.from_numpy(img) if upload == 'rgb' else
                i420_to_rgb(torch.from_numpy(pix.ravel()), ht, wd))
        assert torch.equal(image, want)


@pytest.mark.parametrize('runtime', ['DeviceVO', 'HybridVO'])
def test_odd_dims_fall_back_to_rgb(runtime, capsys):
    c = _cfg(torch_cfg, **YUV)
    if runtime == 'HybridVO':
        c.CENTROID_SEL_STRAT = 'GRADIENT_BIAS'
    vo = TorchDPVO(c, NPZ, ht=63, wd=96, device='cpu')
    assert type(vo).__name__ == runtime and vo._upload == 'rgb'
    assert 'needs even dims, got 63x96' in capsys.readouterr().out


def test_upload_format_refuses_unknown():
    with pytest.raises(ValueError, match='UPLOAD_FORMAT'):
        DeviceVO(_cfg(torch_cfg, UPLOAD_FORMAT='nv12'), NPZ, ht=H, wd=W,
                 device='cpu')


def test_device_vo_uploads_half_the_bytes():
    """One copy per frame: the I420 planes (1.5 B/px) and the aux bytes."""
    frames = _frames(3)
    sent = {}
    for fmt in ('rgb', 'yuv420'):
        vo = DeviceVO(_cfg(torch_cfg, UPLOAD_FORMAT=fmt), NPZ, ht=H, wd=W,
                      seed=0, device='cpu')
        vo.force_accept = True
        for t, img in enumerate(frames):
            vo(t, img, INTR)
        sent[fmt] = vo.h2d_bytes / len(frames)
    assert sent == {'rgb': H * W * 3 + 16 * 8,
                    'yuv420': H * W * 3 // 2 + 16 * 8}


@pytest.fixture(scope='module')
def device_runs():
    frames = _frames(16)
    return {mixed: (_run_jax(frames, True, MIXED_PRECISION=mixed, **YUV),
                    _run_torch(frames, True, MIXED_PRECISION=mixed, **YUV))
            for mixed in (False, True)}


@pytest.mark.parametrize('mixed', [False, True])
def test_device_vo_yuv420_matches_jax(device_runs, mixed):
    (jp, jn, jc, jclr), (tp, tn, tc, tclr) = device_runs[mixed]
    assert (tn, tc) == (jn, jc) and tn <= 16 - 4
    np.testing.assert_allclose(tp, jp, rtol=0,
                               atol=POSE_TOL_BF16 if mixed else POSE_TOL)
    assert np.abs(tclr.astype(int) - jclr).max() <= 1
    assert np.abs(tp[:, :3]).max() > 1e-2


def test_device_vo_yuv420_stays_near_rgb(device_runs):
    """Chroma subsampling perturbs the pixels a little; the trajectory
    stays in the rgb run's regime (dpvo_tpu's test_yuv_ingest bound)."""
    rgb = _run_torch(_frames(16), True)[0]
    assert np.abs(device_runs[False][1][0] - rgb).max() < 0.5


def test_hybrid_yuv420_matches_jax():
    """HybridVO uploads the (3h/2, w) plane stack; frame_step converts."""
    tv, tp = check_slice(_frames(16), POSE_TOL, **YUV)
    assert tv._upload == 'yuv420' and isinstance(tv, HybridVO)
    assert tv.n <= 16 - 4
