"""dpvo_torch's projective.py, utils/ and the ops helpers (pyramidify,
extract_patches' raw mode, segment_mean, the package exports) and
runtime/device_vo.vo_frame_packed against dpvo_tpu on the same seeded numpy
inputs.

Tolerances, each with its reason:
- pixels (O(100)) and the analytic Jacobians (entries up to ~1e3): both
  sides run the same f32 formulas in another order, so they agree to a few
  f32 ulps of the value: rtol 1e-5 with an atol of 1e-5 of the largest
  entry (where a sum cancels to ~0);
- validity flags, grids, pair lists and raw windows: exact;
- the analytic Jacobians against torch.func.jacrev of the port's own
  transform in f64: both are exact derivatives of the centre tap's pixel,
  so they agree to f64 rounding: rtol 1e-9, atol 1e-9;
- vo_frame_packed against vo_frame: the same function on the same inputs,
  so the states are bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpvo_torch import lie as tl
from dpvo_torch import projective as tp
from dpvo_tpu import lie as jl
from dpvo_tpu import projective as jp

CPU = 'cpu'
P = 3


def _jax(fn, *args):
    """fn on numpy args under one jax.jit; returns numpy."""
    return jax.tree_util.tree_map(np.array, jax.jit(fn)(*args))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(out, ref, rtol=1e-5):
    out, ref = out.detach().numpy(), np.asarray(ref)
    atol = 1e-5 * max(np.abs(ref).max(), 1e-30)
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=atol)


def make_scene(group, seed=7, n_frames=5, n_patches=6):
    """tests/test_projective.py's scene (random poses near the identity,
    3x3 patches at inverse depths 0.3-2 in a 160x120 image), plus a fifth
    frame 1 ahead on the optical axis, so that patches seen from frame 0
    land at Z ~ 1 - d: some under the 0.2 gate, one (d = 1.8) behind the
    camera.
    Sim3 poses get random scales exp(0.1 N(0, 1))."""
    rng = np.random.RandomState(seed)
    xi = rng.randn(n_frames, 6).astype(np.float32) * 0.1
    xi[-1] = 0.0
    poses = _jax(jl.se3_exp, xi)
    poses[-1, 2] = -1.0
    if group == 'sim3':
        s = np.exp(rng.randn(n_frames, 1) * 0.1).astype(np.float32)
        poses = np.concatenate([poses, s], axis=-1)
    intr = np.tile(np.array([120.0, 110.0, 80.0, 60.0], np.float32),
                   (n_frames, 1))
    c = np.stack([rng.uniform(20, 140, n_patches),
                  rng.uniform(20, 100, n_patches)], -1).astype(np.float32)
    g = np.arange(-1, 2, dtype=np.float32)
    gx = np.broadcast_to(c[:, 0, None, None] + g[None, None, :],
                         (n_patches, P, P))
    gy = np.broadcast_to(c[:, 1, None, None] + g[None, :, None],
                         (n_patches, P, P))
    d = rng.uniform(0.3, 2.0, (n_patches, 1, 1))
    d[-1] = 1.8                            # behind frame 4's camera
    d = np.broadcast_to(d, (n_patches, P, P)).astype(np.float32)
    patches = np.ascontiguousarray(np.stack([gx, gy, d], axis=1))
    ii = np.array([0, 1, 2, 0, 3, 0, 0, 0, 2], np.int32)
    jj = np.array([1, 2, 3, 3, 0, 4, 4, 4, 2], np.int32)
    kk = np.array([0, 1, 2, 3, 4, 0, 3, 5, 1], np.int32)
    return poses, patches, intr, ii, jj, kk


def test_iproj_proj():
    poses, patches, intr, ii, *_ = make_scene('se3')
    intr = intr[ii[:6]]
    X = _t(_jax(jp.iproj, patches, intr))
    _close(tp.iproj(_t(patches), _t(intr)), X.numpy())
    X[0, :, :, 2] = 0.05                  # under proj's 0.1 clamp
    for depth in (False, True):
        ref = _jax(lambda x, k: jp.proj(x, k, depth=depth), X.numpy(), intr)
        _close(tp.proj(X, _t(intr), depth=depth), ref)
    assert tp.MIN_DEPTH == jp.MIN_DEPTH


FLAGS = [dict(), dict(valid=True), dict(tonly=True), dict(jacobian=True),
         dict(tonly=True, valid=True)]


@pytest.mark.parametrize('flags', FLAGS, ids=lambda f: '-'.join(f) or 'plain')
@pytest.mark.parametrize('group', ['se3', 'sim3'])
def test_transform_matches(group, flags):
    scene = make_scene(group)
    ref = _jax(lambda *a: jp.transform(*a, group=group, **flags), *scene)
    out = tp.transform(*map(_t, scene), group=group, **flags)
    ref = ref if isinstance(ref, (list, tuple)) else [ref]
    out = out if isinstance(out, tuple) else (out,)
    _close(out[0], ref[0])
    if len(out) > 1:                       # the validity flags, exactly
        np.testing.assert_array_equal(out[1].numpy(), ref[1])
        assert 0 < out[1].sum() < out[1].numel()
    if flags.get('jacobian'):
        dof = 7 if group == 'sim3' else 6
        for o, r, shape in zip(out[2], ref[2], [(9, 2, dof), (9, 2, dof),
                                                (9, 2, 1)]):
            assert o.shape == shape
            _close(o, r)


@pytest.mark.parametrize('group', ['se3', 'sim3'])
def test_jacobians_match_jacrev_f64(group):
    """Ji, Jj, Jz against torch.func.jacrev of the centre tap w.r.t. a left
    retraction of every pose and the patches' inverse depths, in f64, on
    the edges in front of the camera (Z > 0.2). Edges under the |Z| > 0.2
    gate have zero Jacobians by design (autodiff's are not) and are held to
    zero; behind the camera (Z < -0.2) proj's clamp makes autodiff's
    differ by design too, and test_transform_matches holds them to
    dpvo_tpu's. On an edge with ii == jj, autodiff sees Ji + Jj."""
    scene = [_t(a) for a in make_scene(group)]
    scene[:3] = [a.double() for a in scene[:3]]
    # unit quaternions in f64: the analytic Ji's adjoint assumes them
    q = scene[0][:, 3:7]
    scene[0] = torch.cat([scene[0][:, :3], q / q.norm(dim=1, keepdim=True),
                          scene[0][:, 7:]], dim=1)
    poses, patches, intr, ii, jj, kk = scene
    _, _, (Ji, Jj, Jz) = tp.transform(*scene, jacobian=True, group=group)
    sim3 = group == 'sim3'
    retr, act4, mul, inv = ((tl.sim3_retr, tl.sim3_act4, tl.sim3_mul,
                             tl.sim3_inv) if sim3 else
                            (tl.se3_retr, tl.se3_act4, tl.se3_mul,
                             tl.se3_inv))

    def center(poses, patches):
        c = tp.transform(poses, patches, intr, ii, jj, kk, group=group)
        return c[:, P // 2, P // 2, :]

    def depth_set(d):
        return torch.cat([patches[:, :2], d[:, None, None, None].expand(
            -1, 1, P, P)], dim=1)

    Jpose = torch.func.jacrev(lambda xi: center(retr(poses, xi), patches))(
        torch.zeros(poses.shape[0], poses.shape[1] - 1, dtype=torch.float64))
    Jdep = torch.func.jacrev(lambda d: center(poses, depth_set(d)))(
        patches[:, 2, 0, 0].clone())
    ii, jj, kk = ii.long(), jj.long(), kk.long()
    Gij = mul(poses[jj], inv(poses[ii]))
    Z = act4(Gij, tp.iproj(patches[kk], intr[ii])[:, 1, 1])[:, 2]
    assert (Z.abs() <= 0.2).any() and (Z < -0.2).any()
    for e in range(len(ii)):
        i, j, k = int(ii[e]), int(jj[e]), int(kk[e])
        if Z[e].abs() <= 0.2:
            for J in (Ji, Jj, Jz):
                assert not J[e].any()
        if Z[e] <= 0.2:
            continue
        pairs = [(Jz[e, :, 0], Jdep[e, :, k])]
        if i == j:
            pairs.append((Ji[e] + Jj[e], Jpose[e, :, i]))
        else:
            pairs += [(Ji[e], Jpose[e, :, i]), (Jj[e], Jpose[e, :, j])]
        for ours, ref in pairs:
            np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=1e-9,
                                       atol=1e-9)


def test_point_cloud_and_flow_mag():
    poses, patches, intr, ii, jj, kk = make_scene('se3')
    ix = np.arange(5, dtype=np.int32)
    ref = _jax(jp.point_cloud, poses, patches[:5], intr, ix)
    _close(tp.point_cloud(_t(poses), _t(patches[:5]), _t(intr), _t(ix)), ref)
    for beta in (0.3, 0.5):
        ref = _jax(lambda *a: jp.flow_mag(*a, beta=beta), poses, patches,
                   intr, ii, jj, kk)
        mag, val = tp.flow_mag(*map(_t, (poses, patches, intr, ii, jj, kk)),
                               beta=beta)
        _close(mag, ref[0])
        assert val.dtype == torch.bool
        np.testing.assert_array_equal(val.numpy(), ref[1])


# ---------------------------------------------------------------------------
# utils/ and the ops helpers
# ---------------------------------------------------------------------------

def test_package_exports():
    import dpvo_torch.ops
    import dpvo_torch.utils
    import dpvo_tpu.ops
    import dpvo_tpu.utils
    assert dpvo_torch.utils.__all__ == dpvo_tpu.utils.__all__
    assert dpvo_torch.ops.__all__ == dpvo_tpu.ops.__all__
    for mod in (dpvo_torch.utils, dpvo_torch.ops):
        for name in mod.__all__:
            assert callable(getattr(mod, name)) or name == 'all_times'
    from dpvo_torch.utils import grids
    assert grids.pyramidify is dpvo_torch.ops.pyramidify
    assert grids.avg_pool2d is dpvo_torch.ops.avg_pool2d


def test_grids():
    from dpvo_torch import utils as tu
    from dpvo_tpu import utils as ju
    _close(tu.coords_grid(2, 3, 4, 6, device=CPU),
           _jax(lambda: ju.coords_grid(2, 3, 4, 6)))
    d = np.random.RandomState(0).rand(2, 3, 4, 5).astype(np.float32)
    ref = _jax(ju.coords_grid_with_index, d)
    out = tu.coords_grid_with_index(_t(d))
    for o, r in zip(out, ref):
        assert o.shape == r.shape and o.dtype == torch.float32
        np.testing.assert_array_equal(o.numpy(), r)
    a, b = np.arange(3), np.arange(5, 7)
    for o, r in zip(tu.flatmeshgrid(_t(a), _t(b)),
                    _jax(lambda x, y: ju.flatmeshgrid(x, y), a, b)):
        np.testing.assert_array_equal(o.numpy(), r)
    for o, r in zip(tu.all_pairs_exclusive(4, device=CPU),
                    ju.all_pairs_exclusive(4)):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    p = np.random.RandomState(1).rand(5, 3, 3, 3).astype(np.float32)
    depth = np.random.RandomState(2).rand(5).astype(np.float32)
    np.testing.assert_array_equal(tu.set_depth(_t(p), _t(depth)).numpy(),
                                  _jax(ju.set_depth, p, depth))


def test_device_defaults_to_cuda():
    """Tensors built from plain ints go to the card unless the caller asks
    for the CPU: without one they raise, never fall back."""
    from dpvo_torch import utils as tu
    if torch.cuda.is_available():
        assert tu.coords_grid(1, 1, 2, 2).is_cuda
        assert tl.SE3.Identity(2).data.is_cuda
        return
    for make in (lambda: tu.coords_grid(1, 1, 2, 2),
                 lambda: tu.all_pairs_exclusive(3),
                 lambda: tl.se3_identity((2,)), lambda: tl.SE3.Identity(2),
                 lambda: tl.Sim3.Random(2, key=0)):
        with pytest.raises((RuntimeError, AssertionError)):
            make()


def test_pyramidify_raw_windows_segment_mean():
    from dpvo_torch.ops import extract_patches, pyramidify, segment_mean
    from dpvo_tpu import ops as jo
    rng = np.random.RandomState(3)
    fmap = rng.randn(16, 24, 8).astype(np.float32)
    for o, r in zip(pyramidify(_t(fmap)),
                    _jax(jo.pyramidify, fmap)):
        _close(o, r)
    for o, r in zip(pyramidify(_t(fmap), lvls=(1, 2, 8)),
                    _jax(lambda f: jo.pyramidify(f, lvls=(1, 2, 8)), fmap)):
        _close(o, r)
    coords = rng.uniform(-3, 26, (20, 2)).astype(np.float32)
    for radius in (1, 3):
        out = extract_patches(_t(fmap), _t(coords), radius, mode='raw')
        assert out.shape == (20, 2 * radius + 2, 2 * radius + 2, 8)
        np.testing.assert_array_equal(
            out.numpy(), _jax(lambda f, c: jo.extract_patches(
                f, c, radius, mode='raw'), fmap, coords))
    x = rng.randn(30, 4).astype(np.float32)
    ids = rng.randint(0, 7, 30)                  # segment 7 stays empty
    _close(segment_mean(_t(x), _t(ids), 8),
           _jax(lambda a, b: jo.segment_mean(a, b, 8), x, ids))
    _close(segment_mean(_t(x[:, 0]), _t(ids), 8),
           _jax(lambda a, b: jo.segment_mean(a, b, 8), x[:, 0], ids))


def test_vo_frame_packed_is_vo_frame():
    """vo_frame_packed over 8 frames (bootstrap at the 8th) against
    vo_frame on the same aux: the states are bit-equal."""
    from dpvo_torch.config import cfg as torch_cfg
    from dpvo_torch.runtime import DeviceVO
    from dpvo_torch.runtime import device_vo as dv
    from test_torch_runtime import H, INTR, NPZ, W, _cfg, _frames
    c = _cfg(torch_cfg)
    vo = DeviceVO(c, NPZ, ht=H, wd=W, device=CPU)
    net, kw = vo.network, dict(vo._static, force_accept=True)
    rng = np.random.RandomState(0)
    T, M = 8, c.PATCHES_PER_FRAME
    images = torch.from_numpy(np.stack(_frames(T)))
    aux = torch.from_numpy(np.concatenate([
        rng.randint(1, W // 4 - 1, (T, M, 2)), rng.rand(T, M, 1),
        np.broadcast_to(np.arange(T)[:, None, None], (T, M, 1))],
        axis=-1).astype(np.float32))
    sts = []
    for step in (dv.vo_frame, dv.vo_frame_packed):
        st = dv.init_state(c, H, W, INTR, CPU, torch.float32)
        for t in range(T):
            st = step(net, st, images[t], aux[t], **kw)
        sts.append(st)
    a, b = sts
    assert bool(a.is_init) and a.host_n is None is b.host_n
    assert (int(a.n), int(a.counter)) == (int(b.n), int(b.counter))
    for x, y in zip(a.tensors().values(), b.tensors().values()):
        assert torch.equal(x, y)
