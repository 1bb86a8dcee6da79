"""Lie groups SO3 / RxSO3 / SE3 / Sim3 on tensors: functional ops and the
lietorch-style class surface.

Port of dpvo_tpu/lie.py. Layouts match it and the reference lietorch:
SO3 (..., 4) = [qx, qy, qz, qw]; RxSO3 (..., 5) = [q, s]; SE3 (..., 7) =
[tx, ty, tz, q]; Sim3 (..., 8) = [t, q, s]. Tangents: so3 (..., 3) = [phi];
rxso3 (..., 4) = [phi, sigma]; se3 (..., 6) = [tau, phi]; sim3 (..., 7) =
[tau, phi, sigma]. Small-angle regimes keep the same Taylor branches,
selected with torch.where over safe denominators: every branch, selected or
not, is finite with a finite derivative, so no NaN reaches a value, a
forward-mode derivative or a reverse-mode (.backward()) gradient. Every
function is torch.func-traceable (no in-place writes on inputs, no host
reads). The identities and Random take a device (default 'cuda', as the
runtimes) and a dtype; every other function follows its inputs.
"""
from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-8


def _matvec3(M, v):
    # elementwise form: exact f32 on every device (no TF32 matmul path)
    return (M * v[..., None, :]).sum(-1)


def _outer3(a, b):
    return a[..., :, None] * b[..., None, :]


def _cross(a, b):
    """Cross product over the last axis, broadcasting like jnp.cross."""
    a1, a2, a3 = a.unbind(-1)
    b1, b2, b3 = b.unbind(-1)
    return torch.stack([a2 * b3 - a3 * b2, a3 * b1 - a1 * b3,
                        a1 * b2 - a2 * b1], dim=-1)


def quat_mul(q1, q2):
    """Hamilton product q1 * q2, layout [x, y, z, w]."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
        w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def quat_inv(q):
    """Conjugate (== inverse for unit quaternions)."""
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_rotate(q, v):
    """Rotate vectors v (..., 3) by unit quaternions q (..., 4)."""
    qv, qw = q[..., :3], q[..., 3:4]
    uv = 2.0 * _cross(qv, v)
    return v + qw * uv + _cross(qv, uv)


def quat_to_matrix(q):
    """Unit quaternion -> rotation matrix (..., 3, 3)."""
    x, y, z, w = q.unbind(-1)
    x2, y2, z2 = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (y2 + z2), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (x2 + z2), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (x2 + y2),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def _homogeneous(top):
    """(..., 3, 4) [A | t] -> (..., 4, 4) with the row [0, 0, 0, 1]."""
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                          device=top.device)
    return torch.cat([top, bottom.expand(top.shape[:-2] + (1, 4))], dim=-2)


def _hat(phi):
    a, b, c = phi.unbind(-1)
    o = torch.zeros_like(a)
    m = torch.stack([o, -c, b, c, o, -a, -b, a, o], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def so3_exp(phi):
    theta_sq = (phi * phi).sum(-1, keepdim=True)
    theta_p4 = theta_sq * theta_sq
    small = theta_sq < 1e-8
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta_sq),
                                   theta_sq))
    imag = torch.where(small, 0.5 - theta_sq / 48.0 + theta_p4 / 3840.0,
                       torch.sin(0.5 * theta) / theta)
    real = torch.where(small, 1.0 - theta_sq / 8.0 + theta_p4 / 384.0,
                       torch.cos(0.5 * theta))
    return torch.cat([imag * phi, real], dim=-1)


def so3_log(q):
    qv, qw = q[..., :3], q[..., 3:4]
    sgn = torch.where(qw < 0, -1.0, 1.0)
    qv = qv * sgn
    qw = qw * sgn
    n_sq = (qv * qv).sum(-1, keepdim=True)
    small = n_sq < 1e-12
    n = torch.sqrt(torch.where(small, torch.ones_like(n_sq), n_sq))
    theta = 2.0 * torch.atan2(n, qw)
    qw_safe = torch.clamp(qw, min=_EPS)
    scale = torch.where(small,
                        2.0 / qw_safe * (1.0 - n_sq / (3.0 * qw_safe * qw_safe)),
                        theta / n)
    return scale * qv


def so3_inv(q):
    return quat_inv(q)


def so3_mul(q1, q2):
    return quat_mul(q1, q2)


def so3_act(q, p):
    return quat_rotate(q, p)


def so3_adj(q, phi):
    return quat_rotate(q, phi)


def so3_adjT(q, phi):
    return quat_rotate(quat_inv(q), phi)


def _so3_left_jacobian(phi):
    theta_sq = (phi * phi).sum(-1)[..., None, None]
    small = theta_sq < 1e-8
    theta_sq_safe = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(theta_sq_safe)
    a = torch.where(small, 0.5 - theta_sq / 24.0,
                    2.0 * torch.sin(0.5 * theta) ** 2 / theta_sq_safe)
    b = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (theta - torch.sin(theta)) / (theta_sq_safe * theta))
    hat = _hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(hat.shape)
    hat2 = _outer3(phi, phi) - theta_sq * eye
    return eye + a * hat + b * hat2


def _so3_left_jacobian_inv(phi):
    theta_sq = (phi * phi).sum(-1)[..., None, None]
    small = theta_sq < 1e-8
    theta_sq_safe = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(theta_sq_safe)
    half = 0.5 * theta
    sin_half = torch.sin(half)
    sin_half_safe = torch.where(sin_half.abs() < _EPS,
                                torch.ones_like(sin_half), sin_half)
    c = torch.where(small, 1.0 / 12.0 + theta_sq / 720.0,
                    (1.0 - half * torch.cos(half) / sin_half_safe)
                    / theta_sq_safe)
    hat = _hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(hat.shape)
    hat2 = _outer3(phi, phi) - theta_sq * eye
    return eye - 0.5 * hat + c * hat2


def se3_identity(shape=(), dtype=torch.float32, device='cuda'):
    data = torch.zeros(tuple(shape) + (7,), dtype=dtype, device=device)
    data[..., 6] = 1.0
    return data


def se3_exp(xi):
    """se3 tangent [tau, phi] -> SE3 [t, q]."""
    tau, phi = xi[..., :3], xi[..., 3:6]
    q = so3_exp(phi)
    t = _matvec3(_so3_left_jacobian(phi), tau)
    return torch.cat([t, q], dim=-1)


def se3_log(data):
    t, q = data[..., :3], data[..., 3:7]
    phi = so3_log(q)
    tau = _matvec3(_so3_left_jacobian_inv(phi), t)
    return torch.cat([tau, phi], dim=-1)


def se3_inv(data):
    qinv = quat_inv(data[..., 3:7])
    return torch.cat([-quat_rotate(qinv, data[..., :3]), qinv], dim=-1)


def se3_mul(a, b):
    """Composition a * b (apply b first, then a)."""
    qa = a[..., 3:7]
    q = quat_mul(qa, b[..., 3:7])
    t = a[..., :3] + quat_rotate(qa, b[..., :3])
    return torch.cat([t, q], dim=-1)


def se3_act(data, p):
    """Act on 3D points (..., 3)."""
    return quat_rotate(data[..., 3:7], p) + data[..., :3]


def se3_act4(data, p4):
    """Act on homogeneous points [x, y, z, w]: X' = R x + w t."""
    t, q = data[..., :3], data[..., 3:7]
    x, w = p4[..., :3], p4[..., 3:4]
    return torch.cat([quat_rotate(q, x) + w * t, w], dim=-1)


def se3_adjT(data, X):
    """Transpose-adjoint Ad_G^T on (..., 6) covectors (ba_cuda.cu:57-72)."""
    t, q = data[..., :3], data[..., 3:7]
    qinv = quat_inv(q)
    Xa, Xb = X[..., :3], X[..., 3:6]
    Ya = quat_rotate(qinv, Xa)
    Yb = quat_rotate(qinv, Xb) + quat_rotate(qinv, _cross(Xa, t))
    return torch.cat([Ya, Yb], dim=-1)


def se3_adj(data, xi):
    """Adjoint Ad_G on (..., 6) tangents [tau, phi]."""
    t, q = data[..., :3], data[..., 3:7]
    Rphi = quat_rotate(q, xi[..., 3:6])
    Rtau = quat_rotate(q, xi[..., :3])
    return torch.cat([Rtau + _cross(t, Rphi), Rphi], dim=-1)


def se3_retr(data, xi):
    """Left-multiplicative retraction: exp(xi) * data."""
    return se3_mul(se3_exp(xi), data)


def se3_matrix(data):
    """(..., 4, 4) homogeneous matrix."""
    R = quat_to_matrix(data[..., 3:7])
    return _homogeneous(torch.cat([R, data[..., :3, None]], dim=-1))


def se3_scale(data, s):
    """Scale the translation (lietorch SE3.scale, groups.py:282)."""
    return torch.cat([data[..., :3] * s, data[..., 3:7]], dim=-1)


# ---------------------------------------------------------------------------
# RxSO3 (rotation and scale), layout [q, s]
# ---------------------------------------------------------------------------

def rxso3_exp(xi):
    """[phi, sigma] -> [q, s]."""
    return torch.cat([so3_exp(xi[..., :3]), torch.exp(xi[..., 3:4])], dim=-1)


def rxso3_log(data):
    return torch.cat([so3_log(data[..., :4]), torch.log(data[..., 4:5])],
                     dim=-1)


def rxso3_inv(data):
    return torch.cat([quat_inv(data[..., :4]), 1.0 / data[..., 4:5]], dim=-1)


def rxso3_mul(a, b):
    return torch.cat([quat_mul(a[..., :4], b[..., :4]),
                      a[..., 4:5] * b[..., 4:5]], dim=-1)


def rxso3_act(data, p):
    return data[..., 4:5] * quat_rotate(data[..., :4], p)


def rxso3_act4(data, p4):
    """Act on homogeneous points [x, y, z, w]: X' = s R x (w unchanged)."""
    return torch.cat([rxso3_act(data, p4[..., :3]), p4[..., 3:4]], dim=-1)


def rxso3_adj(data, xi):
    """Adjoint on (..., 4) tangents [phi, sigma]: phi rotated, sigma kept."""
    return torch.cat([quat_rotate(data[..., :4], xi[..., :3]), xi[..., 3:4]],
                     dim=-1)


def rxso3_adjT(data, X):
    """Transpose adjoint: <adjT(G) X, xi> == <X, adj(G) xi>."""
    return torch.cat([quat_rotate(quat_inv(data[..., :4]), X[..., :3]),
                      X[..., 3:4]], dim=-1)


def rxso3_matrix(data):
    """(..., 3, 3) scaled rotation s R."""
    return quat_to_matrix(data[..., :4]) * data[..., 4:5, None]


# ---------------------------------------------------------------------------
# Sim3, layout [t, q, s]
# ---------------------------------------------------------------------------

def sim3_identity(shape=(), dtype=torch.float32, device='cuda'):
    data = torch.zeros(tuple(shape) + (8,), dtype=dtype, device=device)
    data[..., 6:8] = 1.0
    return data


def _sim3_W(phi, sigma):
    """The integral of exp(sigma t) R(phi t) over t in [0, 1]:
    W = A I + B hat(phi) + C hat(phi)^2, in dpvo_tpu's cancellation-free
    f32 forms (expm1 for e^s - 1, 2 sin^2(t/2) for 1 - cos t) with series
    below theta < 1e-3 and |sigma| < 1e-4."""
    theta_sq = (phi * phi).sum(-1)[..., None, None]
    small_theta = theta_sq < 1e-6
    theta_sq_s = torch.where(small_theta, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(theta_sq_s)
    sig = sigma[..., None]
    scale = torch.exp(sig)
    em1 = torch.expm1(sig)
    small_sig = sig.abs() < 1e-4
    sig_safe = torch.where(small_sig, torch.ones_like(sig), sig)

    tiny_sig = sig.abs() < 1e-8
    A = torch.where(tiny_sig, 1.0 + sig / 2.0,
                    em1 / torch.where(tiny_sig, torch.ones_like(sig), sig))

    s2t2 = sig * sig + theta_sq
    s2t2 = torch.where(s2t2 < _EPS, torch.ones_like(s2t2), s2t2)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    half_sin_sq = 2.0 * torch.sin(0.5 * theta) ** 2

    a = scale * sin_t
    b_m1 = em1 * cos_t - half_sin_sq
    B_gen = (a * sig - b_m1 * theta) / (theta * s2t2)
    C_gen = (A - (b_m1 * sig + a * theta) / s2t2) / theta_sq_s

    B_sig0 = half_sin_sq / theta_sq_s
    C_sig0 = (theta - sin_t) / (theta_sq_s * theta)

    sig_sq_safe = torch.where(small_sig, torch.ones_like(sig), sig * sig)
    B_th0 = (sig * scale - em1) / sig_sq_safe
    C_th0 = ((0.5 * sig * sig * scale - sig * scale + em1) /
             (sig_sq_safe * sig_safe))

    B_00 = 0.5 + sig / 6.0 + sig * sig / 24.0
    C_00 = 1.0 / 6.0 + sig / 24.0 - theta_sq / 120.0

    B = torch.where(small_theta, torch.where(small_sig, B_00, B_th0),
                    torch.where(small_sig, B_sig0, B_gen))
    C = torch.where(small_theta, torch.where(small_sig, C_00, C_th0),
                    torch.where(small_sig, C_sig0, C_gen))

    hat = _hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(hat.shape)
    hat2 = _outer3(phi, phi) - theta_sq * eye
    return A * eye + B * hat + C * hat2


def _inv3(M):
    """Closed-form 3x3 inverse (adjugate over the determinant)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack([
        A, -(b * i - c * h), (b * f - c * e),
        B, (a * i - c * g), -(a * f - c * d),
        C, -(a * h - b * g), (a * e - b * d),
    ], dim=-1).reshape(M.shape)
    return adj * (1.0 / det)[..., None, None]


def sim3_exp(xi):
    """[tau, phi, sigma] -> [t, q, s]."""
    tau, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6:7]
    t = _matvec3(_sim3_W(phi, sigma), tau)
    return torch.cat([t, so3_exp(phi), torch.exp(sigma)], dim=-1)


def sim3_log(data):
    t, q, s = data[..., :3], data[..., 3:7], data[..., 7:8]
    phi = so3_log(q)
    sigma = torch.log(s)
    tau = _matvec3(_inv3(_sim3_W(phi, sigma)), t)
    return torch.cat([tau, phi, sigma], dim=-1)


def sim3_inv(data):
    t, q, s = data[..., :3], data[..., 3:7], data[..., 7:8]
    qinv = quat_inv(q)
    return torch.cat([-quat_rotate(qinv, t) / s, qinv, 1.0 / s], dim=-1)


def sim3_mul(a, b):
    """Composition a * b (apply b first, then a)."""
    qa, sa = a[..., 3:7], a[..., 7:8]
    t = a[..., :3] + sa * quat_rotate(qa, b[..., :3])
    return torch.cat([t, quat_mul(qa, b[..., 3:7]), sa * b[..., 7:8]],
                     dim=-1)


def sim3_act(data, p):
    return data[..., 7:8] * quat_rotate(data[..., 3:7], p) + data[..., :3]


def sim3_act4(data, p4):
    """Homogeneous action: [s R x + w t, w] (lietorch Sim3 act4)."""
    t, q, s = data[..., :3], data[..., 3:7], data[..., 7:8]
    x, w = p4[..., :3], p4[..., 3:4]
    return torch.cat([s * quat_rotate(q, x) + w * t, w], dim=-1)


def sim3_retr(data, xi):
    """Left-multiplicative retraction: exp(xi) * data."""
    return sim3_mul(sim3_exp(xi), data)


def sim3_matrix(data):
    """(..., 4, 4) homogeneous matrix [s R | t]."""
    sR = quat_to_matrix(data[..., 3:7]) * data[..., 7:8, None]
    return _homogeneous(torch.cat([sR, data[..., :3, None]], dim=-1))


def sim3_adjT(data, X):
    """Ad_G^T on (..., 7) covectors [tau*, phi*, sigma*], the transpose of

        Ad = [ sR   [t]x R   -t ]
             [ 0      R       0 ]
             [ 0      0       1 ]
    """
    t, q, s = data[..., :3], data[..., 3:7], data[..., 7:8]
    Xa, Xb, Xc = X[..., :3], X[..., 3:6], X[..., 6:7]
    qinv = quat_inv(q)
    Ya = s * quat_rotate(qinv, Xa)
    Yb = quat_rotate(qinv, Xb) + quat_rotate(qinv, _cross(Xa, t))
    Yc = Xc - (t * Xa).sum(-1, keepdim=True)
    return torch.cat([Ya, Yb, Yc], dim=-1)


# ---------------------------------------------------------------------------
# lietorch-style classes (reference dpvo/lietorch/groups.py): a plain class
# holding `.data`, dispatching to the functions above
# ---------------------------------------------------------------------------

class _LieGroup:
    embedded_dim = None     # set by each group
    manifold_dim = None
    _fns = {}

    def __init__(self, data):
        self.data = torch.as_tensor(data)

    def __getitem__(self, idx):
        return type(self)(self.data[idx])

    @property
    def shape(self):
        return self.data.shape[:-1]

    def inv(self):
        return type(self)(self._fns['inv'](self.data))

    def log(self):
        return self._fns['log'](self.data)

    @classmethod
    def exp(cls, xi):
        return cls(cls._fns['exp'](xi))

    def __mul__(self, other):
        if isinstance(other, _LieGroup):
            a, b = torch.broadcast_tensors(self.data, other.data)
            return type(self)(self._fns['mul'](a, b))
        other = torch.as_tensor(other)          # points: act or act4
        if other.shape[-1] == 3:
            return self._fns['act'](self.data, other)
        act4 = self._fns['act4']
        if act4 is None:
            raise ValueError(f'{type(self).__name__} acts on 3-wide points '
                             f'only, not on {tuple(other.shape)}')
        return act4(self.data, other)

    def retr(self, xi):
        return type(self)(self._fns['retr'](self.data, xi))

    def matrix(self):
        return self._fns['matrix'](self.data)

    def adjT(self, X):
        return self._fns['adjT'](self.data, X)

    @classmethod
    def Identity(cls, *shape, dtype=torch.float32, device='cuda'):
        data = torch.zeros(tuple(shape) + (cls.embedded_dim,), dtype=dtype,
                           device=device)
        data[..., 3 if cls.embedded_dim < 7 else 6] = 1.0       # qw
        if cls.embedded_dim in (5, 8):
            data[..., -1] = 1.0                                  # s
        return cls(data)

    @classmethod
    def IdentityLike(cls, other):
        return cls.Identity(*other.shape, dtype=other.data.dtype,
                            device=other.data.device)

    @classmethod
    def Random(cls, *shape, sigma=1.0, key=None, device='cuda'):
        """exp of sigma * N(0, 1) tangents drawn from
        np.random.RandomState(key), in f32: the same key gives dpvo_tpu's
        elements."""
        rng = np.random if key is None else np.random.RandomState(key)
        xi = rng.randn(*shape, cls.manifold_dim) * sigma
        return cls.exp(torch.as_tensor(xi, dtype=torch.float32,
                                       device=device))

    def vec(self):
        return self.data

    def translation(self):
        """Homogeneous translation [t, 1] (reference groups.py:214-218)."""
        t = self.data[..., :3]
        return torch.cat([t, torch.ones_like(t[..., :1])], dim=-1)

    def adj(self, xi):
        fn = self._fns.get('adj')
        if fn is not None:
            return fn(self.data, xi)
        # no closed form (Sim3): Ad_X xi = d/de log(X exp(e xi) X^-1) at 0
        f = self._fns
        X, Xinv = self.data, f['inv'](self.data)
        return torch.func.jvp(
            lambda e: f['log'](f['mul'](f['mul'](X, f['exp'](e)), Xinv)),
            (torch.zeros_like(xi),), (xi,))[1]

    def Jinv(self, tau):
        """Inverse left Jacobian applied to tau: J_l^-1(Log X) tau, the
        derivative of log(exp(e) X) at e = 0 along tau."""
        f, X = self._fns, self.data
        return torch.func.jvp(lambda e: f['log'](f['mul'](f['exp'](e), X)),
                              (torch.zeros_like(tau),), (tau,))[1]

    def detach(self):
        return type(self)(self.data.detach())


def stack(groups, dim=0):
    """lietorch.stack: one group of the elements' data stacked on dim."""
    return type(groups[0])(torch.stack([g.data for g in groups], dim=dim))


class SO3(_LieGroup):
    embedded_dim, manifold_dim = 4, 3
    _fns = dict(exp=so3_exp, log=so3_log, inv=so3_inv, mul=so3_mul,
                act=so3_act, act4=None,
                retr=lambda d, xi: so3_mul(so3_exp(xi), d),
                matrix=quat_to_matrix, adj=so3_adj, adjT=so3_adjT)


class RxSO3(_LieGroup):
    embedded_dim, manifold_dim = 5, 4
    _fns = dict(exp=rxso3_exp, log=rxso3_log, inv=rxso3_inv, mul=rxso3_mul,
                act=rxso3_act, act4=rxso3_act4,
                retr=lambda d, xi: rxso3_mul(rxso3_exp(xi), d),
                matrix=rxso3_matrix, adj=rxso3_adj, adjT=rxso3_adjT)


class SE3(_LieGroup):
    embedded_dim, manifold_dim = 7, 6
    _fns = dict(exp=se3_exp, log=se3_log, inv=se3_inv, mul=se3_mul,
                act=se3_act, act4=se3_act4, retr=se3_retr,
                matrix=se3_matrix, adj=se3_adj, adjT=se3_adjT)

    def scale(self, s):
        return SE3(se3_scale(self.data, s))


class Sim3(_LieGroup):
    embedded_dim, manifold_dim = 8, 7
    _fns = dict(exp=sim3_exp, log=sim3_log, inv=sim3_inv, mul=sim3_mul,
                act=sim3_act, act4=sim3_act4, retr=sim3_retr,
                matrix=sim3_matrix, adjT=sim3_adjT)
