"""SE3, RxSO3, Sim3 and quaternion operations on tensors.

Port of dpvo_tpu/lie.py:31-500 (the subset the VO path and the classic
loop closure's pose graph use). Layouts match it and the reference
lietorch: SO3 (..., 4) = [qx, qy, qz, qw]; SE3 (..., 7) = [tx, ty, tz, q];
se3 tangent (..., 6) = [tau, phi]; RxSO3 (..., 5) = [q, s]; Sim3 (..., 8) =
[t, q, s], tangent (..., 7) = [tau, phi, sigma]. Small-angle regimes keep
the same Taylor branches, selected with torch.where over safe denominators,
so every function is torch.func-traceable (no in-place writes, no host
reads) and a branch that is not selected never puts a NaN into a value or
a forward-mode derivative.
"""
from __future__ import annotations

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


def se3_retr(data, xi):
    """Left-multiplicative retraction: exp(xi) * data."""
    return se3_mul(se3_exp(xi), data)


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


# ---------------------------------------------------------------------------
# Sim3, layout [t, q, s]
# ---------------------------------------------------------------------------

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
