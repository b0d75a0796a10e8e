"""SE(3) Lie-group operations on PyTorch tensors.

Port of ``robust_pose_tpu/se3.py`` with the same conventions:

* group elements are 7-vectors ``[tx, ty, tz, qx, qy, qz, qw]``
  (translation + unit quaternion, scalar last);
* tangent vectors are 6-vectors ``[v, w]``, translation first;
* increments are left-multiplicative: ``retract(eps, X) = exp(eps) * X``.

All functions broadcast over leading batch dimensions and keep the
small-angle Taylor branches of the JAX package.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def _safe_sqrt(x: Tensor) -> Tensor:
    return torch.sqrt(torch.where(x > 0.0, x, torch.ones_like(x))) * (x > 0.0)


def _cross(a: Tensor, b: Tensor) -> Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_mul(q1: Tensor, q2: Tensor) -> Tensor:
    """Hamilton product of two xyzw quaternions."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def quat_conj(q: Tensor) -> Tensor:
    # the signs are filled on q's device (a host list copied there waits
    # for the device's queue); a product, since negation and a product by
    # -1 need not give a NaN the same sign bit
    sign = torch.full((4,), -1.0, dtype=q.dtype, device=q.device)
    sign[3:].fill_(1.0)
    return q * sign


def quat_rotate(q: Tensor, p: Tensor) -> Tensor:
    """Rotate points ``p (..., 3)`` by xyzw quaternions ``q (..., 4)``."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    t = 2.0 * _cross(qv, p)
    return p + qw * t + _cross(qv, t)


def so3_exp_quat(w: Tensor) -> Tensor:
    """Rotation vector (..., 3) -> xyzw quaternion."""
    theta_sq = torch.sum(w * w, dim=-1, keepdim=True)
    theta = _safe_sqrt(theta_sq)
    half = 0.5 * theta
    small = theta_sq < 1e-8
    sinc_half = torch.where(
        small, 0.5 - theta_sq / 48.0,
        torch.sin(half) / torch.where(small, torch.ones_like(theta), theta))
    return torch.cat([sinc_half * w, torch.cos(half)], dim=-1)


def so3_log(q: Tensor) -> Tensor:
    """xyzw quaternion -> rotation vector (..., 3)."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    sign = torch.where(qw < 0.0, -1.0, 1.0).to(q.dtype)
    qv = qv * sign
    qw = qw * sign
    n_sq = torch.sum(qv * qv, dim=-1, keepdim=True)
    n = _safe_sqrt(n_sq)
    small = n_sq < 1e-12
    angle = 2.0 * torch.atan2(n, qw)
    qw_c = torch.clamp(qw, min=1e-8)
    scale = torch.where(
        small, 2.0 / qw_c * (1.0 - n_sq / (3.0 * qw_c ** 2)),
        angle / torch.where(small, torch.ones_like(n), n))
    return scale * qv


def identity(shape=(), dtype=torch.float32, device=None) -> Tensor:
    """Identity group element(s) with the given leading batch shape."""
    g = torch.zeros((*shape, 7), dtype=dtype, device=device)
    g[..., 6] = 1.0
    return g


def _V_coeffs(theta_sq: Tensor):
    """B = (1-cos)/t^2, C = (t-sin)/t^3 with the Taylor branch below
    t^2 = 1e-2 (see the JAX package for the f32 cancellation argument)."""
    theta = _safe_sqrt(theta_sq)
    small = theta_sq < 1e-2
    one = torch.ones_like(theta_sq)
    safe = torch.where(small, one, theta_sq)
    B = torch.where(small,
                    0.5 - theta_sq / 24.0 + theta_sq * theta_sq / 720.0,
                    (1.0 - torch.cos(theta)) / safe)
    C = torch.where(small,
                    1.0 / 6.0 - theta_sq / 120.0 + theta_sq * theta_sq / 5040.0,
                    (theta - torch.sin(theta))
                    / (safe * torch.where(small, one, theta)))
    return B, C


def exp(tau: Tensor) -> Tensor:
    """SE(3) exponential: tangent (..., 6) [v, w] -> group (..., 7)."""
    v = tau[..., :3]
    w = tau[..., 3:6]
    q = so3_exp_quat(w)
    theta_sq = torch.sum(w * w, dim=-1, keepdim=True)
    B, C = _V_coeffs(theta_sq)
    wxv = _cross(w, v)
    wxwxv = _cross(w, wxv)
    return torch.cat([v + B * wxv + C * wxwxv, q], dim=-1)


def log(g: Tensor) -> Tensor:
    """SE(3) logarithm: group (..., 7) -> tangent (..., 6) [v, w]."""
    t = g[..., :3]
    w = so3_log(g[..., 3:7])
    theta_sq = torch.sum(w * w, dim=-1, keepdim=True)
    B, _ = _V_coeffs(theta_sq)
    theta = _safe_sqrt(theta_sq)
    small = theta_sq < 1e-2
    one = torch.ones_like(theta_sq)
    safe = torch.where(small, one, theta_sq)
    A = torch.where(small,
                    1.0 - theta_sq / 6.0 + theta_sq * theta_sq / 120.0,
                    torch.sin(theta) / torch.where(small, one, theta))
    D = torch.where(small,
                    1.0 / 12.0 + theta_sq / 720.0 + theta_sq * theta_sq / 30240.0,
                    (1.0 - A / (2.0 * B)) / safe)
    wxt = _cross(w, t)
    wxwxt = _cross(w, wxt)
    return torch.cat([t - 0.5 * wxt + D * wxwxt, w], dim=-1)


def mul(g1: Tensor, g2: Tensor) -> Tensor:
    """Group composition g1 * g2."""
    t = g1[..., :3] + quat_rotate(g1[..., 3:7], g2[..., :3])
    q = quat_mul(g1[..., 3:7], g2[..., 3:7])
    return torch.cat([t, q], dim=-1)


def inv(g: Tensor) -> Tensor:
    qi = quat_conj(g[..., 3:7])
    return torch.cat([-quat_rotate(qi, g[..., :3]), qi], dim=-1)


def act(g: Tensor, p: Tensor) -> Tensor:
    """Apply transform g (..., 7) to points p (..., 3), broadcasting."""
    return quat_rotate(g[..., 3:7], p) + g[..., :3]


def scale(g: Tensor, s) -> Tensor:
    """Scale the translation component."""
    return torch.cat([g[..., :3] * s, g[..., 3:7]], dim=-1)


def normalize(g: Tensor) -> Tensor:
    """Re-normalize the quaternion part."""
    q = g[..., 3:7]
    return torch.cat([g[..., :3], q / torch.linalg.norm(q, dim=-1, keepdim=True)],
                     dim=-1)


def retract(eps: Tensor, g: Tensor) -> Tensor:
    """Left-multiplicative retraction exp(eps) * g."""
    return mul(exp(eps), g)


_EPS = 1e-8


def quat_to_matrix(q: Tensor) -> Tensor:
    """xyzw quaternion -> (..., 3, 3) rotation matrix."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
        2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
        2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
    ], dim=-1)
    return m.reshape(*q.shape[:-1], 3, 3)


def quat_from_matrix(m: Tensor) -> Tensor:
    """(..., 3, 3) rotation matrix -> xyzw quaternion, branch-free: of the
    four standard constructions each element takes the one whose squared
    component is largest."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    sq = [torch.clamp(1.0 + tr, min=0.0),
          torch.clamp(1.0 + m00 - m11 - m22, min=0.0),
          torch.clamp(1.0 - m00 + m11 - m22, min=0.0),
          torch.clamp(1.0 - m00 - m11 + m22, min=0.0)]
    s = [2.0 * _safe_sqrt(v) for v in sq]
    d = [torch.clamp(v, min=_EPS) for v in s]
    cands = torch.stack([
        torch.stack([(m21 - m12) / d[0], (m02 - m20) / d[0],
                     (m10 - m01) / d[0], 0.25 * s[0]], dim=-1),
        torch.stack([0.25 * s[1], (m01 + m10) / d[1],
                     (m02 + m20) / d[1], (m21 - m12) / d[1]], dim=-1),
        torch.stack([(m01 + m10) / d[2], 0.25 * s[2],
                     (m12 + m21) / d[2], (m02 - m20) / d[2]], dim=-1),
        torch.stack([(m02 + m20) / d[3], (m12 + m21) / d[3],
                     0.25 * s[3], (m10 - m01) / d[3]], dim=-1),
    ], dim=-2)                                           # (..., 4, 4)
    best = torch.argmax(torch.stack(sq, dim=-1), dim=-1)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(cands, -2, idx)[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def skew(w: Tensor) -> Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    x, y, z = w.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(*w.shape[:-1], 3, 3)


def matrix(g: Tensor) -> Tensor:
    """(..., 7) -> homogeneous (..., 4, 4)."""
    R = quat_to_matrix(g[..., 3:7])
    top = torch.cat([R, g[..., :3, None]], dim=-1)
    bottom = torch.zeros((*g.shape[:-1], 1, 4), dtype=g.dtype, device=g.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def from_matrix(m: Tensor) -> Tensor:
    """Homogeneous (..., 4, 4) -> (..., 7)."""
    return torch.cat([m[..., :3, 3], quat_from_matrix(m[..., :3, :3])], dim=-1)


def adjoint(g: Tensor) -> Tensor:
    """(..., 7) -> (..., 6, 6) adjoint for [v, w]-ordered tangents."""
    R = quat_to_matrix(g[..., 3:7])
    tR = torch.matmul(skew(g[..., :3]), R)
    top = torch.cat([R, tR], dim=-1)
    bottom = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def random(generator: torch.Generator, shape=(), sigma: float = 1.0,
           dtype=torch.float32) -> Tensor:
    """Random group elements exp(N(0, sigma^2)) drawn from ``generator``
    on its device (the JAX package draws from a PRNG key; the
    distribution is the same, the bits are not)."""
    tau = sigma * torch.randn((*shape, 6), generator=generator, dtype=dtype,
                              device=generator.device)
    return exp(tau)
