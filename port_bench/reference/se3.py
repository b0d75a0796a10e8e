"""SE(3) on plain tensors, for the reference network.

Group elements are 7-vectors ``[tx, ty, tz, qx, qy, qz, qw]`` (translation,
unit quaternion with the scalar last), tangents 6-vectors ``[v, w]``
(translation first), increments left-multiplicative: ``retract(eps, g) =
exp(eps) * g``. Near the identity the coefficients are polynomials in
theta^2, with one exception that follows the measured program's chart (and
the JAX package's): the quaternion's scalar part is cos(theta / 2) with
theta a square root whose derivative at 0 is 0, so at ``eps = 0`` its
second derivative is 0 and not -1/4. The Hessian that the
implicit-function backward takes at ``eps = 0`` is that chart's.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def _sqrt0(x: Tensor) -> Tensor:
    """sqrt with a zero gradient at 0 (the branches that use it are not
    taken there)."""
    pos = x > 0.0
    return torch.sqrt(torch.where(pos, x, torch.ones_like(x))) * pos


def _cross(a: Tensor, b: Tensor) -> Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_mul(q1: Tensor, q2: Tensor) -> Tensor:
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], dim=-1)


def quat_rotate(q: Tensor, p: Tensor) -> Tensor:
    qv, qw = q[..., :3], q[..., 3:4]
    t = 2.0 * _cross(qv, p)
    return p + qw * t + _cross(qv, t)


def identity(shape, dtype=torch.float32, device=None) -> Tensor:
    g = torch.zeros((*shape, 7), dtype=dtype, device=device)
    g[..., 6] = 1.0
    return g


def _coeffs(th2: Tensor):
    """(A, B, C) = (sin t / t, (1 - cos t) / t^2, (t - sin t) / t^3)."""
    small = th2 < 1e-2
    one = torch.ones_like(th2)
    th = _sqrt0(th2)
    safe2 = torch.where(small, one, th2)
    safe = torch.where(small, one, th)
    A = torch.where(small, 1.0 - th2 / 6.0 + th2 * th2 / 120.0,
                    torch.sin(safe) / safe)
    B = torch.where(small, 0.5 - th2 / 24.0 + th2 * th2 / 720.0,
                    (1.0 - torch.cos(safe)) / safe2)
    C = torch.where(small, 1.0 / 6.0 - th2 / 120.0 + th2 * th2 / 5040.0,
                    (safe - torch.sin(safe)) / (safe2 * safe))
    return A, B, C


def exp(tau: Tensor) -> Tensor:
    v, w = tau[..., :3], tau[..., 3:]
    th2 = (w * w).sum(-1, keepdim=True)
    small = th2 < 1e-2
    one = torch.ones_like(th2)
    th = _sqrt0(th2)
    half = 0.5 * torch.where(small, one, th)
    s = torch.where(small, 0.5 - th2 / 48.0 + th2 * th2 / 3840.0,
                    torch.sin(half) / torch.where(small, one, th))
    c = torch.cos(0.5 * th)
    _, B, C = _coeffs(th2)
    wxv = _cross(w, v)
    t = v + B * wxv + C * _cross(w, wxv)
    return torch.cat([t, s * w, c], dim=-1)


def log(g: Tensor) -> Tensor:
    t, qv, qw = g[..., :3], g[..., 3:6], g[..., 6:7]
    sign = torch.where(qw < 0.0, -1.0, 1.0).to(g.dtype)
    qv, qw = qv * sign, qw * sign
    n2 = (qv * qv).sum(-1, keepdim=True)
    small = n2 < 1e-12
    n = _sqrt0(n2)
    qwc = torch.clamp(qw, min=1e-8)
    k = torch.where(small, 2.0 / qwc * (1.0 - n2 / (3.0 * qwc * qwc)),
                    2.0 * torch.atan2(n, qw) / torch.where(small, torch.ones_like(n), n))
    w = k * qv
    th2 = (w * w).sum(-1, keepdim=True)
    A, B, _ = _coeffs(th2)
    D = torch.where(th2 < 1e-2, 1.0 / 12.0 + th2 / 720.0 + th2 * th2 / 30240.0,
                    (1.0 - A / (2.0 * B)) / torch.where(th2 < 1e-2, torch.ones_like(th2), th2))
    wxt = _cross(w, t)
    return torch.cat([t - 0.5 * wxt + D * _cross(w, wxt), w], dim=-1)


def mul(g1: Tensor, g2: Tensor) -> Tensor:
    return torch.cat([g1[..., :3] + quat_rotate(g1[..., 3:], g2[..., :3]),
                      quat_mul(g1[..., 3:], g2[..., 3:])], dim=-1)


def inv(g: Tensor) -> Tensor:
    qc = g[..., 3:] * g.new_tensor([-1.0, -1.0, -1.0, 1.0])
    return torch.cat([-quat_rotate(qc, g[..., :3]), qc], dim=-1)


def act(g: Tensor, p: Tensor) -> Tensor:
    return quat_rotate(g[..., 3:], p) + g[..., :3]


def normalize(g: Tensor) -> Tensor:
    q = g[..., 3:]
    return torch.cat([g[..., :3], q / torch.linalg.norm(q, dim=-1, keepdim=True)],
                     dim=-1)


def retract(eps: Tensor, g: Tensor) -> Tensor:
    return mul(exp(eps), g)


def scale(g: Tensor, s: float) -> Tensor:
    return torch.cat([g[..., :3] * s, g[..., 3:]], dim=-1)
