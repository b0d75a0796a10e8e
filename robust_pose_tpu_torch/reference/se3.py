"""Minimal SE(3) ops in PyTorch for the end-to-end parity oracle.

Replaces lietorch (not a dependency) with the same conventions the
package's pure-JAX se3 module uses (and lietorch's ``SE3.vec()`` layout):
7-vectors ``[tx, ty, tz, qx, qy, qz, qw]``, tangents ``[v, w]``. f64-capable —
the reference solves its inner problem in float64
(the reference's core/pose/pose_head.py:64-70).
"""
from __future__ import annotations

import torch


def quat_rotate(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Rotate points p (..., 3) by unit quaternions q (..., 4, xyzw)."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    t = 2.0 * torch.cross(qv, p, dim=-1)
    return p + qw * t + torch.cross(qv, t, dim=-1)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> unit quaternion (..., 4)."""
    theta = torch.linalg.norm(w, dim=-1, keepdim=True)
    half = 0.5 * theta
    small = theta < 1e-6
    sinc = torch.where(small, 0.5 - theta ** 2 / 48.0,
                       torch.sin(half) / torch.where(small, torch.ones_like(theta), theta))
    return torch.cat([w * sinc, torch.cos(half)], dim=-1)


def exp(tau: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential (..., 6) [v, w] -> (..., 7)."""
    v, w = tau[..., :3], tau[..., 3:]
    q = so3_exp(w)
    theta = torch.linalg.norm(w, dim=-1, keepdim=True)
    theta_sq = theta ** 2
    small = theta < 1e-6
    safe = torch.where(small, torch.ones_like(theta), theta)
    A = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(safe) / safe)
    B = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(safe)) / safe ** 2)
    C = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (1.0 - A) / safe ** 2)
    # V(w) v = v + B w x v + C w x (w x v)
    wxv = torch.cross(w, v, dim=-1)
    wxwxv = torch.cross(w, wxv, dim=-1)
    t = v + B * wxv + C * wxwxv
    return torch.cat([t, q], dim=-1)


def inv(g: torch.Tensor) -> torch.Tensor:
    t, q = g[..., :3], g[..., 3:]
    qc = torch.cat([-q[..., :3], q[..., 3:]], dim=-1)
    return torch.cat([-quat_rotate(qc, t), qc], dim=-1)


def mul(g1: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    t1, q1 = g1[..., :3], g1[..., 3:]
    t2, q2 = g2[..., :3], g2[..., 3:]
    return torch.cat([t1 + quat_rotate(q1, t2), quat_mul(q1, q2)], dim=-1)


def act(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply (..., 7) to points (..., 3)."""
    return quat_rotate(g[..., 3:], p) + g[..., :3]


def log(g: torch.Tensor) -> torch.Tensor:
    """SE(3) logarithm (..., 7) -> (..., 6) [v, w]."""
    t, q = g[..., :3], g[..., 3:]
    qv, qw = q[..., :3], q[..., 3:4]
    n = torch.linalg.norm(qv, dim=-1, keepdim=True)
    theta = 2.0 * torch.atan2(n, qw.abs())
    sign = torch.where(qw >= 0, torch.ones_like(qw), -torch.ones_like(qw))
    small = n < 1e-9
    w = sign * qv * torch.where(small, 2.0 * torch.ones_like(n),
                                theta / torch.where(small, torch.ones_like(n), n))
    th = torch.linalg.norm(w, dim=-1, keepdim=True)
    th_sq = th ** 2
    small = th < 1e-6
    safe = torch.where(small, torch.ones_like(th), th)
    A = torch.where(small, 1.0 - th_sq / 6.0, torch.sin(safe) / safe)
    B = torch.where(small, 0.5 - th_sq / 24.0, (1.0 - torch.cos(safe)) / safe ** 2)
    # V^{-1} = I - 1/2 [w]x + (1/th^2)(1 - A/(2B)) [w]x^2
    coef = torch.where(small, 1.0 / 12.0 + th_sq / 720.0,
                       (1.0 - A / (2.0 * B)) / safe ** 2)
    wxt = torch.cross(w, t, dim=-1)
    wxwxt = torch.cross(w, wxt, dim=-1)
    v = t - 0.5 * wxt + coef * wxwxt
    return torch.cat([v, w], dim=-1)


def identity(shape, dtype=torch.float32) -> torch.Tensor:
    g = torch.zeros(*shape, 7, dtype=dtype)
    g[..., 6] = 1.0
    return g
