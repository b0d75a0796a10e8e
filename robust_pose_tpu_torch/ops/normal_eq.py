"""Fused normal-equation build for the LM pose solver (CUDA C++ kernel),
its plain PyTorch version, and ``pack_planes``.

Replaces ``robust_pose_tpu/ops/pallas_normal_eq.py::_normal_eq_kernel``
(``normal_equations_pallas``). The kernel source, ``csrc/normal_eq.cu``,
states the math, what bounds it and its two-pass deterministic reduction.
The plain version is the JAX package's einsum formulation
(``solver/gauss_newton._residuals_and_jacobians`` + ``_normal_equations``)
evaluated on the same packed planes.
"""
from __future__ import annotations

import ctypes

import torch

from robust_pose_tpu_torch import se3
from robust_pose_tpu_torch.device import plain_or_cuda
from robust_pose_tpu_torch.ops import _build
from robust_pose_tpu_torch.ops.geometry import create_img_coords

Tensor = torch.Tensor

LANES = 128
BLOCK_N = 2048  # pixels per pass-1 block (and the planes' padding unit)

launches = 0  # kernel calls (pass 1 + pass 2 count as one)

# planes, pose, kvec, lw, partial, out, B, npad, h, w, div2, div3,
# pix_per_block, stream
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
             + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def pack_planes(xs, h: int, w: int):
    """Transpose the solver inputs once into the kernel's channel-major
    layout (B, 12, S, 128): 0-2 pcl1, 3-5 pcl2, 6-7 flow, 8 w1*mask1,
    9 w2*mask1*mask2, 10 mask1, 11 zero; padding pixels are all zero.
    ``xs`` is a ``solver.objectives.PoseProblemInputs``. Returns
    (planes, kvec = [fx, fy, cx, cy] (B, 4))."""
    b = xs.flow.shape[0]
    n = h * w
    npad = -(-n // BLOCK_N) * BLOCK_N
    m1 = xs.mask1.float()
    m13 = (xs.mask1 & xs.mask2).float()
    chans = torch.cat([
        xs.pcl1.float(), xs.pcl2.float(), xs.flow.float(),
        xs.weights1.float() * m1, xs.weights2.float() * m13, m1,
        torch.zeros_like(m13)], dim=-1)                    # (B, H, W, 12)
    planes = torch.zeros((b, 12, npad), dtype=torch.float32,
                         device=chans.device)
    planes[:, :, :n] = chans.reshape(b, n, 12).transpose(1, 2)
    kvec = torch.stack([xs.intrinsics[:, 0, 0], xs.intrinsics[:, 1, 1],
                        xs.intrinsics[:, 0, 2], xs.intrinsics[:, 1, 2]], dim=-1)
    return planes.reshape(b, 12, npad // LANES, LANES), kvec.float()


def residuals_and_jacobians(pose, p1, p2, flow, w1, w2, K, loss_weight,
                            h: int, w: int):
    """Weighted residuals and their analytic Jacobians wrt a left tangent
    perturbation of ``pose`` (the JAX package's ``_residuals_and_jacobians``
    with the masks folded into the weights).

    :param p1, p2: (B, N, 3) clouds; flow (B, N, 2); w1 = weights1*mask1 and
        w2 = weights2*mask1*mask2, (B, N); K (B, 3, 3); loss_weight (B, 2)
    :return: r2 (B,N,2), J2 (B,N,2,6), c2 (B,N), r3 (B,N,3), J3 (B,N,3,6), c3
    """
    b, n, _ = p1.shape
    pp = se3.act(pose[:, None, :], p1)
    a = pp @ K.transpose(-1, -2)
    z = torch.clamp(a[..., 2:3], min=1e-12)
    pi = a[..., :2] / z
    img = create_img_coords(h, w, dtype=p1.dtype, device=p1.device)[:, :2]
    flow_off = img[None] + flow
    r2 = pi - flow_off
    valid2 = ((flow_off[..., 0] > 0) & (flow_off[..., 1] > 0)
              & (flow_off[..., 0] < w) & (flow_off[..., 1] < h))
    c2 = loss_weight[:, 1:2] * w1 * valid2 * (1.0 / (float(n) * h * w))
    M = (K[:, None, :2, :] - pi[..., None] * K[:, None, None, 2, :]) / z[..., None]
    J2 = torch.cat([M, torch.linalg.cross(pp[:, :, None, :].expand_as(M), M,
                                          dim=-1)], dim=-1)
    r3 = pp - p2
    c3 = loss_weight[:, 0:1] * w2 / n
    eye = torch.eye(3, dtype=pose.dtype, device=pose.device).expand(b, n, 3, 3)
    J3 = torch.cat([eye, torch.linalg.cross(pp[:, :, None, :].expand_as(eye),
                                            eye, dim=-1)], dim=-1)
    return r2, J2, c2, r3, J3, c3


def normal_equations_plain(pose: Tensor, planes: Tensor, kvec: Tensor,
                           loss_weight: Tensor, h: int, w: int):
    """Plain version: H = J^T W J, g = J^T W r and cost by einsums over
    materialized Jacobians (the JAX package's ``_normal_equations``), in
    f32, or in f64 for f64 planes (a reference for the f32 sums)."""
    b = pose.shape[0]
    n = h * w
    dt = torch.float64 if planes.dtype == torch.float64 else torch.float32
    pl = planes.reshape(b, 12, -1)[:, :, :n].to(dt)
    fx, fy, cx, cy = kvec.to(dt).unbind(-1)
    zero, one = torch.zeros_like(fx), torch.ones_like(fx)
    K = torch.stack([fx, zero, cx, zero, fy, cy, zero, zero, one],
                    dim=-1).reshape(b, 3, 3)
    r2, J2, c2, r3, J3, c3 = residuals_and_jacobians(
        pose.to(dt), pl[:, 0:3].transpose(1, 2), pl[:, 3:6].transpose(1, 2),
        pl[:, 6:8].transpose(1, 2), pl[:, 8], pl[:, 9], K,
        loss_weight.to(dt), h, w)
    H = (torch.einsum("bn,bnri,bnrj->bij", c2, J2, J2)
         + torch.einsum("bn,bnri,bnrj->bij", c3, J3, J3))
    g = (torch.einsum("bn,bnri,bnr->bi", c2, J2, r2)
         + torch.einsum("bn,bnri,bnr->bi", c3, J3, r3))
    cost = ((c2 * (r2 * r2).sum(-1)).sum(-1)
            + (c3 * (r3 * r3).sum(-1)).sum(-1))
    return H, g, cost


def normal_equations(pose: Tensor, planes: Tensor, kvec: Tensor,
                     loss_weight: Tensor, h: int, w: int):
    """Fused H/g/cost build; kernel on CUDA tensors, plain version on CPU.

    :param pose: (B, 7); planes (B, 12, S, 128) f32 from ``pack_planes``;
        kvec (B, 4); loss_weight (B, 2)
    :return: H (B, 6, 6), g (B, 6), cost (B,)
    """
    global launches
    if plain_or_cuda(planes, "normal_equations"):
        return normal_equations_plain(pose, planes, kvec, loss_weight, h, w)
    b = pose.shape[0]
    if (planes.dtype != torch.float32 or not planes.is_contiguous()
            or planes.shape[:2] != (b, 12) or planes.shape[-1] != LANES):
        raise ValueError("normal_equations: planes must be contiguous f32 "
                         f"(B, 12, S, {LANES}), got {tuple(planes.shape)}")
    npad = planes.shape[2] * LANES
    if npad < h * w:
        raise ValueError("normal_equations: planes hold fewer than H*W pixels")
    pose = pose.float().contiguous()
    kvec = kvec.float().contiguous()
    lw = loss_weight.float().contiguous()
    n_blocks = -(-npad // BLOCK_N)
    partial = torch.empty((b, n_blocks, 28), dtype=torch.float32,
                          device=planes.device)
    out = torch.empty((b, 43), dtype=torch.float32, device=planes.device)
    fn = _build.function("normal_eq", "normal_eq", _ARGTYPES)
    _build.check(fn(_build.ptr(planes), _build.ptr(pose), _build.ptr(kvec),
                    _build.ptr(lw), _build.ptr(partial), _build.ptr(out),
                    b, npad, h, w, float(h * w * h * w), float(h * w),
                    BLOCK_N, _build.stream_of(planes)), "normal_eq")
    launches += 1
    return out[:, :36].reshape(b, 6, 6), out[:, 36:42], out[:, 42]
