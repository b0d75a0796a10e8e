"""Fused normal-equation build for the LM pose solver and the whole LM
solve on the card (CUDA C++ kernels), their plain PyTorch versions, and
``pack_planes``.

Replaces ``robust_pose_tpu/ops/pallas_normal_eq.py::_normal_eq_kernel``
(``normal_equations_pallas``) and the ``lax.while_loop`` around it
(``robust_pose_tpu/solver/gauss_newton.py:solve_pose``). The kernel source,
``csrc/normal_eq.cu``, states the math, what bounds it and its
deterministic reduction. ``normal_equations`` is one H/g/cost build (K3);
``lm_solve`` is the deferred-acceptance LM loop with every build, 6 x 6
solve, retraction and stop test in ONE cooperative launch. Their plain
versions are the JAX package's einsum formulation
(``solver/gauss_newton._residuals_and_jacobians`` + ``_normal_equations``)
on the same packed planes, and the JAX loop (``lm_solve_plain``).
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
BLOCK_N = 2048  # pixels per block of a build (and the planes' padding unit)

launches = 0        # normal_equations kernel calls (build + finish count as one)
solve_launches = 0  # lm_solve kernel calls (one a solve)

# planes, pose, kvec, lw, partial, out, B, npad, h, w, div2, div3, stream
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
             + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
# planes, kvec, lw, partial, state, niter, flags, B, npad, h, w, div2, div3,
# iters, init_lambda, lambda_up, lambda_down, early_exit, tol_step, stream
_SOLVE_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 2 + [ctypes.c_int] + [ctypes.c_float] * 3
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
# H, g, lam, pose, trial, delta, fin, B, stream
_PROPOSE_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p]
STATE = 80  # floats of LM state a sample (see csrc/normal_eq.cu)


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
    _check_planes(planes, b, h, w, "normal_equations")
    pose = pose.float().contiguous()
    kvec = kvec.float().contiguous()
    lw = loss_weight.float().contiguous()
    n_blocks = planes.shape[2] * LANES // BLOCK_N
    partial = torch.empty((b, n_blocks, 28), dtype=torch.float32,
                          device=planes.device)
    out = torch.empty((b, 43), dtype=torch.float32, device=planes.device)
    fn = _build.function("normal_eq", "normal_eq", _ARGTYPES)
    _build.check(fn(_build.ptr(planes), _build.ptr(pose), _build.ptr(kvec),
                    _build.ptr(lw), _build.ptr(partial), _build.ptr(out),
                    b, n_blocks * BLOCK_N, h, w, float(h * w * h * w),
                    float(h * w), _build.stream_of(planes)), "normal_eq")
    launches += 1
    return out[:, :36].reshape(b, 6, 6), out[:, 36:42], out[:, 42]


def _check_planes(planes: Tensor, b: int, h: int, w: int, what: str) -> None:
    """The layout every kernel of this module takes (``pack_planes``'s)."""
    if (planes.dtype != torch.float32 or not planes.is_contiguous()
            or planes.dim() != 4 or planes.shape[:2] != (b, 12)
            or planes.shape[-1] != LANES
            or planes.shape[2] * LANES % BLOCK_N):
        raise ValueError(f"{what}: planes must be contiguous f32 (B, 12, S, "
                         f"{LANES}) with S * {LANES} a multiple of {BLOCK_N}, "
                         f"got {planes.dtype} {tuple(planes.shape)}")
    if planes.shape[2] * LANES < h * w:
        raise ValueError(f"{what}: planes hold fewer than H*W pixels")


def solve6(A: Tensor, b: Tensor) -> Tensor:
    """x = A^-1 b for (B, 6, 6) A and (B, 6) b by ``torch.linalg.solve_ex``
    (LAPACK on the CPU, as the JAX package's ``jnp.linalg.solve``; no host
    sync for the error check: a singular system gives a non-finite x)."""
    return torch.linalg.solve_ex(A, b[..., None])[0][..., 0]


def solve6_lu(A: Tensor, b: Tensor) -> Tensor:
    """x = A^-1 b by the solve kernel's own arithmetic, op by op: an LU
    with partial pivoting (pivot: the largest |a| of the column, the first
    on ties, a NaN before any number), every product, difference and
    quotient rounded on its own. On the card, with K3 builds,
    ``lm_solve_plain(..., solve=solve6_lu)`` takes the kernel's decisions
    bit for bit: the LM iteration counts follow the last bits of the step
    once the cost changes less than its rounding."""
    A = A.clone()
    x = b.clone()
    n = A.shape[-1]
    rows = torch.arange(A.shape[0], device=A.device)
    for k in range(n):
        col = A[:, k:, k].abs()
        p = torch.where(col.isnan(), torch.inf, col).argmax(-1) + k
        ak, ap = A[rows, k].clone(), A[rows, p].clone()
        A[rows, k], A[rows, p] = ap, ak
        xk, xp = x[rows, k].clone(), x[rows, p].clone()
        x[rows, k], x[rows, p] = xp, xk
        l = A[:, k + 1:, k] / A[:, k, k:k + 1]
        A[:, k + 1:, k + 1:] = (A[:, k + 1:, k + 1:]
                                - l[..., None] * A[:, k:k + 1, k + 1:])
        x[:, k + 1:] = x[:, k + 1:] - l * x[:, k:k + 1]
    for i in reversed(range(n)):
        s = x[:, i]
        for j in range(i + 1, n):
            s = s - A[:, i, j] * x[:, j]
        x[:, i] = s / A[:, i, i]
    return x


def lm_propose(H: Tensor, g: Tensor, lam: Tensor, pose: Tensor, solve=solve6):
    """One LM proposal from the accepted point's H, g at ``pose`` with
    Marquardt damping ``lam``: (trial = exp(delta) * pose, delta), a
    non-finite step zeroed."""
    eye6 = torch.eye(6, dtype=H.dtype, device=H.device)
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    Hd = H + (lam[:, None] * diag + 1e-12)[..., None] * eye6
    delta = -solve(Hd, g)
    delta = torch.where(torch.isfinite(delta).all(-1, keepdim=True), delta, 0.0)
    return se3.retract(delta, pose), delta


def lm_solve_plain(planes: Tensor, kvec: Tensor, loss_weight: Tensor, h: int,
                   w: int, cfg, build=normal_equations_plain, solve=solve6,
                   flags: bool = False):
    """Plain version of :func:`lm_solve`: the deferred-acceptance loop with
    one ``build`` a step (``normal_equations_plain``; ``chip_smoke.py``
    passes the K3 kernel, ``normal_equations``) and ``solve`` for the damped
    6 x 6 system (``solve6``; ``solve6_lu`` is the solve kernel's). Early
    exit is one host check of ``done.all()`` an iteration, as the JAX
    ``while_loop`` tests it. Arguments and outputs as :func:`lm_solve`; f64
    planes run the loop in f64 (a reference for the f32 solve)."""
    b = planes.shape[0]
    dev, dt = planes.device, planes.dtype   # f32, or f64 for a reference
    lw = loss_weight.to(dt)
    pose = se3.identity((b,), dtype=dt, device=dev)
    H, g, cost = build(pose, planes, kvec, lw, h, w)
    lam = torch.full((b,), cfg.init_lambda, dtype=dt, device=dev)
    trial, delta = lm_propose(H, g, lam, pose, solve)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    niter = torch.zeros((b,), dtype=torch.int32, device=dev)

    for _ in range(cfg.iters):
        if cfg.early_exit and bool(done.all()):
            break
        niter = niter + (~done).int()
        H_t, g_t, cost_t = build(trial, planes, kvec, lw, h, w)
        accept = (cost_t < cost) & ~done
        pose = torch.where(accept[:, None], trial, pose)
        cost = torch.where(accept, cost_t, cost)
        H = torch.where(accept[:, None, None], H_t, H)
        g = torch.where(accept[:, None], g_t, g)
        lam = torch.where(accept, lam * cfg.lambda_down,
                          torch.where(done, lam, lam * cfg.lambda_up))
        lam = torch.clamp(lam, 1e-9, 1e6)
        step_small = torch.linalg.norm(delta, dim=-1) <= cfg.tol_step
        done = done | (accept & step_small) | (lam >= 1e6)
        trial, delta = lm_propose(H, g, lam, pose, solve)
    if flags:
        return pose, niter, done, lam >= 1e6
    return pose, niter


def lm_solve(planes: Tensor, kvec: Tensor, loss_weight: Tensor, h: int,
             w: int, cfg, flags: bool = False, finish: bool = False):
    """The LM forward solve from the identity: the kernel on CUDA tensors
    (one launch, no host sync), the plain version on CPU tensors.

    :param planes: (B, 12, S, 128) f32 from ``pack_planes``; kvec (B, 4);
        loss_weight (B, 2)
    :param cfg: ``iters``, ``init_lambda``, ``lambda_up``, ``lambda_down``,
        ``early_exit``, ``tol_step`` (``solver.gauss_newton.SolverConfig``)
    :param flags: also return the per-sample done and failure (damping
        saturated, lam >= 1e6) flags
    :param finish: return the pose normalized and its tangent (``se3.log``;
        in the same launch on the card), as ``solve_pose`` does
    :return: pose (B, 7) (quaternion not renormalized)[, or pose normalized
        (B, 7) and tau (B, 6) with ``finish``], realized iterations (B,)
        int32[, done (B,) bool, failed (B,) bool]
    """
    global solve_launches
    b = planes.shape[0]
    _check_planes(planes, b, h, w, "lm_solve")
    if kvec.shape != (b, 4) or loss_weight.shape != (b, 2):
        raise ValueError(f"lm_solve: kvec {tuple(kvec.shape)} and loss_weight "
                         f"{tuple(loss_weight.shape)} must be (B, 4) and (B, 2)")
    if plain_or_cuda(planes, "lm_solve"):
        pose, *rest = lm_solve_plain(planes, kvec, loss_weight, h, w, cfg,
                                     flags=flags)
        if finish:
            pose = se3.normalize(pose)
            return (pose, se3.log(pose), *rest)
        return (pose, *rest)
    dev = planes.device
    kvec = kvec.float().contiguous()
    lw = loss_weight.float().contiguous()
    n_blocks = planes.shape[2] * LANES // BLOCK_N
    partial = torch.empty((b, n_blocks, 28), dtype=torch.float32, device=dev)
    state = torch.empty((b, STATE), dtype=torch.float32, device=dev)
    niter = torch.empty((b,), dtype=torch.int32, device=dev)
    flag = torch.empty((b, 2), dtype=torch.int32, device=dev)
    fn = _build.function("normal_eq", "lm_solve", _SOLVE_ARGTYPES)
    _build.check(fn(_build.ptr(planes), _build.ptr(kvec), _build.ptr(lw),
                    _build.ptr(partial), _build.ptr(state), _build.ptr(niter),
                    _build.ptr(flag), b, n_blocks * BLOCK_N, h, w,
                    float(h * w * h * w), float(h * w), int(cfg.iters),
                    float(cfg.init_lambda), float(cfg.lambda_up),
                    float(cfg.lambda_down), int(bool(cfg.early_exit)),
                    float(cfg.tol_step), _build.stream_of(planes)), "lm_solve")
    solve_launches += 1
    out = (state[:, 64:71], state[:, 71:77]) if finish else (state[:, :7],)
    if flags:
        return (*out, niter, flag[:, 0].bool(), flag[:, 1].bool())
    return (*out, niter)


def lm_update_device(H: Tensor, g: Tensor, lam: Tensor, pose: Tensor):
    """The solve kernel's per-sample arithmetic on its own, one thread a
    sample, for CUDA tensors: the proposal (damping, 6 x 6 LU, zeroed
    non-finite step, retraction), the step's norm (the ``tol_step`` test)
    and the finish of ``pose`` (normalize, log). ``chip_smoke.py`` holds
    it bit for bit to ``lm_propose(..., solve=solve6_lu)``,
    ``torch.linalg.norm``, ``se3.normalize`` and ``se3.log``. Not on any
    path. Returns (trial, delta, |delta|, pose normalized, its tangent)."""
    b = H.shape[0]
    args = [t.float().contiguous() for t in (H, g, lam, pose)]
    trial = torch.empty((b, 7), dtype=torch.float32, device=H.device)
    delta = torch.empty((b, 6), dtype=torch.float32, device=H.device)
    fin = torch.empty((b, 14), dtype=torch.float32, device=H.device)
    fn = _build.function("normal_eq", "lm_propose", _PROPOSE_ARGTYPES)
    _build.check(fn(*(_build.ptr(t) for t in args), _build.ptr(trial),
                    _build.ptr(delta), _build.ptr(fin), b,
                    _build.stream_of(H)), "lm_propose")
    return trial, delta, fin[:, 13], fin[:, :7], fin[:, 7:13]
