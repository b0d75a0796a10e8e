"""Levenberg-Marquardt SE(3) pose solve and its implicit-function-theorem
backward (port of ``robust_pose_tpu/solver/gauss_newton.py``:
``solve_pose`` and ``make_pose_layer``).

Deferred-acceptance LM with Marquardt damping: each iteration evaluates
the normal equations once, at the trial point; the accepted point's H/g
are kept so a rejected trial re-proposes from them with more damping. A
non-finite step is zeroed. A sample is done once an accepted step is
shorter than ``tol_step`` or the damping saturates; done samples are
frozen. Early exit ends the loop once every sample is done, as the JAX
``while_loop`` does; because done samples are frozen, the outputs and the
realized per-sample iteration counts equal those of a run to the cap.

On the card the whole loop is ONE kernel launch (``ops.normal_eq.lm_solve``:
builds, 6 x 6 solves, retractions, stop test, and the normalized pose's
tangent), with no host sync; on the
CPU it runs as the plain loop (``lm_solve_plain``), whose early exit is
one host check of ``done.all()`` an iteration.

``pose_layer`` is the differentiable layer: ``solve_pose`` forward, and a
backward through the optimality condition of the solution (see
``_PoseLayer``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from robust_pose_tpu_torch import se3
from robust_pose_tpu_torch.ops.normal_eq import lm_solve, pack_planes
from robust_pose_tpu_torch.ops.geometry import create_img_coords
from robust_pose_tpu_torch.solver.objectives import (
    PoseProblemInputs,
    objective_at_tangent,
)

Tensor = torch.Tensor


class SolverConfig(NamedTuple):
    iters: int = 20           # iteration cap (config key lbgfs_iters)
    init_lambda: float = 1e-4
    lambda_up: float = 4.0
    lambda_down: float = 0.25
    early_exit: bool = True   # stop once every sample is done
    tol_step: float = 1e-6    # tangent-norm convergence threshold
    eps_optimality: float = 1e-3  # backward: max |dE/deps| of a solution
    gamma: float = 0.0        # backward: Hessian damping


def solve_pose(xs: PoseProblemInputs, cfg: SolverConfig):
    """Minimize the weighted 2D+3D objective over SE(3), starting at the
    identity. Returns ``(pose7 (B, 7), tau6 (B, 6), iters (B,) int32)``,
    ``iters`` being the realized per-sample LM iteration count."""
    b, h, w, _ = xs.flow.shape
    planes, kvec = pack_planes(xs, h, w)
    return lm_solve(planes, kvec, xs.loss_weight, h, w, cfg, finish=True)


def _grad_at_solution(pose: Tensor, xs: PoseProblemInputs, create_graph: bool):
    """Per-sample gradient of ``objective_at_tangent`` at eps = 0, (B, 6),
    and the eps it was taken at."""
    b, h, w, _ = xs.flow.shape
    img = create_img_coords(h, w, device=pose.device)
    eps = torch.zeros((b, 6), dtype=pose.dtype, device=pose.device,
                      requires_grad=True)
    e = objective_at_tangent(eps, pose, xs, img)
    (fY,) = torch.autograd.grad(e.sum(), eps, create_graph=create_graph)
    return fY, eps


class _PoseLayer(torch.autograd.Function):
    """``solve_pose`` with the JAX ``make_pose_layer`` backward: only the
    tangent output carries a gradient.

    Backward, per sample: pull the cotangent v of tau = log(pose) back to
    the left tangent eps through tau(eps) = log(exp(eps) * pose); take the
    gradient fY and the symmetrized Hessian H (+ gamma I) of
    ``objective_at_tangent`` at eps = 0; u = -H^-1 v, zero where
    max |fY| > eps_optimality or u is not finite; then the input gradients
    are the VJP u^T d(fY)/d(input) for every floating input, NaN scrubbed.
    """

    @staticmethod
    def forward(ctx, cfg, *inputs):
        xs = PoseProblemInputs(*inputs)
        pose, tau, niter = solve_pose(xs, cfg)
        ctx.cfg = cfg
        ctx.save_for_backward(pose, *inputs)
        ctx.mark_non_differentiable(pose, niter)
        return pose, tau, niter

    @staticmethod
    def backward(ctx, _g_pose, v, _g_iters):
        pose, *inputs = ctx.saved_tensors
        cfg = ctx.cfg
        with torch.enable_grad():
            eps = torch.zeros_like(v, requires_grad=True)
            (v,) = torch.autograd.grad(se3.log(se3.retract(eps, pose)), eps, v)
            diff = [t.is_floating_point() for t in inputs]
            xin = [t.detach().requires_grad_() if d else t
                   for t, d in zip(inputs, diff)]
            fY, eps = _grad_at_solution(pose, PoseProblemInputs(*xin), True)
            H = torch.stack([torch.autograd.grad(fY[:, k].sum(), eps,
                                                 retain_graph=True)[0]
                             for k in range(6)], dim=1)
        H = 0.5 * (H + H.transpose(-1, -2))
        if cfg.gamma:
            H = H + cfg.gamma * torch.eye(6, dtype=H.dtype, device=H.device)
        optimal = fY.detach().abs().amax(dim=-1) <= cfg.eps_optimality
        u = -torch.linalg.solve_ex(H, v[..., None])[0][..., 0]
        ok = optimal & torch.isfinite(u).all(dim=-1)
        u = torch.nan_to_num(torch.where(ok[:, None], u, 0.0))
        wrt = [t for t, d in zip(xin, diff) if d]
        grads = iter(torch.autograd.grad(fY, wrt, u, allow_unused=True))
        out = []
        for t, d in zip(xin, diff):
            g = next(grads) if d else None
            out.append(None if g is None else torch.nan_to_num(g))
        return (None, *out)


def pose_layer(xs: PoseProblemInputs, cfg: SolverConfig):
    """Differentiable ``solve_pose``: ``(pose7, tau6, iters)``, gradients
    through ``tau6`` only (the JAX package's ``make_pose_layer``)."""
    return _PoseLayer.apply(cfg, *xs)
