"""Levenberg-Marquardt SE(3) pose solve, forward only (port of
``robust_pose_tpu/solver/gauss_newton.py::solve_pose``).

Deferred-acceptance LM with Marquardt damping: each iteration evaluates
the normal equations once, at the trial point (``ops.normal_eq``, the
fused kernel on the card); the accepted point's H/g are kept so a rejected
trial re-proposes from them with more damping. A non-finite step is
zeroed. A sample is done once an accepted step is shorter than
``tol_step`` or the damping saturates; done samples are frozen.

Early exit: after each iteration one host check of ``done.all()`` ends the
loop, as the JAX ``while_loop`` does. Because done samples are frozen, the
outputs and the realized per-sample iteration counts equal those of a run
to the cap. The implicit-function-theorem backward waits for the training
slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from robust_pose_tpu_torch import se3
from robust_pose_tpu_torch.ops.normal_eq import normal_equations, pack_planes
from robust_pose_tpu_torch.solver.objectives import PoseProblemInputs

Tensor = torch.Tensor


class SolverConfig(NamedTuple):
    iters: int = 20           # iteration cap (config key lbgfs_iters)
    init_lambda: float = 1e-4
    lambda_up: float = 4.0
    lambda_down: float = 0.25
    early_exit: bool = True   # stop once every sample is done
    tol_step: float = 1e-6    # tangent-norm convergence threshold


def solve_pose(xs: PoseProblemInputs, cfg: SolverConfig):
    """Minimize the weighted 2D+3D objective over SE(3), starting at the
    identity. Returns ``(pose7 (B, 7), tau6 (B, 6), iters (B,) int32)``,
    ``iters`` being the realized per-sample LM iteration count."""
    b, h, w, _ = xs.flow.shape
    dev = xs.flow.device
    planes, kvec = pack_planes(xs, h, w)
    lw = xs.loss_weight.float()
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)

    def normal_eq(pose):
        return normal_equations(pose, planes, kvec, lw, h, w)

    def propose(H, g, lam, pose):
        diag = torch.diagonal(H, dim1=-2, dim2=-1)
        Hd = H + (lam[:, None] * diag + 1e-12)[..., None] * eye6
        # solve_ex: no host sync for the error check; a singular system
        # yields a non-finite step, zeroed below
        delta = -torch.linalg.solve_ex(Hd, g[..., None])[0][..., 0]
        delta = torch.where(torch.isfinite(delta).all(-1, keepdim=True),
                            delta, 0.0)
        return se3.retract(delta, pose), delta

    pose = se3.identity((b,), device=dev)
    H, g, cost = normal_eq(pose)
    lam = torch.full((b,), cfg.init_lambda, dtype=torch.float32, device=dev)
    trial, delta = propose(H, g, lam, pose)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    niter = torch.zeros((b,), dtype=torch.int32, device=dev)

    for _ in range(cfg.iters):
        if cfg.early_exit and bool(done.all()):
            break
        niter = niter + (~done).int()
        H_t, g_t, cost_t = normal_eq(trial)
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
        trial, delta = propose(H, g, lam, pose)

    pose = se3.normalize(pose)
    return pose, se3.log(pose), niter
