"""Generic deep-declarative (implicit differentiation) layer (port of
``robust_pose_tpu/solver/declarative.py``).

Wraps any inner solver and objective into a layer whose backward applies
the implicit function theorem, with the reference's failure rule: a
sample's gradient is zero where the optimality condition fails
(``max |dE/dy| > eps_optimality``) or the Hessian solve is not finite. The
SE(3) pose layer (``solver/gauss_newton.pose_layer``) is the specialised
case with Lie-group charts; this one serves Euclidean outputs.

``xs`` may be any pytree of tensors with a leading batch dimension (a
tuple, a NamedTuple, a dict); gradients reach its floating-point leaves.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree

Tensor = torch.Tensor


def make_declarative_layer(solve: Callable, objective: Callable,
                           eps_optimality: float = 1e-3,
                           gamma: float = 0.0) -> Callable:
    """Build a differentiable argmin layer.

    :param solve: ``solve(xs) -> y (B, M)``, the inner optimizer (not
        differentiated: only its output matters)
    :param objective: ``objective(xs, y) -> (B,)``, a smooth objective whose
        minimum ``solve`` approximates
    :param eps_optimality: the largest |dE/dy| tolerated at the solution
        before the sample's gradient falls back to zero
    :param gamma: damping added to the Hessian in the backward
    :return: ``layer(xs) -> y`` with ``dL/dxs = -v^T H^{-1} d2E/(dy dxs)``,
        H the symmetrised Hessian of E in y, per sample
    """

    def per_sample(spec):
        """E of one sample, as a function of (y, *leaves)."""
        def f(y_s, *leaves_s):
            xs_s = pytree.tree_unflatten([x[None] for x in leaves_s], spec)
            return objective(xs_s, y_s[None])[0]
        return f

    class _Layer(torch.autograd.Function):
        @staticmethod
        def forward(ctx, spec, *leaves):
            with torch.no_grad():
                y = solve(pytree.tree_unflatten(list(leaves), spec))
            ctx.spec = spec
            ctx.save_for_backward(y, *leaves)
            return y

        @staticmethod
        @torch.autograd.function.once_differentiable
        def backward(ctx, v):
            y, *leaves = ctx.saved_tensors
            f = per_sample(ctx.spec)
            fy = torch.func.vmap(torch.func.grad(f))
            with torch.enable_grad():
                g = fy(y, *leaves)
                hess = torch.func.vmap(torch.func.hessian(f))(y, *leaves)
            hess = 0.5 * (hess + hess.transpose(-1, -2))
            if gamma:
                hess = hess + gamma * torch.eye(hess.shape[-1], dtype=hess.dtype,
                                                device=hess.device)
            optimal = g.abs().amax(dim=-1) <= eps_optimality
            u, info = torch.linalg.solve_ex(hess, v[..., None])
            u = -u[..., 0]
            ok = optimal & (info == 0) & torch.isfinite(u).all(dim=-1)
            u = torch.nan_to_num(torch.where(ok[:, None], u, 0.0))
            floats = [i for i, t in enumerate(leaves) if t.is_floating_point()]

            def fy_of(*fl):
                args = list(leaves)
                for i, t in zip(floats, fl):
                    args[i] = t
                return fy(y, *args)

            _, vjp = torch.func.vjp(fy_of, *[leaves[i] for i in floats])
            grads = [None] * len(leaves)
            for i, gi in zip(floats, vjp(u)):
                grads[i] = torch.nan_to_num(gi)
            return (None, *grads)

    def layer(xs):
        leaves, spec = pytree.tree_flatten(xs)
        return _Layer.apply(spec, *leaves)

    return layer
