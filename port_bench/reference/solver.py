"""The pose objective, its Levenberg-Marquardt solve from the identity and
the implicit-function backward, in plain tensors.

The objective of a sample, for a pose T:

    E(T) = lw_2d * mean_p [w1 |pi(K T p1) - (x + 0.5 + flow)|^2 v2] / (H W)
         + lw_3d * mean_p [w2 |T p1 - p2|^2 m1 m2]

v2: the flow target inside the image and mask1; pi the pinhole projection.
The solve is Levenberg-Marquardt with Marquardt damping and deferred
acceptance over the Gauss-Newton normal equations, as the measured program
runs it (its constants: ``LM``). The backward applies the
implicit function theorem at the solution: the cotangent of log(T) is
pulled back to the left tangent, u = -H^-1 v with H the Hessian of E at
the solution, zero where max |dE/deps| > 1e-3 or u is not finite, and the
inputs' gradients are u^T d(dE/deps)/d(input).
"""
from __future__ import annotations

import torch

from port_bench.reference import se3

Tensor = torch.Tensor

LM = {"init_lambda": 1e-4, "lambda_up": 4.0, "lambda_down": 0.25,
      "tol_step": 1e-6, "eps_optimality": 1e-3}


def _pixels(h, w, dtype, device):
    ys, xs = torch.meshgrid(torch.arange(h, dtype=dtype, device=device) + 0.5,
                            torch.arange(w, dtype=dtype, device=device) + 0.5,
                            indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], -1)     # (N, 2)


class Problem:
    """One batch of pose problems, NCHW inputs flattened to (B, N, .)."""

    def __init__(self, flow, pcl1, pcl2, w1, w2, m1, m2, K, lw):
        b, _, h, w = flow.shape
        self.h, self.w = h, w
        f = lambda t: t.reshape(b, t.shape[1], -1).transpose(1, 2)
        self.flow, self.p1, self.p2 = f(flow), f(pcl1), f(pcl2)
        self.w1, self.w2 = f(w1)[..., 0], f(w2)[..., 0]
        self.m1, self.m2 = f(m1)[..., 0], f(m2)[..., 0]
        self.K, self.lw = K, lw

    def to(self, dtype):
        p = Problem.__new__(Problem)
        p.__dict__.update({k: (v.to(dtype) if torch.is_tensor(v)
                               and v.is_floating_point() else v)
                           for k, v in self.__dict__.items()})
        return p

    def energy(self, pose: Tensor) -> Tensor:
        """E per sample for poses (B, 7); differentiable in every float
        input and the pose."""
        h, w = self.h, self.w
        pp = se3.act(pose[:, None], self.p1)
        a = pp @ self.K.transpose(-1, -2)
        pi = a[..., :2] / torch.clamp(a[..., 2:3], min=1e-12)
        tgt = _pixels(h, w, pp.dtype, pp.device)[None] + self.flow
        r2 = ((pi - tgt) ** 2).sum(-1) * self.w1
        v2 = ((tgt[..., 0] > 0) & (tgt[..., 1] > 0) & (tgt[..., 0] < w)
              & (tgt[..., 1] < h) & self.m1 & torch.isfinite(r2))
        e2 = torch.where(v2, r2, 0.0).mean(1) / (h * w)
        r3 = ((pp - self.p2) ** 2).sum(-1) * self.w2
        e3 = torch.where(self.m1 & self.m2, r3, 0.0).mean(1)
        return self.lw[:, 1] * e2 + self.lw[:, 0] * e3

    def normal_equations(self, pose: Tensor):
        """Gauss-Newton H (B, 6, 6), g (B, 6) and E at ``pose``: analytic
        Jacobians of the residuals under a left perturbation."""
        h, w = self.h, self.w
        b, n, _ = self.p1.shape
        pp = se3.act(pose[:, None], self.p1)
        a = pp @ self.K.transpose(-1, -2)
        z = torch.clamp(a[..., 2:3], min=1e-12)
        pi = a[..., :2] / z
        tgt = _pixels(h, w, pp.dtype, pp.device)[None] + self.flow
        r2 = pi - tgt
        inb = ((tgt[..., 0] > 0) & (tgt[..., 1] > 0) & (tgt[..., 0] < w)
               & (tgt[..., 1] < h))
        c2 = self.lw[:, 1:2] * self.w1 * (self.m1 & inb) / (n * h * w)
        c3 = self.lw[:, 0:1] * self.w2 * (self.m1 & self.m2) / n
        M = (self.K[:, None, :2, :] - pi[..., None] * self.K[:, None, None, 2, :]) / z[..., None]
        J2 = torch.cat([M, torch.linalg.cross(pp[:, :, None].expand_as(M), M, dim=-1)], -1)
        eye = torch.eye(3, dtype=pp.dtype, device=pp.device).expand(b, n, 3, 3)
        J3 = torch.cat([eye, torch.linalg.cross(pp[:, :, None].expand_as(eye), eye, dim=-1)], -1)
        r3 = pp - self.p2
        H = (torch.einsum("bn,bnri,bnrj->bij", c2, J2, J2)
             + torch.einsum("bn,bnri,bnrj->bij", c3, J3, J3))
        g = (torch.einsum("bn,bnri,bnr->bi", c2, J2, r2)
             + torch.einsum("bn,bnri,bnr->bi", c3, J3, r3))
        cost = (c2 * (r2 * r2).sum(-1)).sum(-1) + (c3 * (r3 * r3).sum(-1)).sum(-1)
        return H, g, cost


def _propose(H, g, lam, pose):
    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    Hd = H + (lam[:, None] * diag + 1e-12)[..., None] * eye
    delta = -torch.linalg.solve_ex(Hd, g[..., None])[0][..., 0]
    delta = torch.where(torch.isfinite(delta).all(-1, keepdim=True), delta, 0.0)
    return se3.retract(delta, pose), delta


@torch.no_grad()
def lm_solve(prob: Problem, iters: int, build=torch.float32):
    """(pose normalized (B, 7), log of it (B, 6), iterations (B,)) of the
    damped solve in float32, from the identity; the normal equations are
    built in ``build`` (the problem and the pose rounded to it)."""
    p = prob.to(build)
    dtype = torch.float32
    b = p.p1.shape[0]
    dev = p.p1.device

    def equations(pose):
        return tuple(x.to(dtype) for x in p.normal_equations(pose.to(build)))

    pose = se3.identity((b,), dtype, dev)
    H, g, cost = equations(pose)
    lam = torch.full((b,), LM["init_lambda"], dtype=dtype, device=dev)
    trial, delta = _propose(H, g, lam, pose)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    niter = torch.zeros(b, dtype=torch.int64, device=dev)
    for _ in range(iters):
        niter += (~done).long()
        Ht, gt, ct = equations(trial)
        acc = (ct < cost) & ~done
        pose = torch.where(acc[:, None], trial, pose)
        cost = torch.where(acc, ct, cost)
        H = torch.where(acc[:, None, None], Ht, H)
        g = torch.where(acc[:, None], gt, g)
        lam = torch.where(acc, lam * LM["lambda_down"],
                          torch.where(done, lam, lam * LM["lambda_up"]))
        lam = torch.clamp(lam, 1e-9, 1e6)
        small = torch.linalg.norm(delta, dim=-1) <= LM["tol_step"]
        done = done | (acc & small) | (lam >= 1e6)
        trial, delta = _propose(H, g, lam, pose)
    pose = se3.normalize(pose).to(prob.p1.dtype)
    return pose, se3.log(pose), niter


def _fields(prob: Problem):
    return ("flow", "p1", "p2", "w1", "w2")


class _PoseLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, prob, iters, *leaves):
        pose, tau, _ = lm_solve(prob, iters)
        ctx.prob = prob
        ctx.save_for_backward(pose, *leaves)
        return tau

    @staticmethod
    def backward(ctx, v):
        pose, *leaves = ctx.saved_tensors
        prob = ctx.prob
        with torch.enable_grad():
            eps = torch.zeros_like(v, requires_grad=True)
            (v,) = torch.autograd.grad(se3.log(se3.retract(eps, pose)), eps, v)
            xin = [t.detach().requires_grad_() for t in leaves]
            p = Problem.__new__(Problem)
            p.__dict__.update(prob.__dict__)
            for k, t in zip(_fields(prob) + ("lw",), xin):
                setattr(p, k, t)
            eps = torch.zeros_like(v, requires_grad=True)
            e = p.energy(se3.retract(eps, pose))
            (fy,) = torch.autograd.grad(e.sum(), eps, create_graph=True)
            H = torch.stack([torch.autograd.grad(fy[:, k].sum(), eps,
                                                 retain_graph=True)[0]
                             for k in range(6)], 1)
        H = 0.5 * (H + H.transpose(-1, -2))
        optimal = fy.detach().abs().amax(-1) <= LM["eps_optimality"]
        u = -torch.linalg.solve_ex(H, v[..., None])[0][..., 0]
        ok = optimal & torch.isfinite(u).all(-1)
        u = torch.nan_to_num(torch.where(ok[:, None], u, 0.0))
        grads = torch.autograd.grad(fy, xin, u, allow_unused=True)
        return (None, None, *[None if g is None else torch.nan_to_num(g)
                              for g in grads])


def pose_layer(prob: Problem, iters: int) -> Tensor:
    """log of the solved pose (B, 6); differentiable in flow, the clouds,
    the weights and the loss weights through the implicit function."""
    leaves = [getattr(prob, k) for k in _fields(prob)] + [prob.lw]
    return _PoseLayer.apply(prob, iters, *leaves)
