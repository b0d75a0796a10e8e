"""The PoseNet training step on the reference network: the pose loss of
``reference.posenet.train_loss``, its gradient, and the optimizer of the
published job: the global-norm clip, then AdamW (optax's ``adamw`` with
``eps`` outside the square root and decoupled decay), RAFT's parameters
frozen while the step count is below ``freeze_flow_steps`` (forever when
the key is absent).
"""
from __future__ import annotations

import torch

from port_bench.reference.model import ident
from port_bench.reference.posenet import train_loss

B1, B2 = 0.9, 0.999


def is_buffer(name: str) -> bool:
    return name.endswith(("running_mean", "running_var"))


def train_steps(weights: dict, cfg: dict, batches, steps: int, q=ident):
    """``steps`` optimizer steps from ``weights`` over ``batches`` in order.
    Returns a dict of lists by step: ``loss`` (the mean of the per-sample
    summed pose loss, NaN samples skipped), ``sample_loss`` (the
    per-sample summed pose loss (B,)), ``grad_norm`` (of every
    gradient, before the freeze and the clip), ``first_grad`` (step 1's
    gradient by parameter, before the freeze and the clip, zero where there
    is none), ``first_update`` (step 1's
    gradient as the optimizer takes it, after the freeze and the clip, by
    parameter) and the final ``weights`` (parameters and BatchNorm statistics)."""
    tr = cfg["train"]
    model = cfg["model"]
    stop_flow = tr.get("stop_flow_grad", tr.get("freeze_flow_steps") is None)
    freeze = tr.get("freeze_flow_steps")
    lr, wd = tr["learning_rate"], tr["weight_decay"]
    eps, clip = tr["epsilon"], tr["grad_clip"]
    rcfg = {"iters": model["iters"], "unet_levels": model.get("unet_levels", 3),
            "lm_iters": model["lbgfs_iters"]}
    P = {k: v.detach().clone().requires_grad_(not is_buffer(k))
         for k, v in weights.items()}
    params = [k for k in P if not is_buffer(k)]
    mu = {k: torch.zeros_like(P[k]) for k in params}
    nu = {k: torch.zeros_like(P[k]) for k in params}
    out = {"loss": [], "grad_norm": [], "sample_loss": []}
    for step in range(steps):
        stats = {}
        loss = train_loss(P, rcfg, batches[step % len(batches)], stats, q,
                          stop_flow_grad=stop_flow)
        loss.mean().backward()
        with torch.no_grad():
            out["loss"].append(float(torch.nanmean(loss.sum(-1))))
            out["sample_loss"].append(loss.sum(-1))
            live = {k: P[k].grad for k in params if P[k].grad is not None}
            out["grad_norm"].append(float(torch.sqrt(sum(
                (g.double() ** 2).sum() for g in live.values()))))
            frozen = freeze is None or step < freeze
            g = {k: (torch.zeros_like(P[k]) if k not in live
                     or (frozen and k.startswith("flow.")) else live[k])
                 for k in params}
            gnorm = torch.sqrt(sum((v * v).sum() for v in g.values()))
            if not bool(gnorm < clip):
                g = {k: v / gnorm * clip for k, v in g.items()}
            if step == 0:
                out["first_grad"] = {k: live[k].clone() if k in live
                                     else torch.zeros_like(P[k]) for k in params}
                out["first_update"] = {k: v.clone() for k, v in g.items()}
            bc1 = 1.0 - B1 ** (step + 1)
            bc2 = 1.0 - B2 ** (step + 1)
            for k in params:
                mu[k].mul_(B1).add_((1 - B1) * g[k])
                nu[k].mul_(B2).add_((1 - B2) * g[k] * g[k])
                if frozen and k.startswith("flow."):
                    continue
                u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps) + wd * P[k]
                P[k].add_(-lr * u)
                P[k].grad = None
            for k in params:
                P[k].grad = None
            for k, v in stats.items():
                P[k] = v
    out["weights"] = {k: v.detach() for k, v in P.items()}
    return out
