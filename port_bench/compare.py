"""The numbers that decide ``correct``: each reads the program's outputs
against the reference's and gives one number, which the cell's limits
file bounds (``limits/<workload>.json``)."""
from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

from port_bench.reference import se3

Tensor = torch.Tensor


def max_abs(a: Tensor, b: Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def max_rel(a: Tensor, b: Tensor) -> float:
    return float(((a.float() - b.float()).abs() / b.float().abs()).max())


def tangent_gap(poses_p: Tensor, poses_r: Tensor, base: Tensor) -> float:
    """max over rows of |log(inv(r) p)| over the largest |log(inv(base)
    r)|: a pose error as a share of the motion it measures."""
    err = torch.linalg.norm(se3.log(se3.mul(se3.inv(poses_r), poses_p)), dim=-1)
    motion = torch.linalg.norm(se3.log(se3.mul(se3.inv(base), poses_r)), dim=-1)
    return float(err.max() / motion.max().clamp(min=1e-30))


def solve_gap(pose_p: Tensor, pose_r: Tensor) -> float:
    """The program's solved relative poses against the reference's solve
    of the same inputs (``tangent_gap`` from the identity)."""
    return tangent_gap(pose_p.float(), pose_r, se3.identity(
        (pose_r.shape[0],), device=pose_r.device))


def window_numbers(prog: dict, ref: dict, start_pose: Tensor,
                   scale: float) -> Dict[str, float]:
    """One tracking window: the program's captured stage outputs (NHWC)
    and returned poses against the reference's (NCHW); ``scale`` the
    depth normalization."""
    nchw = lambda x: x.permute(0, 3, 1, 2)
    ident = se3.identity((ref["pose"].shape[0],), device=ref["pose"].device)
    return {
        "flow_px": max(max_abs(nchw(prog["time_flow"]), ref["time_flow"]),
                       max_abs(nchw(prog["stereo_flow"]), ref["stereo_flow"])),
        "depth_rel": max_rel(nchw(prog["depth"]), ref["depth"]),
        "conf": max(max_abs(nchw(prog["conf1"]), ref["conf1"]),
                    max_abs(nchw(prog["conf2"]), ref["conf2"])),
        "rel_pose": tangent_gap(prog["pose"].float(), ref["pose"], ident),
        "flags": float((prog["success"].bool() != ref["success"]).sum()),
        "chain": tangent_gap(prog["poses"].float(), ref["poses"],
                             start_pose.expand_as(ref["poses"])),
        "chain_breaks": chain_breaks(prog, start_pose, scale),
    }


def chain_breaks(prog: dict, start_pose: Tensor, scale: float,
                 tol: float = 1e-3) -> float:
    """Frames whose returned pose is not the chain of the program's own
    relative poses from the pose before the window: each solved pose, the
    identity where it is not finite or |log| > 0.1, its translation over
    ``scale``, composed as ``pose * rel^-1``. A frame breaks the chain
    where the two differ by more than ``tol`` of the window's motion
    (rounding reads about 1e-6)."""
    rel = prog["pose"].float()
    bad = (~torch.isfinite(rel)).any(-1) | (se3.log(rel).abs() > 0.1).any(-1)
    rel = se3.scale(torch.where(bad[:, None], se3.identity(
        (rel.shape[0],), device=rel.device), rel), 1.0 / scale)
    chain, g = [], start_pose
    for r in rel:
        g = se3.normalize(se3.mul(g, se3.inv(r[None])))
        chain.append(g[0])
    chain = torch.stack(chain)
    err = torch.linalg.norm(se3.log(se3.mul(se3.inv(chain), prog["poses"].float())), -1)
    motion = torch.linalg.norm(se3.log(se3.mul(se3.inv(start_pose), chain)), -1)
    return float((err > tol * motion.max().clamp(min=1e-30)).sum())


def worst(rows: Iterable[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for r in rows:
        for k, v in r.items():
            out[k] = max(out.get(k, -np.inf), v)
    return out


def leaf_rows(prog: Dict[str, float], ref: Dict[str, float], keep):
    """[(gap, leaf, program's norm, reference's norm)], worst first: the
    gap between the two norms over the larger of the reference's norm of
    that leaf and the median kept leaf's."""
    kept = [k for k in ref if k in keep]
    med = float(np.median([ref[k] for k in kept])) if kept else 0.0
    return sorted(((abs(prog[k] - ref[k]) / max(ref[k], med), k, prog[k], ref[k])
                   for k in kept), reverse=True)


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keep) -> float:
    """The worst leaf's gap (``leaf_rows``)."""
    rows = leaf_rows(prog, ref, keep)
    return rows[0][0] if rows else float("nan")


def kept_leaves(first_update: Dict[str, float]):
    """The leaves the leaf gaps compare: a first update at least a
    thousandth of the median moved leaf's."""
    moved = [v for v in first_update.values() if v > 0]
    med = float(np.median(moved)) if moved else 0.0
    return {k for k, v in first_update.items() if v >= 1e-3 * med and v > 0}


def sample_gap(p: Tensor, r: Tensor) -> float:
    """Per-sample losses of one step: the widest gap over the mean
    magnitude; a row missing or extra reads infinite."""
    if p.shape != r.shape:
        return float("inf")
    return float((p.float() - r.float()).abs().max() / r.float().abs().mean())


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """Three training steps: the losses (the batch's and each sample's) and
    the gradient norms step by step,
    step 1's update as the optimizer took it and the parameters' and the
    heads' BatchNorm statistics' change after step 3, leaf by leaf: the
    worst leaf's gap and (``*_median``) the median leaf's.
    Leaves whose first update in the reference is under a thousandth of
    the median moved leaf's (a bias under a BatchNorm's batch statistics,
    whose gradient is zero but for rounding; a frozen leaf) are left out
    of the leaf gaps; ``unmoved_moved`` is the largest change the program
    made to a leaf the reference leaves exactly unchanged. RAFT's leaves,
    frozen by the job, are read by their step-1 gradient before the freeze
    (``raft_grad``, ``raft_grad_median``), those whose gradient in the
    reference is under a thousandth of the median RAFT leaf's left out."""
    out = {
        "loss": max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])),
        "sample_loss": max(sample_gap(p, r) for p, r in
                           zip(prog["sample_loss"], ref["sample_loss"])),
        "grad_norm": max(abs(p - r) / r for p, r in
                         zip(prog["grad_norm"], ref["grad_norm"])),
    }
    keep = kept_leaves(ref["first_update"])
    for k in ("first_update", "change"):
        rows = leaf_rows(prog[k], ref[k], keep)
        out[k] = rows[0][0] if rows else float("nan")
        out[k + "_median"] = (float(np.median([r[0] for r in rows])) if rows
                              else float("nan"))
    raft = kept_leaves({k: v for k, v in ref["first_grad"].items()
                        if k.startswith("flow.")})
    rows = leaf_rows(prog["first_grad"], ref["first_grad"], raft)
    out["raft_grad"] = rows[0][0] if rows else float("nan")
    out["raft_grad_median"] = (float(np.median([r[0] for r in rows])) if rows
                               else float("nan"))
    out["bn_stats"] = leaf_gap(prog["bn_change"], ref["bn_change"],
                               set(ref["bn_change"]))
    still = [k for k, v in ref["change"].items() if v == 0.0]
    out["unmoved_moved"] = max((prog["change"][k] for k in still), default=0.0)
    return out
