"""PoseNet's two entries as the benchmark drives them, on the reference
network: a frame-to-frame tracking window and a training step.

Inputs are what the benchmark made: uint8 NHWC frames, intrinsics, the
baseline, the weights (a flat dict named as the program's state_dict) and
the training batches. RAFT runs in blocks of ``block`` image pairs so that
the all-pairs volumes fit beside what the caller keeps.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from port_bench.reference import se3
from port_bench.reference.model import (
    HDIM,
    disparity_to_depth,
    encoder,
    flow_from_features,
    ident,
    prep,
    rays,
    warp,
    weight_maps,
)
from port_bench.reference.solver import Problem, lm_solve, pose_layer

Tensor = torch.Tensor


def _ckpt(fn, *args):
    """fn(*args), recomputed in the backward pass while autograd records
    (the full-width step's activations in float32 would not fit)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def raft_pairs(P, cfg, images, pairs, block, q=ident):
    """RAFT on ``pairs`` [(i, j)]: the flow from images[i] to images[j]
    (images (M, H, W, 3)), the context of images[i]. Each image is encoded
    once. Returns (flow (B, 2, H, W), hidden (B, 128, h, w), context (B,
    128, h, w)), B = len(pairs)."""
    def fnet(x):
        return encoder(P, "flow.fnet", prep(x), "instance", q)

    def cnet(x):
        c = encoder(P, "flow.cnet", prep(x), "batch", q)
        return torch.tanh(c[:, :HDIM]), F.relu(c[:, HDIM:])

    fm = torch.cat([_ckpt(fnet, images[s:s + block])
                    for s in range(0, images.shape[0], block)])
    firsts = sorted({i for i, _ in pairs})
    nets, inps = zip(*[_ckpt(cnet, images[firsts[s:s + block]])
                       for s in range(0, len(firsts), block)])
    row = {i: k for k, i in enumerate(firsts)}
    net, inp = torch.cat(nets), torch.cat(inps)
    flows, hid, ctx = [], [], []
    for s in range(0, len(pairs), block):
        pi = [row[i] for i, _ in pairs[s:s + block]]
        a = [i for i, _ in pairs[s:s + block]]
        b = [j for _, j in pairs[s:s + block]]
        fl, h = flow_from_features(P, fm[a], fm[b], net[pi], inp[pi],
                                   cfg["iters"], q, step=_ckpt)
        flows.append(fl)
        hid.append(h)
        ctx.append(inp[pi])
    return torch.cat(flows), torch.cat(hid), torch.cat(ctx)


def nchw(x: Tensor) -> Tensor:
    return x.float().permute(0, 3, 1, 2)


@torch.no_grad()
def f2f_window(P, cfg, prev_l, prev_r, limgs, rimgs, K, baseline, scale,
               start_pose, block=4, q=ident):
    """One window of T frames after the carried frame ``prev`` (both frames
    of it, (1, H, W, 3)): what ``PoseEstimator.track_window`` computes.
    ``baseline`` (1,) in pixels, ``scale`` the depth normalization,
    ``start_pose`` (1, 7) the chain's pose before the window.

    :return: dict of ``time_flow`` and ``stereo_flow`` (T, 2, H, W),
        ``depth`` (T, 1, H, W) normalized, ``conf1``, ``conf2`` (T, 1, H,
        W), ``pose`` (T, 7) the solved relative poses, ``success`` (T,),
        ``poses`` (T, 7) the chained absolute poses
    """
    t = limgs.shape[0]
    dev = limgs.device
    b_n = baseline * scale
    # images: prev_l, prev_r, l_0 .. l_T-1, r_0 .. r_T-1
    images = torch.cat([prev_l, prev_r, limgs, rimgs])
    pairs = ([(0, 1), (0, 2)] + [(2 + k, 3 + k) for k in range(t - 1)]
             + [(2 + k, 2 + t + k) for k in range(t)])
    flows, hidden, context = raft_pairs(P, cfg, images, pairs, block, q)
    prev_sflow, time_flow, sflow = flows[:1], flows[1:t + 1], flows[t + 1:]
    hidden, context = hidden[1:t + 1], context[1:t + 1]
    prev_depth, _ = disparity_to_depth(prev_sflow, b_n)
    depth2, valid2 = disparity_to_depth(sflow, b_n.expand(t))
    ones = torch.ones((t, 1) + limgs.shape[1:3], dtype=torch.bool, device=dev)
    mask2 = ones & valid2
    depth1 = torch.cat([prev_depth, depth2[:-1]])
    Kt = K.expand(t, 3, 3)
    pcl1 = depth1 * rays(Kt, *limgs.shape[1:3])
    img1 = nchw(torch.cat([prev_l, limgs[:-1]]))
    sflow1 = torch.cat([prev_sflow, sflow[:-1]])
    conf1, conf2, pcl2_w, mask2_w = weight_maps(
        P, cfg, pcl1, depth2, mask2, time_flow, img1, nchw(limgs), sflow1,
        sflow, hidden, context, Kt, q=q)
    prob = Problem(time_flow, pcl1, pcl2_w, conf1, conf2, ones, mask2_w, Kt,
                   P["loss_weight"][None].expand(t, 2))
    pose, _, _ = lm_solve(prob, cfg["lm_iters"])
    bad = (~torch.isfinite(pose)).any(-1) | (se3.log(pose).abs() > 0.1).any(-1)
    rel = torch.where(bad[:, None], se3.identity((t,), device=dev), pose)
    rel = se3.scale(rel, 1.0 / scale)
    chain, g = [], start_pose
    for r in rel:
        g = se3.normalize(se3.mul(g, se3.inv(r[None])))
        chain.append(g[0])
    return {"time_flow": time_flow, "stereo_flow": sflow, "depth": depth2,
            "conf1": conf1, "conf2": conf2, "pose": pose, "success": ~bad,
            "poses": torch.stack(chain)}


@torch.no_grad()
def f2f_solve(P, cfg, time_flow, stereo_flow, depth1, depth2, conf1, conf2, K,
              baseline, scale, build=torch.float32):
    """The window's pose solve alone, from stage outputs given (NCHW):
    the temporal and stereo flows, the depth of each frame pair's first and
    second frame and the two confidence maps. Returns the solved relative
    poses (T, 7), as ``f2f_window`` solves them from its own stages, the
    normal equations built in ``build``."""
    time_flow, stereo_flow, depth1, depth2, conf1, conf2 = (
        x.float() for x in (time_flow, stereo_flow, depth1, depth2, conf1, conf2))
    t, _, h, w = depth2.shape
    Kt = K.expand(t, 3, 3)
    _, valid2 = disparity_to_depth(stereo_flow, (baseline * scale).expand(t))
    pcl2_w = warp(depth2 * rays(Kt, h, w), time_flow)
    mask2_w = warp(valid2.float(), time_flow, "nearest") > 0.5
    ones = torch.ones_like(valid2)
    prob = Problem(time_flow, depth1 * rays(Kt, h, w), pcl2_w, conf1, conf2,
                   ones, mask2_w, Kt, P["loss_weight"][None].expand(t, 2))
    return lm_solve(prob, cfg["lm_iters"], build)[0]


def train_loss(P, cfg, batch, stats, q=ident, stop_flow_grad=False, block=8):
    """The per-sample pose loss (B, 6) of a training batch (uint8 NCHW
    images img1, img2, img1r, img2r, masks, gt (B, 7), K (B, 3, 3), bl
    (B,)), the heads' BatchNorm in training mode (new running statistics
    into ``stats``)."""
    i1, i2, i1r, i2r, m1, m2, gt, K, bl = batch
    nhwc = lambda x: x.permute(0, 2, 3, 1)
    b = i1.shape[0]
    # images 1l, 2l, 1r, 2r; pairs (1l, 1r), (2l, 2r), (1l, 2l)
    images = nhwc(torch.cat([i1, i2, i1r, i2r]))
    pairs = ([(k, 2 * b + k) for k in range(b)]
             + [(b + k, 3 * b + k) for k in range(b)]
             + [(k, b + k) for k in range(b)])
    with torch.set_grad_enabled(torch.is_grad_enabled() and not stop_flow_grad):
        flows, hidden, context = raft_pairs(P, cfg, images, pairs, block, q)
    sflow1, sflow2, time_flow = flows[:b], flows[b:2 * b], flows[2 * b:]
    hidden, context = hidden[2 * b:], context[2 * b:]
    depth1, valid1 = disparity_to_depth(sflow1, bl.float())
    depth2, valid2 = disparity_to_depth(sflow2, bl.float())
    mask1 = m1.bool() & valid1
    mask2 = m2.bool() & valid2
    h, w = i1.shape[-2:]
    pcl1 = depth1 * rays(K.float(), h, w)
    conf1, conf2, pcl2_w, mask2_w = weight_maps(
        P, cfg, pcl1, depth2, mask2, time_flow, i1.float(), i2.float(), sflow1,
        sflow2, hidden, context, K.float(), True, stats, q)
    prob = Problem(time_flow, pcl1, pcl2_w, conf1, conf2, mask1, mask2_w,
                   K.float(), P["loss_weight"][None].expand(b, 2))
    tau = pose_layer(prob, cfg["lm_iters"])
    return torch.abs(tau - se3.log(gt.float()))
