"""Golden-parity harness: hold the port to the reference network on the
reference's own checkpoint format (port of ``scripts/verify_parity.py``).

The reference ships ``trained/poseNet_2xf8up4b.pth`` (the default
checkpoint of its scripts/infer_trajectory.py) and warm-starts RAFT from
``raft-things.pth`` (its core/pose/pose_net.py). With such a file:

    python -m robust_pose_tpu_torch.scripts.verify_parity --posenet poseNet_2xf8up4b.pth

Modes (composable):
  default      convert the .pth through ``utils/torch_convert``, load the
               SAME weights into the reference network
               (``robust_pose_tpu_torch/reference``, the reference
               reassembled module for module), run both over a frame
               sequence and compare flows / depths / confidences /
               per-frame poses / the chained trajectory's ATE.
  --record F   also save the reference network's outputs to F (.npz)
  --golden F   compare against a recorded .npz (this harness's or the JAX
               package's ``scripts/verify_parity.py --record``) instead of
               running the reference network
  --raft F     convert raft-things.pth through ``convert_raft_pth`` as
               well and load it into the port's RAFT (strict)
  --selftest   synthesize a random-weights .pth in the reference's on-disk
               format ({'state_dict': ..., 'config': ...}, DataParallel
               'module.' prefixes included) and run the harness on it:
               proves the harness end to end without the real files.
  --data DIR   left/right PNG pairs from DIR (sorted; *_left/*_right or
               l_*/r_* naming) instead of the synthetic sequence.
  --device D   where the port runs: cuda (default; without a card, cpu
               must be named) or cpu.
  --json F     also write the rows, values unrounded, to F.

The port runs in f32 (TF32 off, deterministic cuDNN) with RAFT's lookup
"auto": on a card the flow runs K1, the fnet norms K2 and the pose solve
K3's LM kernel. The reference network always runs on the CPU in f32
(numerics belong on f32 CPU), and evaluates its f64 objective at its
LBFGS pose and at the identity, which the descent-gated pose checks use.

Exit code 0 = all checks within tolerance.
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

TOL = {
    "flow_px": 5e-2,        # max |flow_port - flow_ref| in pixels
    "depth_rel": 1e-2,      # median relative depth error
    "conf_abs": 5e-2,       # max confidence delta
    "pose_tan": 5e-3,       # per-frame tangent-space pose distance
    "obj_excess": 5e-3,     # LM objective may exceed LBFGS's by at most this
    "ate_rel": 1e-2,        # chained-ATE relative mismatch (the BASELINE
                            # 'ATE within 1%' criterion)
}


def gaussian_blur(img, sigma=3.0):
    """OpenCV's ``GaussianBlur(img, (0, 0), sigma)`` on a float32 (H, W, C)
    image: its 25-tap kernel for float images (``getGaussianKernel``,
    rounded to f32) applied along rows then columns with reflect-101
    borders, summed in f64. Agrees with OpenCV to its f32 rounding; used
    where OpenCV is not installed."""
    n = int(round(sigma * 4 * 2 + 1)) | 1
    x = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
    k = np.exp(-x * x / (2.0 * sigma * sigma))
    k = (k / k.sum()).astype(np.float32).astype(np.float64)
    r = n // 2
    out = np.asarray(img, np.float64)
    for axis in (1, 0):
        pad = [(0, 0)] * out.ndim
        pad[axis] = (r, r)
        p = np.pad(out, pad, mode="reflect")
        size = out.shape[axis]
        out = sum(k[i] * np.take(p, np.arange(i, i + size), axis=axis)
                  for i in range(n))
    return out.astype(np.float32)


def make_synthetic_sequence(h, w, n=5, disparity=6, step=4, seed=42):
    """The JAX harness's sequence: shifted crops of one blurred random
    texture, a stereo camera translating horizontally. OpenCV's blur where
    OpenCV is installed (the frames the JAX harness makes), else
    ``gaussian_blur``."""
    rng = np.random.default_rng(seed)
    tex = rng.integers(0, 255, (h, w + disparity + step * n + 8, 3)).astype(
        np.float32)
    try:
        import cv2
        base = cv2.GaussianBlur(tex, (0, 0), 3)
    except ImportError:
        base = gaussian_blur(tex, 3.0)
    return [(base[:, step * i:step * i + w],
             base[:, step * i + disparity:step * i + disparity + w])
            for i in range(n)]


def load_data_dir(path, h, w):
    import cv2

    lefts = sorted(f for f in os.listdir(path)
                   if "left" in f or f.startswith("l_"))
    rights = sorted(f for f in os.listdir(path)
                    if "right" in f or f.startswith("r_"))
    assert len(lefts) == len(rights) and lefts, f"no stereo pairs in {path}"
    frames = []
    for lf, rf in zip(lefts, rights):
        l = cv2.cvtColor(cv2.imread(os.path.join(path, lf)),
                         cv2.COLOR_BGR2RGB).astype(np.float32)
        r = cv2.cvtColor(cv2.imread(os.path.join(path, rf)),
                         cv2.COLOR_BGR2RGB).astype(np.float32)
        frames.append((cv2.resize(l, (w, h)), cv2.resize(r, (w, h))))
    return frames


def load_torch_oracle(pth_path, config):
    """Load the state_dict into the reference network (its state_dict keys
    are the reference checkpoints')."""
    from robust_pose_tpu_torch.reference.posenet import PoseNet as TorchPoseNet
    from robust_pose_tpu_torch.utils.torch_convert import strip_module_prefix

    checkp = torch.load(pth_path, map_location="cpu", weights_only=False)
    sd = strip_module_prefix(checkp["state_dict"])
    tmodel = TorchPoseNet(config)
    tmodel.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    tmodel.eval()
    return tmodel


def run_torch_oracle(tmodel, frames, K, baseline, config):
    """Roll the reference tracking loop (the reference's
    pose_estimator.py semantics). Besides the per-frame outputs, evaluates
    the f64 objective at the solved pose AND at identity: the LBFGS descent
    certificate the pose checks are gated on (the reference's
    pose_head.py runs lr=1 LBFGS with no line search, which can overshoot
    on ill-conditioned problems)."""
    h, w = config["image_shape"]
    tK = torch.tensor(K)[None]
    bl = torch.tensor([baseline])
    t = lambda x: torch.tensor(x.transpose(2, 0, 1))[None]
    outs = []
    with torch.no_grad():
        l0, r0 = frames[0]
        depth, valid, sflow = tmodel.flow2depth(t(l0), t(r0), bl)
        state = (t(l0), depth, sflow)
        for l, r in frames[1:]:
            img1, depth1, sflow1 = state
            img2, img2r = t(l), t(r)
            mask = torch.ones(1, 1, h, w, dtype=torch.bool)
            pose, tan, depth2, conf1, conf2, flow, sflow2 = tmodel.infer(
                img1, img2, tK, bl, depth1, img2r, mask, mask, sflow1)
            # rebuild the solver inputs for the f64 objective probe
            b = 1
            flows, net, inp = tmodel.flow(torch.cat([img1, img2], 0),
                                          torch.cat([img2, img2r], 0))
            fl = flows[-1][:b]
            sfl2 = flows[-1][b:]
            d2, valid2 = tmodel.flow2depth_from(sfl2, bl)
            m2 = mask & valid2
            pcl1 = tmodel.proj(depth1, tK)
            pcl2 = tmodel.proj(d2, tK)
            c1, c2, pcl2w, mask2w = tmodel.get_weight_maps(
                pcl1, pcl2, img1, img2, m2, fl, sflow1, sfl2)
            xs = (fl, pcl1, pcl2w, c1, c2, mask, mask2w, tK,
                  tmodel.loss_weight[None])
            xs64 = [x.double() if torch.is_floating_point(x) else x
                    for x in xs]

            def obj(p7, xs64=xs64):
                p = torch.as_tensor(np.asarray(p7),
                                    dtype=torch.float64)[None]
                return float(tmodel.pose_head.objective(xs64, p, h, w))

            ident = np.array([0, 0, 0, 0, 0, 0, 1.0])
            outs.append(dict(pose=pose.numpy()[0], flow=fl.numpy()[0],
                             depth2=depth2.numpy()[0],
                             conf1=conf1.numpy()[0], conf2=conf2.numpy()[0],
                             e_torch=obj(pose.numpy()[0]),
                             e_ident=obj(ident), _obj=obj))
            state = (img2, depth2, sflow2)
    return outs


def run_port(state_dict, frames, K, baseline, config, device):
    """The port's tracking loop (``PoseNet.flow2depth``, then ``infer`` per
    frame) in f32 on ``device``; outputs per frame as the reference lays
    them out ((C, H, W) maps)."""
    from robust_pose_tpu_torch.models.posenet import PoseNet

    h, w = config["image_shape"]
    model = PoseNet(dict(config, mixed_precision=False), device=device)
    model.load_state_dict(state_dict)
    tK = torch.as_tensor(K, device=device)[None]
    bl = torch.tensor([baseline], device=device)
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=device)[None]
    chw = lambda x: x[0].permute(2, 0, 1).cpu().numpy()
    outs = []
    with torch.no_grad():
        l0, r0 = frames[0]
        depth, _, sflow = model.flow2depth(t(l0), t(r0), bl)
        state = (t(l0), depth, sflow)
        for l, r in frames[1:]:
            img1, depth1, sflow1 = state
            img2, img2r = t(l), t(r)
            mask = torch.ones((1, h, w, 1), dtype=torch.bool, device=device)
            o = model.infer(img1, img2, tK, bl, depth1, img2r, mask, mask,
                            sflow1)
            outs.append(dict(pose=o.pose[0].cpu().numpy(), flow=chw(o.flow),
                             depth2=chw(o.depth2), conf1=chw(o.conf1),
                             conf2=chw(o.conf2)))
            state = (img2, o.depth2, o.stereo_flow2)
    return outs


def _poses(x):
    return torch.tensor(np.array(x, np.float32)).reshape(-1, 7)


def chain_ate(outs_a, outs_b):
    """Chain per-frame relative poses into trajectories and compare: RMSE of
    positional deltas, relative to trajectory extent."""
    from robust_pose_tpu_torch import se3

    def chain(outs):
        pose = se3.identity((1,))
        pts = [np.zeros(3)]
        for o in outs:
            pose = se3.normalize(se3.mul(pose, se3.inv(_poses(o["pose"]))))
            pts.append(pose[0, :3].numpy())
        return np.stack(pts)

    ta, tb = chain(outs_a), chain(outs_b)
    rmse = float(np.sqrt(np.mean(np.sum((ta - tb) ** 2, axis=-1))))
    extent = float(np.max(np.linalg.norm(tb - tb[0], axis=-1)) + 1e-9)
    return rmse, rmse / extent


def compare(port_outs, ref_outs, se3mod):
    """-> list of (name, value, tol, ok).

    Pose checks follow the e2e-parity-test protocol: the reference solves
    with lr=1 torch LBFGS and NO line search, which can overshoot -- so
    tangent agreement and chained ATE are only asserted on frames where
    LBFGS actually descended (e_torch < e_ident), and the universally
    valid criterion is SOLVER QUALITY: the f32 LM pose must reach an
    f64-objective value no worse than the LBFGS pose."""
    rows = []
    flow_err = max(float(np.max(np.abs(j["flow"] - r["flow"])))
                   for j, r in zip(port_outs, ref_outs))
    rows.append(("flow max|Δ| px", flow_err, TOL["flow_px"]))
    depth_err = max(float(np.median(
        np.abs(j["depth2"] - r["depth2"]) / (np.abs(r["depth2"]) + 1e-6)))
        for j, r in zip(port_outs, ref_outs))
    rows.append(("depth med rel Δ", depth_err, TOL["depth_rel"]))
    conf_err = max(float(max(np.max(np.abs(j["conf1"] - r["conf1"])),
                             np.max(np.abs(j["conf2"] - r["conf2"]))))
                   for j, r in zip(port_outs, ref_outs))
    rows.append(("confidence max|Δ|", conf_err, TOL["conf_abs"]))

    if "_obj" in ref_outs[0]:
        # live reference network: objective-quality check on every frame
        qual = max((r["_obj"](j["pose"]) - r["e_torch"])
                   / max(abs(r["e_torch"]), 1e-12)
                   for j, r in zip(port_outs, ref_outs))
        rows.append(("GN obj excess over LBFGS (rel)", qual,
                     TOL["obj_excess"]))

    descended = [bool(r["e_torch"] < r["e_ident"]) for r in ref_outs]
    pairs = [(j, r) for (j, r), d in zip(zip(port_outs, ref_outs), descended)
             if d]
    if pairs:
        pose_err = max(float(se3mod.log(se3mod.mul(
            se3mod.inv(_poses(j["pose"])), _poses(r["pose"]))).abs().max())
            for j, r in pairs)
        rows.append((f"pose tangent dist ({len(pairs)}/{len(ref_outs)} "
                     "descended frames)", pose_err, TOL["pose_tan"]))
    if all(descended):
        ate, ate_rel = chain_ate(port_outs, ref_outs)
        rows.append(("chained ATE (rel)", ate_rel, TOL["ate_rel"]))
    else:
        print(f"note: LBFGS descended on {sum(descended)}/{len(descended)} "
              "frames — chained-ATE check skipped (oracle poses are not a "
              "trustworthy trajectory); with trained weights all frames "
              "should descend")
    return [(n, v, t, v <= t) for n, v, t in rows]


def make_selftest_pth(path, config):
    """Write a random-weights checkpoint in the reference's exact on-disk
    format: {'state_dict': DataParallel-prefixed tensors, 'config': {...}};
    the same bits as the JAX harness's."""
    from robust_pose_tpu_torch.reference.posenet import PoseNet as TorchPoseNet

    torch.manual_seed(7)
    tmodel = TorchPoseNet(config)
    with torch.no_grad():
        tmodel.flow.update_block.flow_head.conv2.bias.copy_(
            torch.tensor([-2.5, 0.0]))
        for m in tmodel.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.2)
                m.running_var.uniform_(0.8, 1.5)
    sd = {"module." + k: v for k, v in tmodel.state_dict().items()}
    torch.save({"state_dict": sd, "config": {"model": dict(config)}}, path)


def raft_param_count(state_dict):
    """Parameter tensors of a port RAFT state_dict (BatchNorm statistics
    and counters left out, as flax keeps them apart from its params)."""
    stats = ("running_mean", "running_var", "num_batches_tracked")
    return sum(1 for k in state_dict if not k.endswith(stats))


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--posenet", help="poseNet_2xf8up4b.pth (or compatible)")
    ap.add_argument("--raft", help="raft-things.pth (flow-level check)")
    ap.add_argument("--data", help="dir of left/right PNG pairs")
    ap.add_argument("--record", help="save reference-network outputs to .npz")
    ap.add_argument("--golden", help="compare against a recorded .npz")
    ap.add_argument("--image-shape", type=int, nargs=2, default=(384, 512),
                    help="H W (384x512 = smallest TinyUNet-valid shape)")
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--iters", type=int, default=4,
                    help="RAFT GRU iterations for the check")
    ap.add_argument("--selftest", action="store_true",
                    help="run end-to-end with a synthesized random .pth")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="where the port runs (default cuda; without a card, "
                    "cpu must be named)")
    ap.add_argument("--json", help="also write the rows, unrounded, here")
    return ap


def run(args):
    """The harness on parsed ``args``: returns (rows, all passed). On a
    card it runs with TF32 off and deterministic cuDNN (f32 parity, the
    same convolution algorithms in every process), the caller's settings
    restored after."""
    from robust_pose_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    flags = [(torch.backends.cuda.matmul, "allow_tf32", False),
             (torch.backends.cudnn, "allow_tf32", False),
             (torch.backends.cudnn, "deterministic", True),
             (torch.backends.cudnn, "benchmark", False)]
    saved = [getattr(mod, name) for mod, name, _ in flags]
    try:
        if device.type == "cuda":
            for mod, name, value in flags:
                setattr(mod, name, value)
        return _run(args, device)
    finally:
        for (mod, name, _), value in zip(flags, saved):
            setattr(mod, name, value)


def _run(args, device):
    from robust_pose_tpu_torch import se3
    from robust_pose_tpu_torch.models.raft import RAFT
    from robust_pose_tpu_torch.utils.torch_convert import (
        convert_posenet_pth, convert_raft_pth)

    h, w = args.image_shape
    config = {"image_shape": (h, w), "iters": args.iters, "lbgfs_iters": 25,
              "use_weights": True}
    if args.selftest:
        import tempfile
        args.posenet = os.path.join(tempfile.mkdtemp(), "selftest.pth")
        make_selftest_pth(args.posenet, config)
        print(f"selftest: synthesized {args.posenet}")
    if not args.posenet:
        raise SystemExit("--posenet (with or without --golden) or --selftest "
                         "is required: the port runs on the checkpoint's weights")

    K = np.array([[350.0, 0, w / 2], [0, 350.0, h / 2], [0, 0, 1.0]],
                 np.float32)
    # normalized baseline sized so an untrained/biased flow still yields
    # mid-range depths and a well-conditioned pose problem
    baseline = 20.0
    frames = (load_data_dir(args.data, h, w) if args.data else
              make_synthetic_sequence(h, w, n=args.frames))

    if args.raft:
        rsd = convert_raft_pth(args.raft)
        RAFT(iters=args.iters, dtype=torch.float32,
             corr_dtype=torch.float32).load_state_dict(rsd)
        print(f"raft checkpoint converted: {raft_param_count(rsd)} param "
              "tensors OK")

    converted = convert_posenet_pth(args.posenet)
    port_outs = run_port(converted["state_dict"], frames, K, baseline, config,
                         device)

    if args.golden:
        g = np.load(args.golden, allow_pickle=True)
        ref_outs = list(g["outs"])
    else:
        tmodel = load_torch_oracle(args.posenet, config)
        ref_outs = run_torch_oracle(tmodel, frames, K, baseline, config)
    if args.record:
        recordable = [{k: v for k, v in r.items() if k != "_obj"}
                      for r in ref_outs]
        np.savez_compressed(args.record, outs=np.asarray(recordable,
                                                         dtype=object))
        print(f"recorded reference-network outputs -> {args.record}")

    rows = compare(port_outs, ref_outs, se3)
    width = max(len(r[0]) for r in rows)
    ok_all = True
    for name, val, tol, ok in rows:
        ok_all &= ok
        print(f"{name:{width}s}  {val:12.3e}  (tol {tol:.0e})  "
              f"{'PASS' if ok else 'FAIL'}")
    print("PARITY:", "PASS" if ok_all else "FAIL")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"rows": [[n, v, t, bool(ok)] for n, v, t, ok in rows],
                       "posenet": args.posenet, "device": str(device),
                       "ok": bool(ok_all)}, f)
    return rows, ok_all


def main(argv=None):
    _, ok = run(build_parser().parse_args(argv))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
