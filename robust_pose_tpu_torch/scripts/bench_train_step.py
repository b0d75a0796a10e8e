"""Training-step benchmark at the production shape on one CUDA card (port
of ``scripts/bench_train_step.py``).

Times the training step (forward, the implicit-function backward through
the LM solve, the AdamW update) at batch 8, 512x640, 12 RAFT iterations
(``configuration/train.yaml``'s shape) and reports the peak device memory
of the caching allocator for both remat settings. The variant without
remat is run; a ``torch.OutOfMemoryError`` there is its measurement ("does
not fit"), any other error propagates::

    python -m robust_pose_tpu_torch.scripts.bench_train_step [--batch 8] \\
        [--steps 4] [--accum 1] [--skip_noremat] [--remat_policy nothing] \\
        [--live-flow-grads]

``main`` returns what it printed, by variant.
"""
import argparse
import gc
import time

import torch

H, W = 512, 640


def build(batch, remat, accum=1, remat_policy="nothing", stop_flow_grad=True,
          device=None):
    """A trainer at (H, W) with random weights (seed 0) and its state."""
    from robust_pose_tpu_torch.train.trainer import PoseNetTrainer

    config = {
        "model": {"iters": 12, "lbgfs_iters": 20, "use_weights": True,
                  "pose_scale": 1.0, "dropout": 0.0, "small": False,
                  "remat": remat, "remat_policy": remat_policy},
        "image_shape": [H, W],
        "depth_scale": 250,
        "train": {"batch_size": batch, "learning_rate": 1e-5,
                  "weight_decay": 5e-5, "epsilon": 1e-8, "grad_clip": 1.0,
                  "grad_accum": accum, "stop_flow_grad": stop_flow_grad},
        "val": {"batch_size": batch},
    }
    trainer = PoseNetTrainer(config, device=device)
    return trainer, trainer.init_state(seed=0)


def make_batch(batch, key=1, device=None):
    """A random NCHW training batch made on ``device`` from a generator
    there, seeded with ``key``."""
    device = torch.device("cuda" if device is None else device)
    g = torch.Generator(device=device).manual_seed(key)
    imgs = [255.0 * torch.rand((batch, 3, H, W), generator=g, device=device)
            for _ in range(4)]
    mask = torch.ones((batch, 1, H, W), dtype=torch.bool, device=device)
    gt = torch.zeros((batch, 7), device=device)
    gt[:, 6] = 1.0
    gt[:, 0] = 0.01
    K = torch.tensor([[500.0, 0, W / 2], [0, 500.0, H / 2], [0, 0, 1.0]],
                     device=device).expand(batch, 3, 3).contiguous()
    bl = torch.full((batch,), 16.0, device=device)
    return (*imgs, mask, mask, gt, K, bl)


def gib(x):
    return x / (1 << 30)


def timed_steps(trainer, state, batch, steps):
    """One warm-up step, then ``steps`` timed steps on two alternating
    batches (host clock, ending in a metric read back). Returns (ms a
    step, peak GiB of the whole variant)."""
    torch.cuda.reset_peak_memory_stats()
    batches = [make_batch(batch, k) for k in (2, 3)]
    state, metrics = trainer.train_step(state, batches[0])
    float(metrics["train/loss_total"])
    t0 = time.perf_counter()
    for i in range(steps):
        state, metrics = trainer.train_step(state, batches[i % 2])
    float(metrics["train/loss_total"])
    dt = (time.perf_counter() - t0) / steps
    return 1000.0 * dt, gib(torch.cuda.max_memory_allocated())


def _free():
    gc.collect()
    torch.cuda.empty_cache()


def main(argv=None):
    from robust_pose_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--accum", type=int, default=1,
                    help="train.grad_accum microbatches")
    ap.add_argument("--skip_noremat", action="store_true")
    ap.add_argument("--remat_policy", default="nothing",
                    choices=["nothing", "dots"],
                    help="what remat may keep instead of recomputing")
    ap.add_argument("--live-flow-grads", action="store_true",
                    help="disable the frozen-RAFT stop_flow_grad cut "
                         "(measures the finite-freeze_flow_steps path: a "
                         "full RAFT backward whose grads the mask zeroes)")
    args = ap.parse_args(argv)
    resolve_device(None)
    card = torch.cuda.get_device_properties(0)
    out = {"device": card.name, "total_gib": gib(card.total_memory)}
    stop = not args.live_flow_grads

    if not args.skip_noremat:
        trainer, state = build(args.batch, remat=False, stop_flow_grad=stop)
        refused = None
        try:
            ms, peak = timed_steps(trainer, state, args.batch, args.steps)
        except torch.OutOfMemoryError as e:
            refused = str(e).splitlines()[0]
        del trainer, state
        if refused is None:
            out["noremat"] = {"fits": True, "ms": ms, "peak_gib": peak}
            print(f"train step batch {args.batch} @ {H}x{W} (no remat): "
                  f"{ms:.0f} ms/step = {args.batch / ms * 1000:.2f} samples/s, "
                  f"peak {peak:.2f} GiB", flush=True)
        else:
            peak = gib(torch.cuda.max_memory_allocated())
            out["noremat"] = {"fits": False, "peak_gib": peak,
                              "error": refused}
            print(f"no-remat batch {args.batch}: DOES NOT FIT — "
                  f"torch.OutOfMemoryError at {peak:.2f} GiB allocated of "
                  f"{out['total_gib']:.2f} GiB: {refused}", flush=True)
        _free()

    trainer, state = build(args.batch, remat=True, accum=args.accum,
                           remat_policy=args.remat_policy, stop_flow_grad=stop)
    ms, peak = timed_steps(trainer, state, args.batch, args.steps)
    out["remat"] = {"fits": True, "ms": ms, "peak_gib": peak,
                    "accum": args.accum, "remat_policy": args.remat_policy}
    print(f"train step batch {args.batch} accum {args.accum} @ {H}x{W} "
          f"(remat): {ms:.0f} ms/step = {args.batch / ms * 1000:.2f} "
          f"samples/s, peak {peak:.2f} GiB", flush=True)
    del trainer, state
    _free()
    return out


if __name__ == "__main__":
    main()
