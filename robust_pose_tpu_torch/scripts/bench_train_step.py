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

Data-parallel, ``torchrun --nproc_per_node N -m
robust_pose_tpu_torch.scripts.bench_train_step``: ``--batch`` is the
global batch, each rank steps on its rows (``parallel.mesh.shard_batch``,
as the JAX script shards over its mesh) and prints its own ms a step and
peak GiB, and the ms of the step's ``train_step.allreduce`` span (the
gradient all-reduce) in one more step under torch.profiler. ``main``
returns what it printed, by variant.
"""
import argparse
import gc
import time

import torch

H, W = 512, 640


def build(batch, remat, accum=1, remat_policy="nothing", stop_flow_grad=True,
          device=None, mesh=None):
    """A trainer at (H, W) with random weights (seed 0) and its state;
    ``batch`` is the global batch under ``mesh``."""
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
    trainer = PoseNetTrainer(config, device=device, mesh=mesh)
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


def _peak_gib(device):
    """Peak allocated GiB since the last reset on a card; None on the
    CPU."""
    if device.type != "cuda":
        return None
    return gib(torch.cuda.max_memory_allocated(device))


def timed_steps(trainer, state, batch, steps, span=False):
    """One warm-up step, then ``steps`` timed steps on two alternating
    global batches, this rank's rows of each (host clock, ending in a
    metric read back); with ``span`` one more step profiled
    (``allreduce_span``). Returns (ms a step, peak GiB of the whole variant
    on a card, else None, the span's ms or None)."""
    from robust_pose_tpu_torch.parallel.mesh import Mesh, shard_batch

    dev = trainer.device
    mesh = trainer.mesh or Mesh(1, 0, dev)
    accum = int(trainer.config["train"].get("grad_accum", 1))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    batches = [shard_batch(mesh, make_batch(batch, k, dev), accum)
               for k in (2, 3)]
    state, metrics = trainer.train_step(state, batches[0])
    float(metrics["train/loss_total"])
    t0 = time.perf_counter()
    for i in range(steps):
        state, metrics = trainer.train_step(state, batches[i % 2])
    float(metrics["train/loss_total"])
    dt = (time.perf_counter() - t0) / steps
    peak = _peak_gib(dev)
    return (1000.0 * dt, peak,
            allreduce_span(trainer, state, batches[0]) if span else None)


def allreduce_span(trainer, state, batch):
    """The ``train_step.allreduce`` span of one step under torch.profiler:
    ``host_ms`` (under gloo the collective itself, staged through the
    host; under NCCL its enqueue) and, on a card, ``device_ms`` (the span's
    window on the device timeline). None without a process group."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if trainer.mesh is None:
        return None
    acts = [ProfilerActivity.CPU]
    if trainer.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(trainer.device)
    with profile(activities=acts) as prof:
        trainer.train_step(state, batch)
        _sync(trainer.device)
    ms = {}
    for e in prof.events():
        if e.name == "train_step.allreduce":
            side = "device_ms" if e.device_type == DeviceType.CUDA else "host_ms"
            ms[side] = ms.get(side, 0.0) + e.time_range.elapsed_us() / 1e3
    return {"host_ms": ms.get("host_ms"), "device_ms": ms.get("device_ms")}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def main(argv=None, mesh=None):
    """Parse ``argv`` and run; ``mesh``: this rank's
    ``parallel.mesh.Mesh`` (default ``make_mesh()``: torchrun's world, else
    a world of 1 on the card)."""
    from robust_pose_tpu_torch.parallel.mesh import make_mesh

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
    own = mesh is None
    mesh = make_mesh() if own else mesh
    try:
        return _bench(args, mesh)
    finally:
        if own:
            mesh.close()


def _bench(args, mesh):
    dev = mesh.device
    if dev.type == "cuda":
        card = torch.cuda.get_device_properties(dev)
        out = {"device": card.name, "total_gib": gib(card.total_memory)}
    else:
        out = {"device": str(dev), "total_gib": None}
    out.update(rank=mesh.rank, world_size=mesh.world_size)
    stop = not args.live_flow_grads
    who = f"rank {mesh.rank}/{mesh.world_size}: "
    fmt = lambda x, digits=2: "n/a" if x is None else f"{x:.{digits}f}"

    if not args.skip_noremat:
        trainer, state = build(args.batch, remat=False, stop_flow_grad=stop,
                               mesh=mesh)
        refused = None
        try:
            ms, peak, _ = timed_steps(trainer, state, args.batch, args.steps)
        except torch.OutOfMemoryError as e:
            refused = str(e).splitlines()[0]
        del trainer, state
        if refused is None:
            out["noremat"] = {"fits": True, "ms": ms, "peak_gib": peak}
            print(f"{who}train step batch {args.batch} @ {H}x{W} (no remat): "
                  f"{ms:.0f} ms/step = {args.batch / ms * 1000:.2f} samples/s, "
                  f"peak {fmt(peak)} GiB", flush=True)
        else:
            peak = _peak_gib(dev)
            out["noremat"] = {"fits": False, "peak_gib": peak,
                              "error": refused}
            print(f"{who}no-remat batch {args.batch}: DOES NOT FIT — "
                  f"torch.OutOfMemoryError at {fmt(peak)} GiB allocated of "
                  f"{out['total_gib']:.2f} GiB: {refused}", flush=True)
        _free()

    trainer, state = build(args.batch, remat=True, accum=args.accum,
                           remat_policy=args.remat_policy, stop_flow_grad=stop,
                           mesh=mesh)
    ms, peak, span = timed_steps(trainer, state, args.batch, args.steps,
                                 span=True)
    out["remat"] = {"fits": True, "ms": ms, "peak_gib": peak,
                    "accum": args.accum, "remat_policy": args.remat_policy,
                    "allreduce_span": span}
    print(f"{who}train step batch {args.batch} accum {args.accum} @ {H}x{W} "
          f"(remat): {ms:.0f} ms/step = {args.batch / ms * 1000:.2f} "
          f"samples/s, peak {fmt(peak)} GiB"
          + ("" if span is None else
             ", train_step.allreduce span {} ms host, {} ms device".format(
                 *(fmt(span[k], 3) for k in ("host_ms", "device_ms")))),
          flush=True)
    del trainer, state
    _free()
    return out


if __name__ == "__main__":
    main()
