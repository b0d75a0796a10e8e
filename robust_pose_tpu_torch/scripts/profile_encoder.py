"""Where the BasicEncoder's milliseconds go on one CUDA card (port of
``scripts/profile_encoder.py``): RAFT's feature encoder (fnet: 256
channels, 15 instance norms, bf16) at 512x640, split three ways:

  * the norm variants: the norms' statistics through K2 (the Triton
    kernel, ``ops/instance_norm``) against its plain PyTorch version, in
    the same process on the same inputs;
  * batch scaling at B = 1, 2, 8 and 16 (an f2m step encodes 1 image, an
    f2f window of 8 frames 16);
  * a conv-only ablation (``norm="none"``: the same convolutions, no
    norms).

Each row has the card's time of one encoder call three ways: ``device_ms``
(torch.profiler, the summed duration of the kernels it launches, with
``launches``), ``ms`` (CUDA events around back-to-back calls: the larger
of the host's and the card's share) and ``host_us`` (the host's share,
no synchronisation). Where ``ms`` is near ``host_us / 1000`` and above
``device_ms`` the host sets the pace.

    python -m robust_pose_tpu_torch.scripts.profile_encoder [--iters 8] \\
        [--batches 1 2 8 16]

It needs a card; without one (or with ``--device cpu``) it raises.
"""
import argparse
import contextlib
import json
import time

import torch

from robust_pose_tpu_torch.utils import profiling

H, W = 512, 640
VARIANTS = ("instance_k2", "instance_plain", "none")


@contextlib.contextmanager
def plain_stats():
    """The instance norms' statistics through the plain version (on the
    card too) instead of K2."""
    from robust_pose_tpu_torch.ops import instance_norm as K2

    kernel = K2.instance_norm_stats
    K2.instance_norm_stats = K2.instance_norm_stats_plain
    try:
        yield
    finally:
        K2.instance_norm_stats = kernel


def encoder(norm, device):
    """fnet as RAFT builds it (bf16 convolutions), seeded random weights."""
    from robust_pose_tpu_torch.models.raft import BasicEncoder

    torch.manual_seed(0)
    return BasicEncoder(output_dim=256, norm=norm,
                        dtype=torch.bfloat16).to(device).eval()


def images(b, device, seed):
    """RAFT's prepared input: (B, 3, H, W) in [-1, 1], channels_last."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = 2.0 * torch.rand((b, 3, H, W), generator=g, device=device) - 1.0
    return x.contiguous(memory_format=torch.channels_last)


def time_call(fn, reps):
    """(ms, host_us) of one fn(): CUDA events around ``reps`` calls, and
    the host clock around ``reps`` calls without synchronisation."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host


def measure(variant, b, device, reps):
    """One row: ``variant`` (VARIANTS) at batch ``b``."""
    enc = encoder("none" if variant == "none" else "instance", device)
    x = images(b, device, seed=b)
    ctx = plain_stats() if variant == "instance_plain" else contextlib.nullcontext()
    with ctx, torch.no_grad():
        fn = lambda: enc(x)
        ev = profiling.device_events(fn, reps)
        ms, host_us = time_call(fn, reps)
    dev_ms = sum(e.time_range.elapsed_us() for e in ev) / reps / 1e3
    k2 = sum(e.time_range.elapsed_us() for e in ev
             if profiling.kernel_group(e.name).endswith("(K2)")) / reps / 1e3
    return {"variant": variant, "batch": b, "device_ms": dev_ms,
            "launches": len(ev) / reps, "k2_device_ms": k2, "ms": ms,
            "host_us": host_us, "device_ms_per_image": dev_ms / b}


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=8, help="calls a measurement")
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 2, 8, 16])
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="default cuda; the profile needs a card")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = profiling.card_device("profile_encoder", args.device)
    rows = []
    for variant in VARIANTS:
        for b in args.batches:
            rows.append(measure(variant, b, device, args.iters))
            r = rows[-1]
            print(f"fnet {variant:15s} (batch {b:2d}) {r['device_ms']:9.4f} "
                  f"device ms, {r['ms']:9.4f} ms, {r['host_us']:9.1f} host us",
                  flush=True)
            torch.cuda.empty_cache()
    out = {"encoder": "fnet", "shape": [H, W], **profiling.card(device),
           "rows": rows}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
