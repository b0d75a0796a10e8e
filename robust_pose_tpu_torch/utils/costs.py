"""FLOP and byte counts of eager PyTorch work: the port's counterpart of
XLA's ``compiled.cost_analysis()``.

``count()`` is a context manager over a ``TorchDispatchMode``. For every
aten op that runs inside it, it adds

- FLOPs from ``torch.utils.flop_counter``'s registry (convolution, mm,
  bmm, addmm, baddbmm and their backwards; every other op counts none);
- bytes: the tensor operands read plus the outputs written. An operand
  broadcast with a zero stride counts its distinct elements once. View,
  alias and factory ops, which read nothing, and metadata queries, which
  write no tensor, count none; an op that only
  writes its first operand (``copy_``, ``zero_``, ``fill_``, the random
  fills) counts that operand as written, not read.

Each entry is kept by op name, by dtype (``"tf32"`` for f32 products and
convolutions that PyTorch runs on TF32 tensor cores) and by the innermost
``utils.profiling.span`` open when it ran.

The hand-written kernels count themselves. A wrapper that launches one
(or runs its plain version on CPU tensors) calls :func:`kernel` with its
formula below when a counter is active; on the CPU its plain version runs
with counting suspended. So a path counts the same work on the CPU and on
the card, whatever implements a kernel. The formulas are the work the
kernel's contract needs, which ``chip_smoke.py`` also takes as each
kernel's bound: each input read once, each output written once, and the
operations on this call's inputs (the in-level taps of this call's
windows, the LM builds this call's solve ran).

Byte model, and its limit: each op's operands and outputs are traffic,
so a tensor that stays in the card's 50 MB L2 between two ops is counted
twice. Achieved rates against the device-memory peak can read above
100 %.

Peaks (H100 SXM data sheet, dense): bf16 989e12, TF32 495e12, f32 67e12
(f64 34e12) operations a second; device memory 3.35e12 bytes a second.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from robust_pose_tpu_torch.utils import profiling

Tensor = torch.Tensor

BF16_FLOPS = 989e12           # dense tensor-core bf16 (f16 alike)
TF32_FLOPS = 495e12           # dense tensor-core TF32
F32_FLOPS = 67e12             # f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12     # device memory
F64_FLOPS = 34e12             # f64 outside the tensor cores
PEAKS = {"bf16": BF16_FLOPS, "f16": BF16_FLOPS, "tf32": TF32_FLOPS,
         "f32": F32_FLOPS, "f64": F64_FLOPS}

active: Optional["Counter"] = None   # the counter being filled, or None

_DTYPES = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32",
           torch.float64: "f64"}
# ops that write their first operand without reading it
_WRITE_ONLY = {"copy_", "zero_", "fill_", "normal_", "uniform_", "bernoulli_",
               "random_", "exponential_", "zeros_like", "ones_like",
               "full_like", "rand_like", "randn_like", "new_zeros", "new_ones",
               "new_full"}
# ops that return a tensor sharing its input's storage without a view
# annotation in their schema
_NO_TRAFFIC = {"_unsafe_view", "lift_fresh", "set_", "alias", "detach",
               "_local_scalar_dense", "resize_", "empty_like", "new_empty",
               "new_empty_strided"}
_CONV = {"convolution", "_convolution", "cudnn_convolution",
         "convolution_overrideable", "_slow_conv2d_forward",
         "convolution_backward"}


def dtype_key(dtype: torch.dtype) -> str:
    return _DTYPES.get(dtype, str(dtype).replace("torch.", ""))


def _distinct_bytes(t: Tensor) -> int:
    """Bytes of ``t``'s distinct elements (a zero-stride dimension once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size() if t.numel() else 0


class Counter:
    """FLOPs and bytes by op, by dtype and by span; ``flops`` and
    ``bytes`` are the totals."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.by_op: Dict[str, list] = defaultdict(lambda: [0, 0, 0])
        self.by_dtype: Dict[str, list] = defaultdict(lambda: [0, 0])
        self.by_span: Dict[str, list] = defaultdict(lambda: [0, 0])
        self._suspended = 0

    def add(self, name: str, flops: int, nbytes: int, dtype: str) -> None:
        flops, nbytes = int(flops), int(nbytes)
        self.flops += flops
        self.bytes += nbytes
        op = self.by_op[name]
        op[0] += flops
        op[1] += nbytes
        op[2] += 1
        d = self.by_dtype[dtype]
        d[0] += flops
        d[1] += nbytes
        s = self.by_span[profiling.current_span() or ""]
        s[0] += flops
        s[1] += nbytes

    def compute_s(self) -> float:
        """Seconds the FLOPs take at least: each dtype's over its peak."""
        return sum(f / PEAKS.get(k, F32_FLOPS) for k, (f, _) in self.by_dtype.items())

    def summary(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "by_dtype": {k: {"flops": f, "bytes": b}
                             for k, (f, b) in sorted(self.by_dtype.items())},
                "by_span": {k: {"flops": f, "bytes": b}
                            for k, (f, b) in sorted(self.by_span.items())}}

    def top(self, n: int, key: str = "bytes"):
        """The ``n`` ops with the most ``key`` ("bytes" or "flops"):
        [name, flops, bytes, calls] rows."""
        i = 1 if key == "bytes" else 0
        rows = sorted(self.by_op.items(), key=lambda kv: -kv[1][i])[:n]
        return [[k, f, b, c] for k, (f, b, c) in rows]


class _Mode(TorchDispatchMode):
    def __init__(self, counter: Counter):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        c = self.counter
        packet = func._overloadpacket
        if not c._suspended and packet not in flop_registry:
            # an op with a decomposition (conv2d into convolution) counts
            # as the ops it decomposes into, as FlopCounterMode counts it
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if c._suspended:
            return out
        name = packet.__name__
        flat_in = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, Tensor)]
        flat_out = [t for t in tree_flatten(out)[0] if isinstance(t, Tensor)]
        if func.is_view or name in _NO_TRAFFIC or not flat_in or not flat_out:
            return out
        reads = flat_in[1:] if name in _WRITE_ONLY else flat_in
        nbytes = (sum(_distinct_bytes(t) for t in reads)
                  + sum(_distinct_bytes(t) for t in flat_out))
        flops = 0
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
        fl = [t for t in flat_in if t.is_floating_point()]
        dt = dtype_key(fl[0].dtype) if fl else "int"
        if flops and dt == "f32":
            tf32 = (torch.backends.cudnn.allow_tf32 if name in _CONV
                    else torch.backends.cuda.matmul.allow_tf32)
            dt = "tf32" if tf32 else dt
        c.add(name, flops, nbytes, dt)
        return out


@contextlib.contextmanager
def count():
    """Count the FLOPs and bytes of the enclosed PyTorch work; yields the
    :class:`Counter`."""
    global active
    counter, outer = Counter(), active
    active = counter
    try:
        with _Mode(counter):
            yield counter
    finally:
        active = outer


class suspended:
    """Pause the active counter (if any) for the enclosed ops: a kernel
    wrapper's plain version and its formula's own arithmetic."""

    def __enter__(self):
        self.c = active
        if self.c is not None:
            self.c._suspended += 1

    def __exit__(self, *exc):
        if self.c is not None:
            self.c._suspended -= 1


def kernel(name: str, formula, *args) -> None:
    """Add a hand-written kernel's work to the active counter: ``formula(
    *args)`` gives (flops, bytes, dtype key), evaluated with counting
    suspended. Wrappers call it only under ``if costs.active``."""
    c = active
    if c is None:
        return
    with suspended():
        flops, nbytes, dt = formula(*args)
    c.add(name, flops, nbytes, dt)


def bound(nbytes: float, flops_by_dtype: Dict[str, float]):
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    device-memory rate and the operations over their dtypes' peaks."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = sum(f / PEAKS[k] for k, f in flops_by_dtype.items())
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


# ---------------------------------------------------------------------------
# the hand kernels' formulas: (flops, bytes, dtype key of the operations)
# ---------------------------------------------------------------------------

def window_taps(level_shapes, coords: Tensor, radius: int = 4) -> int:
    """In-level taps of the (2r+2)^2 (100 at radius 4, 64 at 3) each window
    touches, summed over queries and levels ((Hl, Wl) each; ``coords``
    (..., 2) in level-0 pixels): what this call's data needs read."""
    n = 0
    for lvl, (hl, wl) in enumerate(level_shapes):
        x0 = torch.floor(coords[..., 0] / 2 ** lvl) - radius
        y0 = torch.floor(coords[..., 1] / 2 ** lvl) - radius
        dd = torch.arange(2 * radius + 2, device=coords.device)
        ny = ((y0[..., None] + dd >= 0) & (y0[..., None] + dd < hl)).sum(-1)
        nx = ((x0[..., None] + dd >= 0) & (x0[..., None] + dd < wl)).sum(-1)
        n += int((ny * nx).sum())
    return n


def corr_window(f1: Tensor, levels, coords: Tensor, radius: int = 4,
                level_scale: float = 1.0):
    """K1 (``ops/corr_onthefly``): f1 (B, N, C), the levels and the centres
    read once, the (B, L*D*D, N) f32 outputs written once; one C-long
    multiply-add (2 operations) a channel per in-level window tap, at the
    inputs' type. Level l is read at ``coords / (level_scale 2^l)``."""
    b, n, c = f1.shape[0], f1.shape[1], f1.shape[-1]
    esz = f1.element_size()
    nbytes = (f1.numel() * esz + sum(v.numel() * esz for v in levels)
              + coords.numel() * 4 + len(levels) * b * (2 * radius + 1) ** 2 * n * 4)
    ops = window_taps([v.shape[1:3] for v in levels],
                      coords.reshape(b, n, 2) / level_scale, radius) * c * 2
    return ops, nbytes, dtype_key(f1.dtype)


def instance_norm_stats(x: Tensor):
    """K2 (``ops/instance_norm``): x (B, H, W, C) read once, sum and sum of
    squares (B, C) f32 written; an add and a multiply-add per element."""
    b, c = x.shape[0], x.shape[-1]
    return 3 * x.numel(), x.numel() * x.element_size() + 2 * b * c * 4, "f32"


def instance_norm(x: Tensor, x_reads: int = 2):
    """The norm (``ops/instance_norm.instance_norm``, one
    ``instance_norm_fwd`` call): x (B, H, W, C) read ``x_reads`` times (2:
    the statistics pass and the apply pass, as the kernel moves it; 1: the
    floor that ``chip_smoke.py`` takes as the bound), y like x written, mu
    and rstd (B, C) f32 written; 5 operations an element (the statistics'
    3, a subtract and a multiply)."""
    b, c = x.shape[0], x.shape[-1]
    nbytes = (x_reads + 1) * x.numel() * x.element_size() + 2 * b * c * 4
    return 5 * x.numel(), nbytes, "f32"


K3_PLANES = 10          # the planes a build's math reads (pcl1, pcl2, flow, 2 weights)
K3_OPS_PER_PIXEL = 260  # f32 operations a pixel (see csrc/normal_eq.cu)


def normal_equations(b: int, h: int, w: int):
    """K3, one H/g/cost build (``ops/normal_eq.normal_equations``): the 10
    planes and pose/K/loss weights read once, H, g, cost written once."""
    nbytes = b * K3_PLANES * h * w * 4 + b * (7 + 4 + 2) * 4 + b * 43 * 4
    return b * h * w * K3_OPS_PER_PIXEL, nbytes, "f32"


def lm_solve(niter: Tensor, h: int, w: int):
    """K3's LM solve (``ops/normal_eq.lm_solve``): the builds this solve
    ran (the first, then one an iteration of each sample until it is done,
    from the realized counts ``niter``), each reading the planes once."""
    builds = int((1 + niter.long()).sum())
    return (builds * h * w * K3_OPS_PER_PIXEL, builds * K3_PLANES * h * w * 4,
            "f32")


def lanewise_fwd(vols, coords: Tensor, radius: int = 4,
                 level_scale: float = 1.0):
    """K4 (``ops/corr_lanewise``): the in-level taps (the volume's type),
    the centres, the (B, L*D*D, N) f32 outputs; 3 operations per tap-row
    entry and 3 per output (f32)."""
    b, _, _, n = vols[0].shape
    d = 2 * radius + 1
    taps = window_taps([v.shape[1:3] for v in vols], coords / level_scale,
                       radius)
    nbytes = (taps * vols[0].element_size() + coords.numel() * 4
              + len(vols) * b * d * d * n * 4)
    return len(vols) * b * n * (d * (d + 1) * 3 + d * d * 3), nbytes, "f32"


def lanewise_bwd(vols, coords: Tensor, radius: int = 4,
                 level_scale: float = 1.0):
    """K5: the dense dcorr write (the volumes' type), the taps, the
    centres, the output cotangents and the centre cotangents (f32)."""
    b, _, _, n = vols[0].shape
    d = 2 * radius + 1
    taps = window_taps([v.shape[1:3] for v in vols], coords / level_scale,
                       radius)
    vol_bytes = sum(v.numel() * v.element_size() for v in vols)
    nbytes = (vol_bytes + taps * vols[0].element_size() + coords.numel() * 4
              + len(vols) * b * d * d * n * 4 + len(vols) * b * n * 2 * 4)
    return len(vols) * b * n * ((d + 1) ** 2 * 3 + d * (d + 1) * 8), nbytes, "f32"


def pixel_lookup(vols, coords: Tensor):
    """K6 / K7 (``ops/corr_pixel``), radius 4: the in-level taps (the
    volume's type), the centres, the (B or M, L*81, N) f32 outputs; 3
    operations per tap-row entry and 3 per output (f32). ``vols``: the
    levels as (M, Hl, Wl) views; ``coords`` (M, 2) in level-0 pixels."""
    m = coords.shape[0]
    taps = window_taps([v.shape[-2:] for v in vols], coords)
    nbytes = (taps * vols[0].element_size() + coords.numel() * 4
              + len(vols) * m * 81 * 4)
    return len(vols) * m * (9 * 10 * 3 + 81 * 3), nbytes, "f32"
