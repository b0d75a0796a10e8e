"""RAFT optical flow, the large and the small variant (port of
``robust_pose_tpu/models/raft.py``).

Module and parameter names follow the JAX package's flax tree so that
``utils.convert.params_from_jax`` maps one onto the other by path. Public
methods take and return NHWC tensors; inside, activations are NCHW in
``channels_last`` memory, so the NHWC view a norm or a lookup needs is a
free ``permute``.

Correlation lookup (``lookup``), as in the JAX package:

* ``"auto"``: ``"onthefly"`` for features on a CUDA device, ``"xla"`` for
  features on the CPU, decided at each call (the JAX package takes
  ``"xla"`` on its CPU backend and ``"onthefly"`` on an accelerator);
* ``"onthefly"``: the on-the-fly window lookup (``ops.corr_onthefly``,
  kernel K1, one launch a 4-level lookup through
  ``onthefly_lookup_pyramid``, one ``autograd.Function`` over the pyramid)
  over f2 features mean-pooled in f32 and cast to the correlation dtype;
* ``"lanewise"``: the transposed all-pairs volume and the lane-wise lookup
  (``ops.corr_lanewise``, kernels K4 forward and K5 backward);
* ``"xla"``: the all-pairs volume and the one-hot product lookup
  (``build_corr_pyramid`` + ``lookup_corr``), plain PyTorch, as the JAX
  package leaves it to XLA;
* ``"grouped"``: the all-pairs volume of ``"xla"`` and the per-query
  lookup (``ops.corr_pixel``, kernel K7), forward only: like the JAX
  package's Pallas lookup it has no gradient, and asked for one it raises
  (train RAFT through ``"lanewise"``; with ``train.stop_flow_grad`` RAFT runs
  without autograd and ``"grouped"`` serves).

The small variant (``small=True``, upstream RAFT's ``--small``): encoders
of 32/64/96 channels (fnet 128 out with instance norm, cnet 96 + 64 with
no norm), the 3x3 ``ConvGRU`` with a hidden state of 96, a radius-3
window (7 x 7) through ``"onthefly"``, ``"lanewise"`` and ``"xla"``, no
convex-upsampling mask head: the 1/8 flow is upsampled bilinearly
(half-pixel centres, as ``jax.image.resize``). Like the JAX package's
Pallas lookup, ``"grouped"`` takes no radius and reads radius-4 windows
in the small variant too, so its ``convc1`` then takes 4 x 81 channels.

``remat`` recomputes each encoder and each GRU iteration in the backward
pass (``torch.utils.checkpoint``), as the JAX package's ``nn.remat`` does;
``remat_policy`` says what it keeps: ``"nothing"`` (everything is
recomputed) or ``"dots"`` (the outputs of convolutions and matrix products
are kept, the rest recomputed: ``jax.checkpoint_policies.dots_saveable``).
RAFT's BatchNorms run on running statistics in training too, and the GRU
coordinates are not detached between iterations (the JAX ``_UpdateStep``
has no ``stop_gradient``).

``dropout`` (training only) zeroes whole channels of each encoder's output,
one keep draw per (sample, channel), and scales the kept ones by
``1 / (1 - p)``, as flax's ``Dropout(broadcast_dims=(1, 2))``. The mask is
drawn from the generator the caller passes, before the encoder runs and
outside any recomputed region: ``torch.utils.checkpoint`` restores only
the default generators, so a mask drawn inside would differ in the
backward pass. A data-parallel rank draws the global batch's masks and
keeps its rows (``encode_fnet``'s ``rows``).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from robust_pose_tpu_torch.models.layers import BatchNorm, Conv2d, cached_cast
from robust_pose_tpu_torch.ops.corr_lanewise import (
    build_corr_pyramid_t,
    lanewise_lookup,
)
from robust_pose_tpu_torch.ops.corr_onthefly import (
    onthefly_lookup_pyramid,
    pool_fmap_pyramid,
)
from robust_pose_tpu_torch.ops.corr_pixel import grouped_lookup_pyramid
from robust_pose_tpu_torch.ops.instance_norm import instance_norm

Tensor = torch.Tensor

CORR_LEVELS = 4
CORR_RADIUS = 4
HDIM = 128
CDIM = 128
SMALL_RADIUS = 3
SMALL_HDIM = 96
SMALL_CDIM = 64
LOOKUPS = ("onthefly", "lanewise", "grouped", "xla")
REMAT_POLICIES = ("nothing", "dots")
# what remat_policy "dots" keeps: the outputs of convolutions and matrix
# products (jax.checkpoint_policies.dots_saveable)
_DOTS = frozenset((torch.ops.aten.convolution.default, torch.ops.aten.mm.default,
                   torch.ops.aten.bmm.default, torch.ops.aten.addmm.default))


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def dropout_keep(batch: int, channels: int, p: float,
                 generator: torch.Generator) -> Tensor:
    """Channel dropout's keep mask, bool (B, C, 1, 1) on the generator's
    device: one draw per (sample, channel), kept with probability 1 - p
    (flax's ``bernoulli(rng, 1 - p)``)."""
    u = torch.rand((batch, channels, 1, 1), generator=generator,
                   device=generator.device)
    return u < 1.0 - p


def nchw(x: Tensor) -> Tensor:
    """NHWC tensor -> NCHW view (channels_last memory when x is contiguous)."""
    return x.permute(0, 3, 1, 2)


def nhwc(x: Tensor) -> Tensor:
    return x.permute(0, 2, 3, 1)


def instance_norm_nchw(x: Tensor, relu: bool = False) -> Tensor:
    """``instance_norm`` (then a ReLU where ``relu``: one kernel call on the
    card) on an NCHW tensor through its NHWC view; the kernel takes
    contiguous NHWC, i.e. a channels_last NCHW tensor."""
    xh = nhwc(x)
    if not xh.is_contiguous():
        xh = xh.contiguous()
    return nchw(instance_norm(xh, relu=relu))


class ResidualBlock(nn.Module):
    def __init__(self, cin, planes, norm="instance", stride=1,
                 dtype=torch.float32):
        super().__init__()
        self.norm = norm
        self.conv1 = Conv2d(cin, planes, 3, stride, 1, dtype)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, dtype)
        self.has_down = stride != 1 or cin != planes
        if self.has_down:
            self.downsample = Conv2d(cin, planes, 1, stride, 0, dtype)
        if norm == "batch":
            self.norm1 = BatchNorm(planes)
            self.norm2 = BatchNorm(planes)
            if self.has_down:
                self.norm3 = BatchNorm(planes)

    def _norm(self, name, x, relu=False):
        """The block's norm ``name``, then a ReLU where ``relu`` (fused into
        the instance norm)."""
        if self.norm == "instance":
            return instance_norm_nchw(x, relu)
        if self.norm == "batch":
            x = getattr(self, name)(x)
        return F.relu(x) if relu else x

    def forward(self, x):
        y = self._norm("norm1", self.conv1(x), relu=True)
        y = self._norm("norm2", self.conv2(y), relu=True)
        if self.has_down:
            x = self._norm("norm3", self.downsample(x))
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """Feature/context encoder at 1/8 resolution; NCHW in and out. ``norm``
    is "instance", "batch" or "none"."""

    WIDTHS = (64, 64, 96, 128)   # the stem, then the three residual stages

    def __init__(self, output_dim=256, norm="instance", dtype=torch.float32,
                 dropout=0.0):
        super().__init__()
        if norm not in ("instance", "batch", "none"):
            raise ValueError(f"encoder norm {norm!r}")
        self.norm = norm
        self.dropout = dropout
        stem, *stages = self.WIDTHS
        self.conv1 = Conv2d(3, stem, 7, 2, 3, dtype)
        if norm == "batch":
            self.norm1 = BatchNorm(stem)
        cin = stem
        for i, (planes, stride) in enumerate(zip(stages, (1, 2, 2))):
            setattr(self, f"layer{i + 1}_0",
                    ResidualBlock(cin, planes, norm, stride, dtype))
            setattr(self, f"layer{i + 1}_1",
                    ResidualBlock(planes, planes, norm, 1, dtype))
            cin = planes
        self.conv2 = Conv2d(cin, output_dim, 1, 1, 0, dtype)

    def forward(self, x, keep=None):
        """``keep``: the output's (B, C, 1, 1) dropout mask
        (``dropout_keep``); kept channels are scaled by 1 / (1 - dropout),
        the others zeroed. None: no dropout."""
        x = self.conv1(x)
        if self.norm == "instance":
            x = instance_norm_nchw(x, relu=True)
        else:
            x = F.relu(self.norm1(x) if self.norm == "batch" else x)
        for i in range(3):
            x = getattr(self, f"layer{i + 1}_0")(x)
            x = getattr(self, f"layer{i + 1}_1")(x)
        x = self.conv2(x)
        if keep is None:
            return x
        return torch.where(keep, x / (1.0 - self.dropout), 0.0)


class SmallEncoder(BasicEncoder):
    """The small variant's encoder: 32/64/96 channels."""

    WIDTHS = (32, 32, 64, 96)


class SplitConv1x1(nn.Module):
    """1x1 conv over the channel concatenation of the per-level lookup
    outputs ``(B, C_l, N)``, without materializing the concatenation: the
    kernel is sliced per part and the partial products are summed.
    Returns NCHW (channels_last memory)."""

    def __init__(self, cin, cout, dtype=torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, 1, 1))
        self.bias = nn.Parameter(torch.zeros(cout))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, parts, hw):
        dt = self.compute_dtype
        w, b = cached_cast(self, (self.weight, self.bias), dt)
        k = w[:, :, 0, 0].t()                                # (Cin, Cout)
        out = None
        off = 0
        for part in parts:
            ci = part.shape[1]
            y = part.to(dt).transpose(1, 2) @ k[off:off + ci]   # (B, N, Cout)
            out = y if out is None else out + y
            off += ci
        if off != k.shape[0]:
            raise ValueError(f"SplitConv1x1: {off} input channels, "
                             f"expected {k.shape[0]}")
        out = out + b
        return nchw(out.reshape(out.shape[0], hw[0], hw[1], -1))


class BasicMotionEncoder(nn.Module):
    def __init__(self, dtype=torch.float32, radius=CORR_RADIUS):
        super().__init__()
        cor_planes = CORR_LEVELS * (2 * radius + 1) ** 2
        self.convc1 = SplitConv1x1(cor_planes, 256, dtype)
        self.convc2 = Conv2d(256, 192, 3, 1, 1, dtype)
        self.convf1 = Conv2d(2, 128, 7, 1, 3, dtype)
        self.convf2 = Conv2d(128, 64, 3, 1, 1, dtype)
        self.conv = Conv2d(192 + 64, 128 - 2, 3, 1, 1, dtype)

    def forward(self, flow, corr):
        """flow (B, 2, H, W) NCHW; corr: list of (B, 81, N)."""
        c = F.relu(self.convc1(corr, flow.shape[2:]))
        c = F.relu(self.convc2(c))
        f = F.relu(self.convf1(flow))
        f = F.relu(self.convf2(f))
        out = F.relu(self.conv(torch.cat([c, f], dim=1)))
        return torch.cat([out, flow.to(out.dtype)], dim=1)


class SmallMotionEncoder(nn.Module):
    """The small update block's motion encoder: corr 1x1 -> 96, flow 7x7 ->
    64 -> 32, joint 3x3 -> 80, the flow appended: 82 channels."""

    def __init__(self, dtype=torch.float32, radius=SMALL_RADIUS):
        super().__init__()
        cor_planes = CORR_LEVELS * (2 * radius + 1) ** 2
        self.convc1 = SplitConv1x1(cor_planes, 96, dtype)
        self.convf1 = Conv2d(2, 64, 7, 1, 3, dtype)
        self.convf2 = Conv2d(64, 32, 3, 1, 1, dtype)
        self.conv = Conv2d(96 + 32, 80, 3, 1, 1, dtype)

    def forward(self, flow, corr):
        """flow (B, 2, H, W) NCHW; corr: list of (B, (2r+1)^2, N)."""
        c = F.relu(self.convc1(corr, flow.shape[2:]))
        f = F.relu(self.convf1(flow))
        f = F.relu(self.convf2(f))
        out = F.relu(self.conv(torch.cat([c, f], dim=1)))
        return torch.cat([out, flow.to(out.dtype)], dim=1)


def fused_gates(owner: nn.Module, hx: Tensor, name: str):
    """sigmoid of the z and r gates of ``owner``'s ``convz<name>`` and
    ``convr<name>``, run as one convolution over ``hx`` with the kernels
    concatenated along the output channels."""
    cz, cr = getattr(owner, "convz" + name), getattr(owner, "convr" + name)
    w, b = cached_cast(
        owner, (cz.weight, cr.weight, cz.bias, cr.bias), owner.compute_dtype,
        make=lambda wz, wr, bz, br: (torch.cat([wz, wr]), torch.cat([bz, br])),
        slot="_zr" + name)
    out = torch.sigmoid(F.conv2d(hx, w, b, padding=cz.padding))
    d = cz.out_channels
    return out[:, :d], out[:, d:]


class SepConvGRU(nn.Module):
    """Separable ConvGRU; the z and r gates of each pass run as one conv
    with the kernels concatenated along the output channels."""

    def __init__(self, hidden_dim=HDIM, input_dim=HDIM + 128,
                 dtype=torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        cin = hidden_dim + input_dim
        for name, ks, pad in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            setattr(self, "convz" + name, Conv2d(cin, hidden_dim, ks, 1, pad, dtype))
            setattr(self, "convr" + name, Conv2d(cin, hidden_dim, ks, 1, pad, dtype))
            setattr(self, "convq" + name, Conv2d(cin, hidden_dim, ks, 1, pad, dtype))

    def forward(self, h, x):
        dt = self.compute_dtype
        h = h.to(dt)
        x = x.to(dt)
        for name in ("1", "2"):
            z, r = fused_gates(self, torch.cat([h, x], dim=1), name)
            q = torch.tanh(getattr(self, "convq" + name)(
                torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class ConvGRU(nn.Module):
    """Plain 3x3 ConvGRU (the small update block); z and r run as one conv."""

    def __init__(self, hidden_dim=SMALL_HDIM, input_dim=SMALL_CDIM + 82,
                 dtype=torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        cin = hidden_dim + input_dim
        self.convz = Conv2d(cin, hidden_dim, 3, 1, 1, dtype)
        self.convr = Conv2d(cin, hidden_dim, 3, 1, 1, dtype)
        self.convq = Conv2d(cin, hidden_dim, 3, 1, 1, dtype)

    def forward(self, h, x):
        dt = self.compute_dtype
        h = h.to(dt)
        x = x.to(dt)
        z, r = fused_gates(self, torch.cat([h, x], dim=1), "")
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q


class FlowHead(nn.Module):
    def __init__(self, dtype=torch.float32, hidden_dim=HDIM):
        super().__init__()
        self.conv1 = Conv2d(hidden_dim, 256, 3, 1, 1, dtype)
        # flow deltas accumulate over the iterations: f32
        self.conv2 = Conv2d(256, 2, 3, 1, 1, torch.float32)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)).float())


class BasicUpdateBlock(nn.Module):
    """The update operator; ``small``: the small variant's (its motion
    encoder, the 3x3 ConvGRU, a hidden state of 96; no mask head)."""

    def __init__(self, dtype=torch.float32, radius=CORR_RADIUS, small=False):
        super().__init__()
        self.compute_dtype = dtype
        if small:
            self.encoder = SmallMotionEncoder(dtype, radius)
            self.gru = ConvGRU(dtype=dtype)
        else:
            self.encoder = BasicMotionEncoder(dtype, radius)
            self.gru = SepConvGRU(dtype=dtype)
        self.flow_head = FlowHead(dtype, SMALL_HDIM if small else HDIM)

    def forward(self, net, inp, corr, flow):
        dt = self.compute_dtype
        motion = self.encoder(flow.to(dt), corr)
        net = self.gru(net, torch.cat([inp.to(dt), motion], dim=1))
        return net, self.flow_head(net)


class UpMaskHead(nn.Module):
    """Convex-upsampling mask head, applied once to the final hidden state."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.mask_conv1 = Conv2d(HDIM, 256, 3, 1, 1, dtype)
        self.mask_conv2 = Conv2d(256, 64 * 9, 1, 1, 0, torch.float32)

    def forward(self, net):
        return 0.25 * self.mask_conv2(F.relu(self.mask_conv1(net)).float())


def build_corr_pyramid(fmap1: Tensor, fmap2: Tensor, dtype=None):
    """All-pairs correlation + 4-level pyramid (the ``"xla"`` lookup's
    volume): (B, H, W, C) features -> list of (B, N, Hl, Wl)."""
    b, h, w, c = fmap1.shape
    corr = torch.matmul(fmap1.reshape(b, h * w, c),
                        fmap2.reshape(b, h * w, c).transpose(1, 2)) / math.sqrt(c)
    if dtype is not None:
        corr = corr.to(dtype)
    pyramid = [corr.reshape(b, h * w, h, w)]
    for _ in range(CORR_LEVELS - 1):
        prev = pyramid[-1]
        _, n, hl, wl = prev.shape
        p = prev[:, :, :(hl // 2) * 2, :(wl // 2) * 2]      # floor semantics
        pyramid.append(p.reshape(b, n, hl // 2, 2, wl // 2, 2).mean(dim=(3, 5)))
    return pyramid


def lookup_corr(pyramid, coords: Tensor, radius: int = CORR_RADIUS):
    """Radius-r bilinear lookup as one-hot weight products per pixel,
    ``W_y @ corr @ W_x^T`` (the JAX package's ``lookup_corr``; out-of-level
    corners get all-zero weight rows). The weights are cast to the volume's
    dtype, as there.

    :param coords: (B, H, W, 2) (x, y) in 1/8-res pixels
    :return: list of per-level (B, (2r+1)^2, N) f32, dy-major
    """
    b, h, w, _ = coords.shape
    n = h * w
    d = 2 * radius + 1
    dd = torch.arange(d, device=coords.device, dtype=torch.float32) - radius
    outs = []
    for lvl, corr in enumerate(pyramid):
        hl, wl = corr.shape[2:]
        c = coords.reshape(b, n, 2).float() / float(2 ** lvl)
        x0, y0 = torch.floor(c[..., 0]), torch.floor(c[..., 1])
        wx = (c[..., 0] - x0)[..., None, None]
        wy = (c[..., 1] - y0)[..., None, None]
        ys = (y0[..., None] + dd)[..., None]                   # (B, N, D, 1)
        xs = (x0[..., None] + dd)[..., None]
        ygrid = torch.arange(hl, device=coords.device, dtype=torch.float32)
        xgrid = torch.arange(wl, device=coords.device, dtype=torch.float32)
        Wy = ((ygrid == ys) * (1.0 - wy) + (ygrid == ys + 1) * wy).to(corr.dtype)
        Wx = ((xgrid == xs) * (1.0 - wx) + (xgrid == xs + 1) * wx).to(corr.dtype)
        val = torch.matmul(torch.matmul(Wy, corr), Wx.transpose(-1, -2))
        outs.append(val.float().reshape(b, n, d * d).transpose(1, 2))
    return outs


def lookup_corr_gather(pyramid, coords: Tensor) -> Tensor:
    """Radius-4 bilinear lookup by element gathers with zero padding (the
    JAX package's ``lookup_corr_gather``: grid_sample's semantics, a test
    oracle on no path).

    :param pyramid: per-level (B, N, Hl, Wl) volumes
    :param coords: (B, H, W, 2) (x, y) in 1/8-res pixels
    :return: (B, H, W, L * 81), each level's window dy-major
    """
    b, h, w, _ = coords.shape
    r = CORR_RADIUS
    d = 2 * r + 1
    dx = torch.arange(-r, r + 1, dtype=coords.dtype, device=coords.device)
    dgrid_y, dgrid_x = torch.meshgrid(dx, dx, indexing="ij")
    out = []
    for lvl, corr in enumerate(pyramid):
        hl, wl = corr.shape[2:]
        c = coords.reshape(b, h * w, 2) / (2 ** lvl)
        cx = c[..., 0:1] + dgrid_x.reshape(1, 1, -1)
        cy = c[..., 1:2] + dgrid_y.reshape(1, 1, -1)
        x0 = torch.floor(cx)
        y0 = torch.floor(cy)
        wx = cx - x0
        wy = cy - y0
        flat = corr.reshape(b, h * w, hl * wl)

        def gather(ix, iy):
            inb = (ix >= 0) & (ix < wl) & (iy >= 0) & (iy < hl)
            idx = (iy.clamp(0, hl - 1) * wl + ix.clamp(0, wl - 1)).long()
            return torch.gather(flat, -1, idx) * inb

        v = (gather(x0, y0) * (1 - wx) * (1 - wy)
             + gather(x0 + 1, y0) * wx * (1 - wy)
             + gather(x0, y0 + 1) * (1 - wx) * wy
             + gather(x0 + 1, y0 + 1) * wx * wy)
        out.append(v.reshape(b, h, w, d * d))
    return torch.cat(out, dim=-1)


def upsample_flow_bilinear(flow: Tensor) -> Tensor:
    """The small variant's 8x upsampling, ``8 * jax.image.resize(flow,
    "linear", antialias=False)``: half-pixel centres, the border rows and
    columns repeating the edge (``F.interpolate``, ``align_corners=False``).

    :param flow: (B, H, W, 2) -> (B, 8H, 8W, 2)
    """
    b, h, w, _ = flow.shape
    up = F.interpolate(nchw(flow.float()), size=(8 * h, 8 * w),
                       mode="bilinear", align_corners=False)
    return 8.0 * nhwc(up)


def upsample_flow_convex(flow: Tensor, mask: Tensor) -> Tensor:
    """Convex-combination 8x upsampling of 1/8-res flow.

    :param flow: (B, H, W, 2); mask: (B, H, W, 64*9) logits (neighbour-major)
    :return: (B, 8H, 8W, 2)
    """
    b, h, w, _ = flow.shape
    m = mask.reshape(b, h, w, 9, 64)
    es = torch.exp(m - m.amax(dim=3, keepdim=True))
    den = es.sum(dim=3)                                        # (B, H, W, 64)
    fp = F.pad(8.0 * flow, (0, 0, 1, 1, 1, 1))
    acc = 0.0
    # 3x3 neighbourhood in row-major (di, dj) order (F.unfold's order)
    for k in range(9):
        i, j = divmod(k, 3)
        acc = acc + es[:, :, :, k, :, None] * fp[:, i:i + h, j:j + w, None, :]
    u = acc / den[..., None]                                   # (B, H, W, 64, 2)
    u = u.reshape(b, h, w, 8, 8, 2).permute(0, 1, 3, 2, 4, 5)
    return u.reshape(b, 8 * h, 8 * w, 2)


class RAFT(nn.Module):
    """RAFT with the aimi-lab fork API; NHWC images in [0, 255].

    :param small: the small variant (hidden state 96, context 64, radius 3)
    :param dropout: the encoders' channel-dropout rate in training
    :param remat_policy: "nothing" or "dots" (what ``remat`` keeps)
    """

    def __init__(self, iters=12, dtype=torch.bfloat16, corr_dtype=torch.bfloat16,
                 lookup="auto", remat=False, small=False, dropout=0.0,
                 remat_policy="nothing"):
        super().__init__()
        if lookup != "auto" and lookup not in LOOKUPS:
            raise ValueError(f"unknown correlation lookup {lookup!r}; expected "
                             "one of 'auto', 'onthefly', 'lanewise', 'grouped', "
                             "'xla'")
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {remat_policy!r}; expected "
                             "'nothing' or 'dots'")
        if not 0.0 <= dropout < 1.0:
            raise ValueError(f"dropout {dropout}; expected 0 <= dropout < 1")
        self.iters = iters
        self.compute_dtype = dtype
        self.corr_dtype = corr_dtype
        self.lookup = lookup
        self.remat = remat
        self.remat_policy = remat_policy
        self.small = small
        self.dropout = dropout
        self.hdim = SMALL_HDIM if small else HDIM
        self.cdim = SMALL_CDIM if small else CDIM
        # the Pallas grouped lookup takes no radius: radius 4 in both variants
        self.radius = (SMALL_RADIUS if small and lookup != "grouped"
                       else CORR_RADIUS)
        encoder = SmallEncoder if small else BasicEncoder
        self.fnet = encoder(128 if small else 256, "instance", dtype, dropout)
        self.cnet = encoder(self.hdim + self.cdim, "none" if small else "batch",
                            dtype, dropout)
        self.update = nn.ModuleDict({"update_block": BasicUpdateBlock(
            dtype, self.radius, small)})
        if not small:
            self.up_mask = UpMaskHead(dtype)

    def _run(self, fn, *args):
        """``fn(*args)``, recomputed in the backward pass under remat (all
        of it, or all but the convolutions and products with "dots")."""
        if self.remat and torch.is_grad_enabled():
            if self.remat_policy == "dots":
                return checkpoint(fn, *args, use_reentrant=False,
                                  context_fn=functools.partial(
                                      create_selective_checkpoint_contexts,
                                      _dots_policy))
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    @staticmethod
    def _prep(images: Tensor) -> Tensor:
        x = nchw(2.0 * (images / 255.0) - 1.0)
        return x.contiguous(memory_format=torch.channels_last)

    def _encode(self, net, images, train, generator, rows):
        keep = None
        if train and self.dropout > 0.0:
            if generator is None:
                raise ValueError("dropout in training needs a generator")
            # drawn here, outside the recomputed region (see the module doc)
            total, idx = (images.shape[0], None) if rows is None else rows
            keep = dropout_keep(total, net.conv2.out_channels, self.dropout,
                                generator)
            if idx is not None:
                keep = keep[idx.to(keep.device)]
        return nhwc(self._run(net, self._prep(images), keep))

    def encode_fnet(self, images: Tensor, train: bool = False,
                    generator=None, rows=None) -> Tensor:
        """(B, H, W, 3) in [0, 255] -> (B, H/8, W/8, 256 or 128 small);
        ``train`` applies dropout with masks from ``generator``. ``rows``
        ``(total, index)``: ``images`` are rows ``index`` of a batch of
        ``total`` (a data-parallel rank's share); the masks are drawn for
        the whole batch and these rows kept, so the rank drops what one
        process on the whole batch drops."""
        return self._encode(self.fnet, images, train, generator, rows)

    def encode_cnet(self, images: Tensor, train: bool = False, generator=None,
                    rows=None):
        """-> (net = tanh, inp = relu), each (B, H/8, W/8, hdim / cdim);
        dropout as in ``encode_fnet``."""
        c = self._encode(self.cnet, images, train, generator, rows)
        return torch.tanh(c[..., :self.hdim]), F.relu(c[..., self.hdim:])

    def _route(self, t: Tensor) -> str:
        """The lookup that runs for features on ``t``'s device."""
        if self.lookup == "auto":
            return "onthefly" if t.device.type == "cuda" else "xla"
        return self.lookup

    def _pyramid(self, fmap1, fmap2):
        route = self._route(fmap1)
        if route == "onthefly":
            return (fmap1.to(self.corr_dtype).contiguous(),
                    [l.to(self.corr_dtype)
                     for l in pool_fmap_pyramid(fmap2.float())])
        build = build_corr_pyramid_t if route == "lanewise" else build_corr_pyramid
        return build(fmap1.float(), fmap2.float(), dtype=self.corr_dtype)

    def _lookup(self, pyramid, coords1):
        route = self._route(coords1)
        if route == "onthefly":
            return onthefly_lookup_pyramid(pyramid[0], pyramid[1], coords1,
                                           radius=self.radius)
        if route == "lanewise":
            return lanewise_lookup(pyramid, coords1, radius=self.radius)
        if route == "grouped":
            return grouped_lookup_pyramid(pyramid, coords1)
        return lookup_corr(pyramid, coords1, radius=self.radius)

    def flow_from_features(self, fmap1, fmap2, net, inp):
        """Correlation + recurrent refinement from precomputed NHWC
        features; returns (flow_up (B, H, W, 2), hidden, context) with the
        hidden state and context NHWC f32."""
        b, h8, w8, _ = fmap1.shape
        pyramid = self._pyramid(fmap1, fmap2)
        ys, xs = torch.meshgrid(
            torch.arange(h8, dtype=torch.float32, device=fmap1.device),
            torch.arange(w8, dtype=torch.float32, device=fmap1.device),
            indexing="ij")
        coords0 = torch.stack([xs, ys], dim=-1)[None].expand(b, h8, w8, 2)
        net = nchw(net).to(self.compute_dtype)
        inp_c = nchw(inp)
        block = self.update["update_block"]

        def iteration(net, coords1):
            corr = self._lookup(pyramid, coords1)
            net, delta = block(net, inp_c, corr, nchw(coords1 - coords0))
            return net, coords1 + nhwc(delta)

        coords1 = coords0
        for _ in range(self.iters):
            net, coords1 = self._run(iteration, net, coords1)
        flow8 = coords1 - coords0
        if self.small:
            flow_up = upsample_flow_bilinear(flow8)
        else:
            flow_up = upsample_flow_convex(flow8, nhwc(self.up_mask(net)))
        return flow_up, nhwc(net).float(), inp.float()

    def forward(self, image1: Tensor, image2: Tensor, train: bool = False,
                generator=None):
        b = image1.shape[0]
        fmaps = self.encode_fnet(torch.cat([image1, image2], dim=0), train,
                                 generator)
        net, inp = self.encode_cnet(image1, train, generator)
        return self.flow_from_features(fmaps[:b], fmaps[b:], net, inp)
