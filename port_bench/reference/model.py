"""The plain reference network: RAFT large, the TinyUNet confidence heads,
the weight maps and the pose objective, written with ``torch.nn.functional``
alone over a flat dict of tensors named as the measured program names its
``state_dict``. NCHW, float32; the caller turns TF32 off.

It follows the published network where the measured program does and the
program where that departs from it: the convex-upsampling mask head runs
once on the last hidden state; the GRU coordinates are not detached
between iterations; the weight maps' 1/8 resize is the half-pixel bilinear
one (taps 8i+3 and 8i+4); the heads read the warped point cloud at the
temporal flow's targets, with the frame-2 mask taken at the nearest pixel;
the window lookup is dy-major; the pose comes from a Levenberg-Marquardt
solve (``reference.solver``), not from LBFGS.

``q`` is applied to the operands of every product that the program runs in
bfloat16 (the convolutions but the flow head's and the mask head's last
ones and the heads' 1x1 output, and the correlation features), and
``out(q, .)`` to their outputs. The identity gives the reference;
``fake_quant`` gives the lower-precision control.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

RADIUS = 4
LEVELS = 4
HDIM = 128
CDIM = 128
BN_EPS = 1e-5
IN_EPS = 1e-5
BN_MOMENTUM = 0.99


def ident(x: Tensor) -> Tensor:
    return x


def _rounder(dtype):
    top = torch.finfo(dtype).max

    def r(x: Tensor) -> Tensor:
        s = x.abs().amax().clamp(min=1e-30) / top
        return (x / s).to(dtype).to(x.dtype) * s
    return r


class _RoundGrad(torch.autograd.Function):
    """The identity whose gradient is rounded by ``r``."""

    @staticmethod
    def forward(ctx, x, r):
        ctx.r = r
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.r(g), None


def fake_quant(fwd=torch.float8_e4m3fn, bwd=torch.float8_e5m2):
    """The products in float8, as float8 training runs them: every operand
    rounded to ``fwd`` (e4m3) and every product's output gradient to
    ``bwd`` (e5m2), each with one scale a tensor (its largest magnitude at
    the format's largest finite value). Returns ``q`` for the operands;
    ``q.out`` marks a product's output."""
    rf, rb = _rounder(fwd), _rounder(bwd)

    def q(x: Tensor) -> Tensor:
        return x + (rf(x.detach()) - x).detach()

    q.out = lambda y: _RoundGrad.apply(y, rb) if y.requires_grad else y
    return q


def out(q, y: Tensor) -> Tensor:
    """A product's output ``y`` under ``q`` (see ``fake_quant``)."""
    return q.out(y) if hasattr(q, "out") else y


# ---------------------------------------------------------------------------
# parameters: names, shapes and fan-in, as the program's state_dict has them
# ---------------------------------------------------------------------------

def _conv(specs, name, cin, cout, kh, kw=None):
    kw = kh if kw is None else kw
    specs.append((name + ".weight", (cout, cin, kh, kw), cin * kh * kw))
    specs.append((name + ".bias", (cout,), 0))


def _bn(specs, name, c):
    for k in ("weight", "bias", "running_mean", "running_var"):
        specs.append((f"{name}.{k}", (c,), -1))


def _encoder(specs, p, out_dim, norm):
    _conv(specs, p + ".conv1", 3, 64, 7)
    if norm == "batch":
        _bn(specs, p + ".norm1", 64)
    cin = 64
    for i, (planes, stride) in enumerate(zip((64, 96, 128), (1, 2, 2))):
        for j in range(2):
            b = f"{p}.layer{i + 1}_{j}"
            c_in = cin if j == 0 else planes
            _conv(specs, b + ".conv1", c_in, planes, 3)
            _conv(specs, b + ".conv2", planes, planes, 3)
            down = j == 0 and (stride != 1 or c_in != planes)
            if down:
                _conv(specs, b + ".downsample", c_in, planes, 1)
            if norm == "batch":
                _bn(specs, b + ".norm1", planes)
                _bn(specs, b + ".norm2", planes)
                if down:
                    _bn(specs, b + ".norm3", planes)
        cin = planes
    _conv(specs, p + ".conv2", cin, out_dim, 1)


def _unet(specs, p, cin, levels):
    enc = (cin, 16, 32, 64)[:levels + 1]
    dec = tuple(reversed(enc[1:]))
    for i in range(len(enc) - 1):
        _conv(specs, f"{p}.enc{i}.conv1", enc[i], enc[i + 1], 3)
        _bn(specs, f"{p}.enc{i}.norm", enc[i + 1])
        _conv(specs, f"{p}.enc{i}.conv2", enc[i + 1], enc[i + 1], 3)
    for i in range(len(dec) - 1):
        # a transposed convolution's kernel is (Cin, Cout, kh, kw)
        specs.append((f"{p}.upconv{i}.weight", (dec[i], dec[i + 1], 2, 2),
                      dec[i] * 4))
        specs.append((f"{p}.upconv{i}.bias", (dec[i + 1],), 0))
        _conv(specs, f"{p}.dec{i}.conv1", dec[i], dec[i + 1], 3)
        _bn(specs, f"{p}.dec{i}.norm", dec[i + 1])
        _conv(specs, f"{p}.dec{i}.conv2", dec[i + 1], dec[i + 1], 3)
    _conv(specs, p + ".head", dec[-1], 1, 1)


def param_specs(cfg: dict):
    """[(name, shape, fan_in)] of every tensor of the model: fan_in > 0 for
    a kernel, 0 for a bias, -1 for a BatchNorm tensor."""
    s = []
    _encoder(s, "flow.fnet", 256, "instance")
    _encoder(s, "flow.cnet", HDIM + CDIM, "batch")
    u = "flow.update.update_block"
    _conv(s, u + ".encoder.convc1", LEVELS * (2 * RADIUS + 1) ** 2, 256, 1)
    _conv(s, u + ".encoder.convc2", 256, 192, 3)
    _conv(s, u + ".encoder.convf1", 2, 128, 7)
    _conv(s, u + ".encoder.convf2", 128, 64, 3)
    _conv(s, u + ".encoder.conv", 192 + 64, 128 - 2, 3)
    for n, (kh, kw) in (("1", (1, 5)), ("2", (5, 1))):
        for g in "zrq":
            _conv(s, f"{u}.gru.conv{g}{n}", HDIM + 256, HDIM, kh, kw)
    _conv(s, u + ".flow_head.conv1", HDIM, 256, 3)
    _conv(s, u + ".flow_head.conv2", 256, 2, 3)
    _conv(s, "flow.up_mask.mask_conv1", HDIM, 256, 3)
    _conv(s, "flow.up_mask.mask_conv2", 256, 64 * 9, 1)
    levels = cfg.get("unet_levels", 3)
    _unet(s, "weight_head_2d.unet", HDIM + CDIM + 8, levels)
    _unet(s, "weight_head_3d.unet", HDIM + CDIM + 16, levels)
    s.append(("loss_weight", (2,), -2))
    return s


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def conv(P, name, x, stride=1, padding=0, q=ident):
    return out(q, F.conv2d(q(x), q(P[name + ".weight"]), P[name + ".bias"],
                           stride, padding))


def batch_norm(P, name, x, train=False, stats=None):
    """flax BatchNorm: running statistics, or (``train``) the batch's mean
    and biased variance, the running ones updated into ``stats``."""
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        m = BN_MOMENTUM
        stats[name + ".running_mean"] = (m * P[name + ".running_mean"]
                                         + (1 - m) * mean.detach())
        stats[name + ".running_var"] = (m * P[name + ".running_var"]
                                        + (1 - m) * var.detach())
    else:
        mean, var = P[name + ".running_mean"], P[name + ".running_var"]
    mul = torch.rsqrt(var + BN_EPS) * P[name + ".weight"]
    return (x - mean[:, None, None]) * mul[:, None, None] + P[name + ".bias"][:, None, None]


def encoder(P, p, x, norm, q=ident):
    def nrm(name, y):
        if norm == "instance":
            return F.instance_norm(y, eps=IN_EPS)
        return batch_norm(P, name, y)

    x = F.relu(nrm(p + ".norm1", conv(P, p + ".conv1", x, 2, 3, q)))
    for i, stride in enumerate((1, 2, 2)):
        for j in range(2):
            b = f"{p}.layer{i + 1}_{j}"
            s = stride if j == 0 else 1
            y = F.relu(nrm(b + ".norm1", conv(P, b + ".conv1", x, s, 1, q)))
            y = F.relu(nrm(b + ".norm2", conv(P, b + ".conv2", y, 1, 1, q)))
            if b + ".downsample.weight" in P:
                x = nrm(b + ".norm3", conv(P, b + ".downsample", x, s, 0, q))
            x = F.relu(x + y)
    return conv(P, p + ".conv2", x, 1, 0, q)


def prep(images: Tensor) -> Tensor:
    """(B, H, W, 3) in [0, 255] -> NCHW in [-1, 1]."""
    return (2.0 * (images.float() / 255.0) - 1.0).permute(0, 3, 1, 2)


def corr_pyramid(f1: Tensor, f2: Tensor, q=ident):
    """All-pairs correlation over C, scaled by 1/sqrt(C), and its 2x2
    average-pooled levels: [(B, N, Hl, Wl)]."""
    b, c, h, w = f1.shape
    corr = out(q, torch.einsum("bci,bcj->bij", q(f1).reshape(b, c, h * w),
                               q(f2).reshape(b, c, h * w))) / math.sqrt(c)
    pyr = [corr.reshape(b * h * w, 1, h, w)]
    for _ in range(LEVELS - 1):
        pyr.append(F.avg_pool2d(pyr[-1], 2, 2))
    return [p.reshape(b, h * w, *p.shape[2:]) for p in pyr]


def _bilinear_zero(vol: Tensor, x: Tensor, y: Tensor) -> Tensor:
    """vol (B, N, Hl, Wl) sampled at pixel coordinates x, y (B, N, K), zero
    outside."""
    b, n, hl, wl = vol.shape
    flat = vol.reshape(b, n, hl * wl)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0          # the weights' derivative is the right one
    out = 0.0
    for dx, dy, wgt in ((0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)),
                        (0, 1, (1 - fx) * fy), (1, 1, fx * fy)):
        xi, yi = x0 + dx, y0 + dy
        inb = (xi >= 0) & (xi < wl) & (yi >= 0) & (yi < hl)
        idx = (yi.clamp(0, hl - 1) * wl + xi.clamp(0, wl - 1)).long()
        out = out + torch.gather(flat, 2, idx) * wgt * inb
    return out


def lookup(pyr, coords: Tensor) -> Tensor:
    """The radius-4 windows of every level around ``coords`` (B, 2, h, w),
    (x, y) in level-0 pixels: (B, 4 * 81, h, w), each level dy-major."""
    b, _, h, w = coords.shape
    d = torch.arange(-RADIUS, RADIUS + 1, dtype=coords.dtype, device=coords.device)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    c = coords.reshape(b, 2, h * w)
    outs = []
    for lvl, vol in enumerate(pyr):
        cx = c[:, 0, :, None] / 2 ** lvl + dx.reshape(1, 1, -1)
        cy = c[:, 1, :, None] / 2 ** lvl + dy.reshape(1, 1, -1)
        outs.append(_bilinear_zero(vol, cx, cy).transpose(1, 2))
    return torch.cat(outs, dim=1).reshape(b, -1, h, w)


def update_block(P, net, inp, corr, flow, q=ident):
    u = "flow.update.update_block"
    c = F.relu(conv(P, u + ".encoder.convc1", corr, 1, 0, q))
    c = F.relu(conv(P, u + ".encoder.convc2", c, 1, 1, q))
    f = F.relu(conv(P, u + ".encoder.convf1", flow, 1, 3, q))
    f = F.relu(conv(P, u + ".encoder.convf2", f, 1, 1, q))
    m = F.relu(conv(P, u + ".encoder.conv", torch.cat([c, f], 1), 1, 1, q))
    x = torch.cat([inp, m, flow], 1)
    for n, pad in (("1", (0, 2)), ("2", (2, 0))):
        hx = torch.cat([net, x], 1)
        z = torch.sigmoid(conv(P, f"{u}.gru.convz{n}", hx, 1, pad, q))
        r = torch.sigmoid(conv(P, f"{u}.gru.convr{n}", hx, 1, pad, q))
        qq = torch.tanh(conv(P, f"{u}.gru.convq{n}", torch.cat([r * net, x], 1),
                             1, pad, q))
        net = (1 - z) * net + z * qq
    d = conv(P, u + ".flow_head.conv2",
             F.relu(conv(P, u + ".flow_head.conv1", net, 1, 1, q)), 1, 1)
    return net, d


def upsample_convex(flow: Tensor, mask: Tensor) -> Tensor:
    """RAFT's convex 8x upsampling: (B, 2, h, w), mask (B, 576, h, w)."""
    b, _, h, w = flow.shape
    m = torch.softmax(mask.reshape(b, 1, 9, 8, 8, h, w), dim=2)
    up = F.unfold(8.0 * flow, [3, 3], padding=1).reshape(b, 2, 9, 1, 1, h, w)
    out = (m * up).sum(dim=2).permute(0, 1, 4, 2, 5, 3)
    return out.reshape(b, 2, 8 * h, 8 * w)


def flow_from_features(P, f1, f2, net, inp, iters, q=ident, step=None):
    """RAFT's refinement: (flow (B, 2, H, W), hidden (B, 128, h, w)).
    ``step(fn, *args)`` runs each iteration (default: ``fn(*args)``)."""
    b, _, h, w = f1.shape
    pyr = corr_pyramid(f1, f2, q)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=f1.dtype, device=f1.device),
                            torch.arange(w, dtype=f1.dtype, device=f1.device),
                            indexing="ij")
    coords0 = torch.stack([xs, ys])[None].expand(b, 2, h, w)
    def iteration(net, coords1):
        net, d = update_block(P, net, inp, lookup(pyr, coords1),
                              coords1 - coords0, q)
        return net, coords1 + d

    coords1 = coords0
    for _ in range(iters):
        net, coords1 = (iteration(net, coords1) if step is None
                        else step(iteration, net, coords1))
    mask = 0.25 * conv(P, "flow.up_mask.mask_conv2",
                       F.relu(conv(P, "flow.up_mask.mask_conv1", net, 1, 1, q)))
    return upsample_convex(coords1 - coords0, mask), net


# ---------------------------------------------------------------------------
# depth, warps, heads
# ---------------------------------------------------------------------------

def disparity_to_depth(stereo_flow: Tensor, baseline: Tensor):
    """(B, 2, H, W) stereo flow -> (depth (B, 1, H, W), valid); invalid
    depth reads 1."""
    depth = baseline[:, None, None] / -stereo_flow[:, 0]
    valid = (depth > 0) & (depth <= 1.0)
    return torch.where(valid, depth, 1.0)[:, None], valid[:, None]


def rays(K: Tensor, h: int, w: int) -> Tensor:
    """K^-1 [x + 0.5, y + 0.5, 1] of every pixel: (B, 3, H, W)."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=K.dtype, device=K.device) + 0.5,
                            torch.arange(w, dtype=K.dtype, device=K.device) + 0.5,
                            indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)]).reshape(3, -1)
    return (torch.linalg.inv(K) @ pix).reshape(-1, 3, h, w)


def warp(x: Tensor, flow: Tensor, mode="bilinear") -> Tensor:
    """x (B, C, H, W) at (col + flow_x, row + flow_y), zero outside;
    ``nearest`` takes the pixel at floor(c + 0.5)."""
    b, c, h, w = x.shape
    ys, xs = torch.meshgrid(torch.arange(h, dtype=flow.dtype, device=flow.device),
                            torch.arange(w, dtype=flow.dtype, device=flow.device),
                            indexing="ij")
    cx = (xs + flow[:, 0]).reshape(b, 1, -1).expand(b, c, -1)
    cy = (ys + flow[:, 1]).reshape(b, 1, -1).expand(b, c, -1)
    if mode == "nearest":
        cx, cy = torch.floor(cx + 0.5), torch.floor(cy + 0.5)
    return _bilinear_zero(x, cx, cy).reshape(b, c, h, w)


def eighth(x: Tensor) -> Tensor:
    h, w = x.shape[-2:]
    return F.interpolate(x, size=(h // 8, w // 8), mode="bilinear",
                         align_corners=False)


def unet(P, p, x, out_hw, levels, train=False, stats=None, q=ident):
    feats = []
    for i in range(levels):
        e = f"{p}.enc{i}"
        x = conv(P, e + ".conv2",
                 F.relu(batch_norm(P, e + ".norm", conv(P, e + ".conv1", x, 1, 0, q),
                                   train, stats)), 1, 0, q)
        feats.append(x)
        if i < levels - 1:
            x = F.max_pool2d(x, 2, 2)
    feats = feats[::-1]
    x = feats[0]
    for i in range(levels - 1):
        u = f"{p}.upconv{i}"
        x = out(q, F.conv_transpose2d(q(x), q(P[u + ".weight"]), P[u + ".bias"], 2))
        skip = feats[i + 1]
        h2, w2 = skip.shape[-2:]
        dh, dw = (h2 - x.shape[2]) // 2, (w2 - x.shape[3]) // 2
        skip = skip[:, :, dh:h2 - dh, dw:w2 - dw][:, :, :x.shape[2], :x.shape[3]]
        d = f"{p}.dec{i}"
        y = F.relu(conv(P, d + ".conv1", torch.cat([x, skip], 1), 1, 0, q))
        x = conv(P, d + ".conv2", batch_norm(P, d + ".norm", y, train, stats), 1, 0, q)
    x = conv(P, p + ".head", x)
    return F.interpolate(x, size=out_hw, mode="bilinear", align_corners=False)


def weight_maps(P, cfg, pcl1, depth2, mask2, time_flow, img1, img2, sflow1,
                sflow2, hidden, context, K, train=False, stats=None, q=ident):
    """(conf1, conf2, pcl2 warped, mask2 warped): frame-2 quantities at the
    temporal flow's targets and the two confidence heads."""
    h, w = depth2.shape[-2:]
    pcl2 = depth2 * rays(K, h, w)
    pcl2_w = warp(pcl2, time_flow)
    mask2_w = warp(mask2.float(), time_flow, "nearest") > 0.5
    levels = cfg.get("unet_levels", 3)
    inp1 = eighth(torch.cat([sflow1, img1, pcl1], 1))
    inp2 = torch.cat([eighth(warp(torch.cat([sflow2, img2], 1), time_flow)),
                      eighth(pcl2_w)], 1)
    conf1 = torch.sigmoid(unet(P, "weight_head_2d.unet",
                               torch.cat([inp1, hidden, context], 1), (h, w),
                               levels, train, stats, q))
    conf2 = torch.sigmoid(unet(P, "weight_head_3d.unet",
                               torch.cat([inp1, inp2, hidden, context], 1),
                               (h, w), levels, train, stats, q))
    return conf1, conf2, pcl2_w, mask2_w
