"""The benchmark's inputs, made on the device from the run's seed: the
frames of a stereo camera moving along one path, training batches cut
from the same kind of scene, and the network's weights.

The scene is a box-blurred uniform random texture (smooth gradients, as
video has). A frame is a crop of it: frame i of a path starts ``step_px``
columns right of frame i - 1, and the right eye's crop starts
``disparity_px`` columns right of the left one's, so the left camera
translates along x at a constant depth. Every input is a function of the
seed alone; the sizes come from the configuration and the mix.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference.model import param_specs

Tensor = torch.Tensor
BORDER = 8          # rows above and below the crops, as blur margin
BLUR = 9            # box blur half width


def _generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one of the run's input streams."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) % (1 << 63))
    return g


def texture(seed: int, height: int, width: int, device) -> Tensor:
    """uint8 (height + 2 BORDER, width, 3) blurred random texture."""
    g = _generator(seed, 1, device)
    base = 255.0 * torch.rand((1, 3, height + 2 * BORDER, width), generator=g,
                              device=device)
    k = BLUR
    for dim, pad in ((2, (0, 0, k, k)), (3, (k, k, 0, 0))):
        c = torch.cumsum(F.pad(base, pad, mode="replicate").double(), dim=dim)
        n = base.shape[dim]
        base = ((c.narrow(dim, 2 * k, n) - c.narrow(dim, 0, n)) / (2 * k)).float()
    base = base[0].permute(1, 2, 0)
    return base.round().clamp(0, 255).to(torch.uint8).contiguous()


def crops(tex: Tensor, x0: Tensor, h: int, w: int) -> Tensor:
    """uint8 (n, h, w, 3) crops of ``tex`` at columns ``x0`` (n,) and rows
    BORDER .. BORDER + h."""
    cols = x0.to(tex.device)[:, None] + torch.arange(w, device=tex.device)
    return tex[BORDER:BORDER + h][:, cols].permute(1, 0, 2, 3).contiguous()


def stream_frames(seed: int, n: int, h: int, w: int, step_px: int,
                  disparity_px: int, device):
    """(left, right) uint8 (n, h, w, 3): one continuous path of n frames."""
    tex = texture(seed, h, w + step_px * n + disparity_px + 1, device)
    x0 = step_px * torch.arange(n, device=device)
    return crops(tex, x0, h, w), crops(tex, x0 + disparity_px, h, w)


def train_batches(seed: int, n_batches: int, batch: int, h: int, w: int,
                  mix: dict, cfg: dict, device):
    """``n_batches`` training batches of ``batch`` samples, every row a
    different place of one scene: (img1, img2, img1r, img2r) uint8
    (B, 3, H, W), masks (B, 1, H, W) bool, the true relative pose (B, 7),
    K (B, 3, 3), the normalized baseline (B,). Sample i pairs frame x0 with
    frame x0 + k * step_px, k drawn from the mix's ``frame_steps`` range;
    its pose is the camera's translation over k frames."""
    rows = n_batches * batch
    lo, hi = mix["frame_steps"]
    step, disp = mix["step_px"], mix["disparity_px"]
    rng = np.random.default_rng(int(seed) % (1 << 63))
    ks = rng.integers(lo, hi + 1, size=rows)
    span = w + step * hi + disp + 1
    # every row starts at its own column: the rows never repeat
    x0 = rng.permutation(rows) * (step * hi + 7) + rng.integers(0, 7, size=rows)
    tex = texture(seed, h, int(x0.max()) + span, device)
    x0 = torch.as_tensor(x0, device=device)
    x1 = x0 + torch.as_tensor(ks * step, device=device)
    nchw = lambda t: t.permute(0, 3, 1, 2).contiguous()
    img1, img2 = nchw(crops(tex, x0, h, w)), nchw(crops(tex, x1, h, w))
    img1r, img2r = nchw(crops(tex, x0 + disp, h, w)), nchw(crops(tex, x1 + disp, h, w))
    cam = cfg["camera"]
    scale = cfg["depth_scale"]
    depth_mm = cam["bf"] / disp
    gt = torch.zeros((rows, 7), device=device)
    gt[:, 0] = torch.as_tensor(-ks * step * depth_mm / cam["fx"] / scale,
                               dtype=torch.float32, device=device)
    gt[:, 6] = 1.0
    K = intrinsics(cam, h, w, device).expand(rows, 3, 3).contiguous()
    bl = torch.full((rows,), cam["bf"] / scale, device=device)
    mask = torch.ones((rows, 1, h, w), dtype=torch.bool, device=device)
    out = []
    for j in range(n_batches):
        s = slice(j * batch, (j + 1) * batch)
        out.append((img1[s], img2[s], img1r[s], img2r[s], mask[s], mask[s],
                    gt[s], K[s], bl[s]))
    return out


def intrinsics(cam: dict, h: int, w: int, device) -> Tensor:
    fx = float(cam["fx"])
    return torch.tensor([[fx, 0.0, w / 2], [0.0, fx, h / 2], [0.0, 0.0, 1.0]],
                        device=device)


def weights(seed: int, cfg: dict, device) -> dict:
    """The network's float32 weights from the seed, in one draw on the
    device: kernels LeCun-normal, biases zero, BatchNorm the identity,
    unit loss weights. RAFT's last flow-head convolution keeps
    ``head_weight_scale`` of its LeCun draw and is biased so that its
    ``iters`` updates add up to the configuration's ``head_flow_px`` at
    full resolution: every pair's flow is that offset plus a small part
    that follows the frames through the correlation lookup and the GRU,
    the depth is valid everywhere and every branch after RAFT stays
    engaged (a random RAFT's flow leaves the depth invalid). The offset's
    components are not whole pixels, so that no warp samples exactly at a
    pixel, where its derivative would follow the last bit of the flow."""
    specs = param_specs(cfg["model"])
    kernels = [(n, s, f) for n, s, f in specs if f > 0]
    total = sum(int(np.prod(s)) for _, s, _ in kernels)
    draw = torch.randn((total,), generator=_generator(seed, 2, device),
                       device=device)
    out, off = {}, 0
    for name, shape, fan in specs:
        if fan > 0:
            k = int(np.prod(shape))
            out[name] = (draw[off:off + k] / fan ** 0.5).reshape(shape)
            off += k
        elif name.endswith(("running_var", ".weight")) or fan == -2:
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    head = "flow.update.update_block.flow_head.conv2"
    out[head + ".weight"] = out[head + ".weight"] * cfg["head_weight_scale"]
    out[head + ".bias"] = torch.tensor(cfg["head_flow_px"], device=device) / (
        8.0 * cfg["model"]["iters"])
    return out
