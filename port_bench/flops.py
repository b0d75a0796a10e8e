"""The work a configuration needs, from its published shapes alone: the
analytic FLOP count behind ``mfu.*`` and the byte bounds of the hand
kernels behind ``*_roofline.*``. Nothing here reads how the program
computes, so a change to the program moves the time and never the count.

FLOPs count products (2 per multiply-add): every convolution, the
all-pairs correlation, and the window lookup as the bilinear taps it needs
(4 levels x 81 points x 4 taps, a multiply-add each, every GRU
iteration). Elementwise work (norms, activations, the resize of the
confidence maps, the convex combination's softmax) and the pose solve,
whose iterations depend on the data, are left out. A training step's
backward counts twice the forward of every part whose gradient the job
computes, and nothing for what recomputation repeats.

Published peaks of one H100 SXM (dense): 989e12 bf16 FLOP/s, 3.35e12 B/s.
"""
from __future__ import annotations

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
LEVELS, RADIUS = 4, 4
WINDOW = (2 * RADIUS + 1) ** 2
HDIM, CDIM, FDIM = 128, 128, 256


def conv(cin, cout, kh, kw, hout, wout) -> float:
    return 2.0 * cin * cout * kh * kw * hout * wout


def _down(n, stride):
    return (n - 1) // stride + 1


def encoder(H: int, W: int, out_dim: int = FDIM) -> float:
    """One image through RAFT's BasicEncoder (7x7/2 stem, three residual
    stages of 64, 96, 128 channels, a 1x1 head)."""
    h, w = _down(H, 2), _down(W, 2)
    f = conv(3, 64, 7, 7, h, w)
    cin = 64
    for planes, stride in ((64, 1), (96, 2), (128, 2)):
        h, w = _down(h, stride), _down(w, stride)
        f += conv(cin, planes, 3, 3, h, w) + 3 * conv(planes, planes, 3, 3, h, w)
        if stride != 1 or cin != planes:
            f += conv(cin, planes, 1, 1, h, w)
        cin = planes
    return f + conv(cin, out_dim, 1, 1, h, w)


def iteration(h: int, w: int) -> dict:
    """One GRU iteration of one pair at 1/8 resolution (h x w): the
    lookup's taps; the motion encoder's, the separable GRU's and the flow
    head's convolutions."""
    n = h * w
    c = (conv(LEVELS * WINDOW, 256, 1, 1, h, w) + conv(256, 192, 3, 3, h, w)
         + conv(2, 128, 7, 7, h, w) + conv(128, 64, 3, 3, h, w)
         + conv(256, 126, 3, 3, h, w))
    c += 6 * conv(HDIM + 256, HDIM, 1, 5, h, w)
    c += conv(HDIM, 256, 3, 3, h, w) + conv(256, 2, 3, 3, h, w)
    return {"conv": c, "lookup": LEVELS * WINDOW * 4 * 2.0 * n}


def raft_pair(H: int, W: int, iters: int) -> dict:
    """One pair after its encoders: the all-pairs correlation, the
    iterations, the mask head and the convex combination."""
    h, w = H // 8, W // 8
    n = h * w
    it = iteration(h, w)
    return {"corr": 2.0 * n * n * FDIM,
            "conv": iters * it["conv"] + conv(HDIM, 256, 3, 3, h, w)
            + conv(256, 64 * 9, 1, 1, h, w),
            "lookup": iters * it["lookup"],
            "upsample": 2.0 * 9 * 2 * H * W}


def unet(cin: int, h: int, w: int, levels: int = 3) -> float:
    """A TinyUNet head at (h, w): unpadded 3x3 convolutions, 2x2 pooling,
    2x2 transposed convolutions, centre-cropped skips, a 1x1 output."""
    enc = (cin, 16, 32, 64)[:levels + 1]
    f, sizes = 0.0, []
    for i in range(levels):
        h, w = h - 2, w - 2
        f += conv(enc[i], enc[i + 1], 3, 3, h, w)
        h, w = h - 2, w - 2
        f += conv(enc[i + 1], enc[i + 1], 3, 3, h, w)
        sizes.append((h, w))
        if i < levels - 1:
            h, w = h // 2, w // 2
    dec = tuple(reversed(enc[1:]))
    h, w = sizes[-1]
    for i in range(levels - 1):
        f += conv(dec[i], dec[i + 1], 2, 2, h, w)
        h, w = 2 * h, 2 * w
        sh, sw = sizes[-2 - i]
        h, w = min(h, sh), min(w, sw)
        h, w = h - 2, w - 2
        f += conv(dec[i], dec[i + 1], 3, 3, h, w)
        h, w = h - 2, w - 2
        f += conv(dec[i + 1], dec[i + 1], 3, 3, h, w)
    return f + conv(dec[-1], 1, 1, 1, h, w)


def heads(H: int, W: int, levels: int = 3) -> float:
    """Both confidence heads of one frame pair."""
    h, w = H // 8, W // 8
    return (unet(HDIM + CDIM + 8, h, w, levels)
            + unet(HDIM + CDIM + 16, h, w, levels))


def work_breakdown(cfg: dict, work: dict) -> dict:
    """FLOPs of one unit of work (a tracking window, a training step) by
    kind (``conv``, ``corr``, ``lookup``, ``upsample``): ``work`` gives the
    RAFT ``pairs``, the images through ``fnet`` and ``cnet``, the ``heads``
    evaluated and whether all of it runs ``backward``."""
    H, W = cfg["image_shape"]
    m = cfg["model"]
    pair = raft_pair(H, W, m["iters"])
    raft = {k: work["pairs"] * v for k, v in pair.items()}
    raft["conv"] += (work["fnet"] + work["cnet"]) * encoder(H, W)
    hd = work["heads"] * heads(H, W, m.get("unet_levels", 3))
    out = dict(raft, conv=raft["conv"] + hd)
    if work["backward"]:
        out = {k: 3.0 * v for k, v in out.items()}
    return out


def work_flops(cfg: dict, work: dict) -> float:
    return sum(work_breakdown(cfg, work).values())


# ---------------------------------------------------------------------------
# the hand kernels' bounds: each input byte read once, each output written
# ---------------------------------------------------------------------------

def corr_window_bytes(pairs: int, H: int, W: int, esz: int = 2) -> float:
    """K1, one lookup of every level for ``pairs`` pairs: the frame-1
    features and the four pooled frame-2 levels (``esz`` bytes an
    element), the f32 centres, the f32 windows written."""
    h, w = H // 8, W // 8
    n = h * w
    levels = 0
    hl, wl = h, w
    for _ in range(LEVELS):
        levels += hl * wl
        hl, wl = hl // 2, wl // 2
    return pairs * (n * FDIM * esz + levels * FDIM * esz + n * 2 * 4
                    + LEVELS * WINDOW * n * 4)


def fnet_norm_shapes(H: int, W: int):
    """(C, h, w) of each instance norm in the feature encoder, in order."""
    h, w = _down(H, 2), _down(W, 2)
    out = [(64, h, w)]
    cin = 64
    for planes, stride in ((64, 1), (96, 2), (128, 2)):
        h, w = _down(h, stride), _down(w, stride)
        out += [(planes, h, w)] * 2
        if stride != 1 or cin != planes:
            out.append((planes, h, w))
        out += [(planes, h, w)] * 2
        cin = planes
    return out


def instance_norm_bytes(images: int, H: int, W: int, backward: bool,
                        esz: int = 2) -> float:
    """K2 over the feature encoder of ``images`` images: each norm's
    forward reads x and writes y (``esz`` bytes) and its f32 mean and
    reciprocal deviation; with ``backward`` each norm's statistics entry
    reads x again and writes its f32 sum and sum of squares."""
    total = 0.0
    for c, h, w in fnet_norm_shapes(H, W):
        x = images * c * h * w * esz
        stats = 2 * images * c * 4
        total += 2 * x + stats
        if backward:
            total += x + stats
    return total
