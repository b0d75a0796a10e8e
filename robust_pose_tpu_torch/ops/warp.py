"""Flow-based warps (port of ``robust_pose_tpu/ops/warp.py``).

NHWC layout, pixel-space coordinates, zero padding. The JAX package's
TPU gather workarounds (``_quad_rows``, ``ops/gather.py``) are replaced by
plain indexing with the same zero-padding semantics. Nearest sampling is
``floor(c + 0.5)`` on the integer grid, exactly as in the JAX package.
"""
from __future__ import annotations

import torch

from robust_pose_tpu_torch.ops.geometry import _inv3

Tensor = torch.Tensor


def _inb(xf: Tensor, yf: Tensor, w: int, h: int) -> Tensor:
    """In-bounds test on float integer coordinates (NaN and huge values
    compare False instead of overflowing an int cast)."""
    return (xf >= 0) & (xf < w) & (yf >= 0) & (yf < h)


def _gather_pix(img: Tensor, xf: Tensor, yf: Tensor) -> Tensor:
    """Gather pixels at integer-valued float coords with zero padding.

    :param img: (B, H, W, C)
    :param xf, yf: (B, N) integer-valued float coordinates
    :return: (B, N, C)
    """
    b, h, w, c = img.shape
    inb = _inb(xf, yf, w, h)
    ix = torch.where(inb, xf, 0.0).long()
    iy = torch.where(inb, yf, 0.0).long()
    idx = (iy * w + ix)[..., None].expand(-1, -1, c)
    out = torch.gather(img.reshape(b, h * w, c), 1, idx)
    return out * inb[..., None].to(out.dtype)


def grid_sample(img: Tensor, coords_x: Tensor, coords_y: Tensor,
                mode: str = "bilinear") -> Tensor:
    """Sample ``img`` (B, H, W, C) at pixel coordinates (B, N) with zero
    padding; ``mode`` is 'bilinear' or 'nearest'. Returns (B, N, C)."""
    if mode == "nearest":
        return _gather_pix(img, torch.floor(coords_x + 0.5),
                           torch.floor(coords_y + 0.5))
    x0 = torch.floor(coords_x)
    y0 = torch.floor(coords_y)
    wx = (coords_x - x0)[..., None]
    wy = (coords_y - y0)[..., None]
    v00 = _gather_pix(img, x0, y0)
    v01 = _gather_pix(img, x0 + 1, y0)
    v10 = _gather_pix(img, x0, y0 + 1)
    v11 = _gather_pix(img, x0 + 1, y0 + 1)
    return (v00 * (1.0 - wx) * (1.0 - wy) + v01 * wx * (1.0 - wy)
            + v10 * (1.0 - wx) * wy + v11 * wx * wy)


def _flow_target_coords(flow: Tensor):
    """Pixel coordinates displaced by flow, (B, N) x and y. Integer base
    grid with NO +0.5 offset."""
    b, h, w, _ = flow.shape
    cols = torch.arange(w, dtype=flow.dtype, device=flow.device)
    rows = torch.arange(h, dtype=flow.dtype, device=flow.device)
    cx = (cols[None, None, :] + flow[..., 0]).reshape(b, -1)
    cy = (rows[None, :, None] + flow[..., 1]).reshape(b, -1)
    return cx, cy


class _PackMaskLSB(torch.autograd.Function):
    """Hide a boolean in bit 0 of the f32 depth (exact int32 view). The
    gradient treats the packing as the identity in ``depth``, as the JAX
    package's custom JVP does (exact to one ulp)."""

    @staticmethod
    def forward(ctx, depth, mask):
        u = depth.contiguous().view(torch.int32)
        return ((u & -2) | mask.to(torch.int32)).view(torch.float32)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _pack_mask_lsb(depth: Tensor, mask: Tensor) -> Tensor:
    return _PackMaskLSB.apply(depth.to(torch.float32), mask)


def _unpack_mask_lsb(packed: Tensor) -> Tensor:
    return (packed.contiguous().view(torch.int32) & 1).bool()


def warp_pcl_mask(depth: Tensor, mask: Tensor, flow: Tensor,
                  intrinsics: Tensor):
    """Bilinear-warp the point cloud of ``depth`` AND nearest-sample
    ``mask`` at the flow target coordinates, fetching one packed channel
    (the mask rides in the depth mantissa LSB; rays are affine in pixel
    coordinates, so the warped cloud is K^-1 applied to depth moments).

    :param depth: (B, H, W, 1) f32, positive (invalid pixels hold 1.0)
    :param mask: (B, H, W, 1) bool
    :param flow: (B, H, W, 2) pixel flow
    :param intrinsics: (B, 3, 3)
    :return: (pcl_w (B, H, W, 3) f32, mask_w (B, H, W, 1) bool)
    """
    b, h, w, _ = depth.shape
    packed = _pack_mask_lsb(depth, mask).reshape(b, h, w, 1)
    cx, cy = _flow_target_coords(flow)
    x0 = torch.floor(cx)
    y0 = torch.floor(cy)
    wx = cx - x0
    wy = cy - y0
    d00 = _gather_pix(packed, x0, y0)[..., 0]
    d01 = _gather_pix(packed, x0 + 1, y0)[..., 0]
    d10 = _gather_pix(packed, x0, y0 + 1)[..., 0]
    d11 = _gather_pix(packed, x0 + 1, y0 + 1)[..., 0]

    w00 = (1.0 - wx) * (1.0 - wy)
    w01 = wx * (1.0 - wy)
    w10 = (1.0 - wx) * wy
    w11 = wx * wy
    D = w00 * d00 + w01 * d01 + w10 * d10 + w11 * d11
    Dx = w01 * d01 + w11 * d11
    Dy = w10 * d10 + w11 * d11
    sx = (x0 + 0.5) * D + Dx
    sy = (y0 + 0.5) * D + Dy
    kinv = _inv3(intrinsics)
    pcl = (kinv[:, None, :, 0] * sx[..., None]
           + kinv[:, None, :, 1] * sy[..., None]
           + kinv[:, None, :, 2] * D[..., None])
    pcl_w = pcl.reshape(b, h, w, 3)

    right = wx >= 0.5
    down = wy >= 0.5
    vn = torch.where(down, torch.where(right, d11, d10),
                     torch.where(right, d01, d00))
    return pcl_w, _unpack_mask_lsb(vn).reshape(b, h, w, 1)


def warp_then_eighth(x: Tensor, flow: Tensor) -> Tensor:
    """``remap_from_flow`` fused with the half-pixel-centres 1/8 bilinear
    downsample, which reads only rows/cols {8i+3, 8i+4} with 0.5/0.5
    weights: the warp is evaluated at those taps only.

    :param x: (B, H, W, C); H, W divisible by 8
    :param flow: (B, H, W, 2) full-res flow
    :return: (B, H/8, W/8, C)
    """
    b, h, w, c = x.shape
    h8, w8 = h // 8, w // 8
    ft = flow.reshape(b, h8, 8, w8, 8, 2)[:, :, 3:5, :, 3:5]
    taps = torch.arange(3, 5, dtype=flow.dtype, device=flow.device)   # [3, 4]
    rows = 8.0 * torch.arange(h8, dtype=flow.dtype, device=flow.device)[:, None] + taps
    cols = 8.0 * torch.arange(w8, dtype=flow.dtype, device=flow.device)[:, None] + taps
    cy = rows[None, :, :, None, None] + ft[..., 1]
    cx = cols[None, None, None, :, :] + ft[..., 0]
    out = grid_sample(x, cx.reshape(b, -1), cy.reshape(b, -1))
    return out.reshape(b, h8, 2, w8, 2, c).mean(dim=(2, 4))


def eighth_from_fullres_warp(x_w: Tensor) -> Tensor:
    """Bilinear 1/8 downsample by its exact tap decomposition (mean of
    rows/cols {8i+3, 8i+4})."""
    b, h, w, c = x_w.shape
    cells = x_w.reshape(b, h // 8, 8, w // 8, 8, c)[:, :, 3:5, :, 3:5]
    return cells.mean(dim=(2, 4))


def warp_bilinear_nearest(x: Tensor, nearest_x: Tensor | None, flow: Tensor):
    """Bilinear-sample ``x`` AND nearest-sample ``nearest_x`` at the
    flow-displaced coordinates from the same four corners (the nearest
    pixel, ``floor(c + 0.5)``, is always one of the bilinear corners).

    :param x: (B, H, W, C) bilinear payload
    :param nearest_x: (B, H, W, Cn) nearest payload, or None
    :param flow: (B, H, W, 2) pixel flow
    :return: (warped (B, H, W, C), valid (B, H, W, 1), nearest_warped
        (B, H, W, Cn) or None, nearest_valid or None); valid = any channel
        > 0
    """
    b, h, w, c = x.shape
    cx, cy = _flow_target_coords(flow)
    packed = x if nearest_x is None else torch.cat(
        [x, nearest_x.to(x.dtype)], dim=-1)
    x0 = torch.floor(cx)
    y0 = torch.floor(cy)
    wx = (cx - x0)[..., None]
    wy = (cy - y0)[..., None]
    v00 = _gather_pix(packed, x0, y0)
    v01 = _gather_pix(packed, x0 + 1, y0)
    v10 = _gather_pix(packed, x0, y0 + 1)
    v11 = _gather_pix(packed, x0 + 1, y0 + 1)
    bil = (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
           + v10 * (1 - wx) * wy + v11 * wx * wy)
    out = bil[..., :c].reshape(b, h, w, c)
    valid = torch.any(out > 0, dim=-1, keepdim=True)
    if nearest_x is None:
        return out, valid, None, None
    right = wx >= 0.5
    down = wy >= 0.5
    vn = torch.where(down, torch.where(right, v11, v10),
                     torch.where(right, v01, v00))
    near = vn[..., c:].reshape(b, h, w, nearest_x.shape[-1])
    return out, valid, near, torch.any(near > 0, dim=-1, keepdim=True)


def remap_from_flow(x: Tensor, flow: Tensor):
    """Warp ``x (B, H, W, C)`` by bilinear sampling at the flow-displaced
    coordinates; returns (warped, valid (B, H, W, 1))."""
    out, valid, _, _ = warp_bilinear_nearest(x, None, flow)
    return out, valid


def remap_from_flow_nearest(x: Tensor, flow: Tensor):
    """Nearest-neighbour variant of ``remap_from_flow`` (f32 output)."""
    b, h, w, c = x.shape
    cx, cy = _flow_target_coords(flow)
    out = grid_sample(x.to(torch.float32), cx, cy,
                      mode="nearest").reshape(b, h, w, c)
    return out, torch.any(out > 0, dim=-1, keepdim=True)
