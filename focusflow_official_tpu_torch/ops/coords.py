"""Coordinate grids, the align-corners bilinear resize and the 8x flow
upsampler built on it (the small model's), the half-pixel bilinear resize
(NHWC) and the host-side forward splat of a flow field (the warm start
between frame pairs)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def coords_grid(batch: int, ht: int, wd: int, device="cuda",
                dtype=torch.float32) -> torch.Tensor:
    """Pixel coordinate grid (batch, ht, wd, 2) in (x, y) channel order."""
    ys = torch.arange(ht, dtype=dtype, device=device)
    xs = torch.arange(wd, dtype=dtype, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)[None].expand(batch, ht, wd, 2)


def resize_bilinear_align_corners(x: torch.Tensor, new_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (B, H, W, C) or (H, W, C) to the size `new_hw`
    with `align_corners=True` (the corners' centres map onto each other; a
    size of 1 samples the first row or column); a non-float x is resized
    in f32."""
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    if not x.is_floating_point():
        x = x.float()
    out = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(new_hw), mode="bilinear",
                        align_corners=True).permute(0, 2, 3, 1)
    return out[0] if squeeze else out


def upflow8(flow: torch.Tensor) -> torch.Tensor:
    """8x align-corners bilinear upsample of (B, H, W, 2) flow, values
    scaled by 8."""
    _, h, w, _ = flow.shape
    return 8.0 * resize_bilinear_align_corners(flow, (8 * h, 8 * w))


def resize_bilinear(x: torch.Tensor, new_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (B, H, W, C) to (B, nh, nw, C) with half-pixel
    centres (`align_corners=False`), the source position clamped to the
    image and no antialiasing when shrinking."""
    out = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(new_hw),
                        mode="bilinear", align_corners=False)
    return out.permute(0, 2, 3, 1)


def forward_interpolate(flow):
    """Forward-splat a (H, W, 2) numpy flow field to warm-start the next
    frame pair: each pixel's flow moves to where it points, and the holes
    take their nearest splatted neighbour's value (scipy `griddata`,
    'nearest'). Host-side; the result is (H, W, 2) float32."""
    import numpy as np
    from scipy import interpolate

    flow = np.asarray(flow)
    dx, dy = flow[..., 0], flow[..., 1]
    ht, wd = dx.shape
    x0, y0 = np.meshgrid(np.arange(wd), np.arange(ht))

    x1 = (x0 + dx).reshape(-1)
    y1 = (y0 + dy).reshape(-1)
    dxf = dx.reshape(-1)
    dyf = dy.reshape(-1)

    valid = (x1 > 0) & (x1 < wd) & (y1 > 0) & (y1 < ht)
    x1, y1, dxf, dyf = x1[valid], y1[valid], dxf[valid], dyf[valid]

    flow_x = interpolate.griddata((x1, y1), dxf, (x0, y0), method="nearest", fill_value=0)
    flow_y = interpolate.griddata((x1, y1), dyf, (x0, y0), method="nearest", fill_value=0)
    return np.stack([flow_x, flow_y], axis=-1).astype(np.float32)
