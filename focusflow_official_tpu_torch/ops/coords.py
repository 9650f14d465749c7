"""Coordinate grids, the 8x align-corners flow upsampler and the half-pixel
bilinear resize (NHWC)."""

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


def upflow8(flow: torch.Tensor) -> torch.Tensor:
    """8x bilinear (align_corners=True) upsample of (B, H, W, 2) flow,
    values scaled by 8."""
    _, h, w, _ = flow.shape
    up = F.interpolate(flow.permute(0, 3, 1, 2), size=(8 * h, 8 * w),
                       mode="bilinear", align_corners=True)
    return 8.0 * up.permute(0, 2, 3, 1)


def resize_bilinear(x: torch.Tensor, new_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (B, H, W, C) to (B, nh, nw, C) with half-pixel
    centres (`align_corners=False`), the source position clamped to the
    image and no antialiasing when shrinking."""
    out = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(new_hw),
                        mode="bilinear", align_corners=False)
    return out.permute(0, 2, 3, 1)
