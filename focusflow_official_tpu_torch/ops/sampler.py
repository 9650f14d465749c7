"""Bilinear sampling at pixel coordinates (NHWC).

The semantics of `F.grid_sample(align_corners=True, padding_mode='zeros')`
over pixel coordinates: a tap outside the image contributes zero, corner by
corner, so a sample that straddles the border blends with zeros. Written
as four gathers so that the coordinates are used as given, with no round
trip through normalised coordinates.
"""

from __future__ import annotations

import torch


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor, return_mask: bool = False):
    """Sample `img` (B, H, W, C) at pixel coordinates `coords` (B, ..., 2),
    (x, y) -> (B, ..., C) in img's type. Tap weights and the sum are f32.
    With `return_mask`, also (B, ...) in img's type: 1 where the point lies
    strictly inside the image's corner centres (normalised coordinates in
    (-1, 1), as the reference's sampler masks), else 0."""
    b, h, w, c = img.shape
    batch_shape = coords.shape[:-1]
    coords = coords.reshape(b, -1, 2).float()
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx1, wy1 = x - x0, y - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    flat = img.reshape(b, h * w, c)

    def tap(xi, yi, wgt):
        valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        return vals.float() * torch.where(valid, wgt, torch.zeros_like(wgt))[..., None]

    out = (tap(x0, y0, wx0 * wy0) + tap(x0 + 1, y0, wx1 * wy0)
           + tap(x0, y0 + 1, wx0 * wy1) + tap(x0 + 1, y0 + 1, wx1 * wy1))
    out = out.to(img.dtype).reshape(*batch_shape, c)
    if not return_mask:
        return out
    xg, yg = 2 * x / (w - 1) - 1, 2 * y / (h - 1) - 1
    mask = (xg > -1) & (yg > -1) & (xg < 1) & (yg < 1)
    return out, mask.reshape(batch_shape).to(img.dtype)
