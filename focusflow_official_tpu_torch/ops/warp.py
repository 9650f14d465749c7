"""Backward warping by optical flow, PWC-Net style (NHWC).

The reference's quirk is kept: its sampling grid uses pixel centres while
its flow is normalised by (size - 1) / 2, so the sample position is
`x + u * W / (W - 1)`, not `x + u`. A ones channel is warped alongside and
thresholded at 0.999, which zeroes every pixel whose sample touches the
outside. H and W must exceed 1.
"""

from __future__ import annotations

import torch

from .coords import coords_grid
from .sampler import bilinear_sample


def backwarp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp `img` (B, H, W, C) backward by `flow` (B, H, W, 2) (u, v)."""
    b, h, w, c = img.shape
    scale = torch.tensor([w / (w - 1.0), h / (h - 1.0)], device=flow.device)
    coords = coords_grid(b, h, w, device=flow.device) + flow.float() * scale
    ones = torch.ones((b, h, w, 1), dtype=img.dtype, device=img.device)
    out = bilinear_sample(torch.cat([img, ones], dim=-1), coords)
    mask = (out[..., c:] > 0.999).to(img.dtype)
    return out[..., :c] * mask
