"""Backward warping by optical flow, PWC-Net style (NHWC).

The reference's quirk is kept: its sampling grid uses pixel centres while
its flow is normalised by (size - 1) / 2, so the sample position is
`x + u * W / (W - 1)`, not `x + u`. A ones channel is warped alongside and
thresholded at 0.999, which zeroes every pixel whose sample touches the
outside. The ones channel is sampled and compared in f32 whatever the
image's type: in bf16, 0.999 rounds to 1 and the warped ones channel to 1
or at most 0.99609375, so a bf16 threshold zeroes every pixel. H and W must
exceed 1.
"""

from __future__ import annotations

import torch

from .coords import coords_grid
from .sampler import bilinear_sample


def backwarp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp `img` (B, H, W, C) backward by `flow` (B, H, W, 2) (u, v)."""
    b, h, w, _ = img.shape
    scale = torch.tensor([w / (w - 1.0), h / (h - 1.0)], device=flow.device)
    coords = coords_grid(b, h, w, device=flow.device) + flow.float() * scale
    alpha = bilinear_sample(torch.ones((b, h, w, 1), device=img.device), coords)
    return bilinear_sample(img, coords) * (alpha > 0.999).to(img.dtype)
