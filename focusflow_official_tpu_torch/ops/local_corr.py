"""Local (windowed) cost volume: PWC-Net's 81-channel correlation.

    out[b, y, x, (dy+r)(2r+1) + (dx+r)] = mean_c f1[b, y, x, c] * f2[b, y+dy, x+dx, c]

with zero padding outside f2 and dy, dx in [-r, r] (kernel D on CUDA
tensors, `kernels/local_corr.py`), optionally followed by a leaky ReLU in
the same launch.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels.local_corr import local_corr as _local_corr_kernel


def local_corr(fmap1: torch.Tensor, fmap2: torch.Tensor, radius: int = 4,
               negative_slope: Optional[float] = None) -> torch.Tensor:
    """NHWC feature maps (B, H, W, C) -> (B, H, W, (2r+1)^2) in their type,
    channels dy-major; `F.leaky_relu(·, negative_slope)` of it where a slope
    is given. On the card both maps must be contiguous."""
    return _local_corr_kernel(fmap1, fmap2, radius, negative_slope)
