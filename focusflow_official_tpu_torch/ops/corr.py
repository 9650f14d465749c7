"""All-pairs correlation volume and its pyramid.

- `all_pairs_corr`: corr[b, q, y, x] = <fmap1[b, q], fmap2[b, y, x]> / sqrt(C),
  one batched matrix product in f32;
- `corr_pyramid`: 2x2 average pooling with floor semantics over the target
  axes, computed in f32 and stored in the compute type.

The windowed lookup over the pyramid is `kernels/lookup.py` (kernel A) and,
with convc1 applied in the same launch, `kernels/lookup_fold.py`.
"""

from __future__ import annotations

import math

import torch

from .pool import avg_pool2x2


def all_pairs_corr(fmap1: torch.Tensor, fmap2: torch.Tensor) -> torch.Tensor:
    """NHWC feature maps (B, H, W, C) -> (B, H*W, H, W) in their type."""
    b, h, w, c = fmap1.shape
    f1 = fmap1.reshape(b, h * w, c)
    f2 = fmap2.reshape(b, h * w, c)
    corr = torch.matmul(f1, f2.transpose(1, 2)) / math.sqrt(c)
    return corr.reshape(b, h * w, h, w)


def corr_pyramid(corr: torch.Tensor, num_levels: int = 4,
                 dtype: torch.dtype | None = None) -> list[torch.Tensor]:
    """Levels (B, Q, H2/2^l, W2/2^l), pooled in f32, stored in `dtype`."""
    dtype = dtype or corr.dtype
    levels = [corr.float()]
    for _ in range(num_levels - 1):
        levels.append(avg_pool2x2(levels[-1]))
    return [lv.to(dtype).contiguous() for lv in levels]
