"""The all-pairs correlation volume and its pyramid, frozen from the port's
`ops/corr.py`, and the motion encoder's lookup with convc1 in plain
PyTorch (the port's kernel G):

- `all_pairs_corr`: corr[b, q, y, x] = <fmap1[b, q], fmap2[b, y, x]> / sqrt(C),
  one batched matrix product in f32;
- `corr_pyramid`: 2x2 average pooling with floor semantics over the target
  axes, computed in f32 and stored in the compute type.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from .plain import avg_pool2x2, lookup_fold_plain


def corr_rows(f1: torch.Tensor, fmap2: torch.Tensor) -> torch.Tensor:
    """Query rows f1 (B, n, C) against the NHWC map fmap2 (B, H, W, C) ->
    the volume's rows (B, n, H, W) in their type."""
    b, h, w, c = fmap2.shape
    corr = torch.matmul(f1, fmap2.reshape(b, h * w, c).transpose(1, 2)) / math.sqrt(c)
    return corr.reshape(b, f1.shape[1], h, w)


def all_pairs_corr(fmap1: torch.Tensor, fmap2: torch.Tensor) -> torch.Tensor:
    """NHWC feature maps (B, H, W, C) -> (B, H*W, H, W) in their type."""
    b, h, w, c = fmap1.shape
    return corr_rows(fmap1.reshape(b, h * w, c), fmap2)


def corr_pyramid(corr: torch.Tensor, num_levels: int = 4,
                 dtype: torch.dtype | None = None) -> list[torch.Tensor]:
    """Levels (B, Q, H2/2^l, W2/2^l), pooled in f32, stored in `dtype`
    (level 0 is `corr` itself where it is in `dtype` already)."""
    dtype = dtype or corr.dtype
    pooled = [corr.float()]
    for _ in range(num_levels - 1):
        pooled.append(avg_pool2x2(pooled[-1]))
    return [lv.to(dtype).contiguous() for lv in [corr] + pooled[1:]]


def lookup_convc1(corr: Sequence[torch.Tensor], coords: torch.Tensor, radius: int,
                  conv: torch.nn.Conv2d) -> torch.Tensor:
    """The motion encoder's convc1 (a 1x1 conv over the L*(2r+1)^2 window
    channels) of the windows at `coords` (B, H, W, 2) f32 -> (B, H, W, O)."""
    wc = conv.weight.reshape(conv.weight.shape[0], -1)
    return lookup_fold_plain(corr, coords, radius, wc, conv.bias)
