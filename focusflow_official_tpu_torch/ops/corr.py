"""All-pairs correlation volume, its pyramid, and ALT_CORR's lookup that
never builds the volume.

- `all_pairs_corr`: corr[b, q, y, x] = <fmap1[b, q], fmap2[b, y, x]> / sqrt(C),
  one batched matrix product in f32;
- `corr_pyramid`: 2x2 average pooling with floor semantics over the target
  axes, computed in f32 and stored in the compute type;
- `AltCorr` (MODEL.ALT_CORR): the two feature maps in the compute type in
  place of the pyramid. Each refinement, `alternate_corr_fold` walks the
  queries in chunks: the chunk's rows of the volume (one matrix product),
  their pyramid, and the lookup with convc1 on it. Its extra memory is one
  chunk's product and pyramid, whatever the frame size.

The windowed lookup over the pyramid is `kernels/lookup.py` (kernel A) and,
with convc1 applied in the same launch, `kernels/lookup_fold.py` (kernel
G), which `lookup_convc1` runs on either source.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Union

import torch

from ..kernels.lookup_fold import lookup_fold
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
    """Levels (B, Q, H2/2^l, W2/2^l), pooled in f32, stored in `dtype`
    (level 0 is `corr` itself where it is in `dtype` already)."""
    dtype = dtype or corr.dtype
    pooled = [corr.float()]
    for _ in range(num_levels - 1):
        pooled.append(avg_pool2x2(pooled[-1]))
    return [lv.to(dtype).contiguous() for lv in [corr] + pooled[1:]]


@dataclasses.dataclass(frozen=True)
class AltCorr:
    """ALT_CORR's correlation source: NHWC feature maps (B, H, W, C) in the
    compute type, looked up `chunk` queries at a time over `num_levels`
    levels."""

    fmap1: torch.Tensor
    fmap2: torch.Tensor
    num_levels: int = 4
    chunk: int = 2048


def alternate_corr_fold(corr: AltCorr, coords: torch.Tensor, radius: int,
                        weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """convc1 of the looked-up windows without the all-pairs volume: for
    each chunk of queries, the chunk's (chunk, H2*W2) product with fmap2,
    its `corr_pyramid`, and kernel G on those levels and the chunk's
    coordinates -> (B, H, W, O) in the weight's type, as
    `lookup_fold(corr_pyramid(all_pairs_corr(...)), ...)` gives.

    The product's operands are in the compute type and it accumulates in
    f32. The 1/sqrt(C) scale goes onto the fmap1 operand (in f32, before
    its cast), so a bf16 product is rounded once, after the scale; for C =
    256 the scale is a power of two and the operand's cast is the same as
    without it. A chunk's coordinates go to G as (B, 1, chunk, 2), which is
    contiguous at any B."""
    b, h, w, c = corr.fmap1.shape
    h2, w2 = corr.fmap2.shape[1:3]
    q, dt = h * w, weight.dtype
    f1 = (corr.fmap1.reshape(b, q, c).float() * c ** -0.5).to(dt)
    f2t = corr.fmap2.reshape(b, h2 * w2, c).to(dt).transpose(1, 2)
    cq = coords.reshape(b, 1, q, 2)
    outs = []
    for s in range(0, q, corr.chunk):
        n = min(corr.chunk, q - s)
        levels = corr_pyramid(torch.matmul(f1[:, s:s + n], f2t).reshape(b, n, h2, w2),
                              corr.num_levels, dt)
        outs.append(lookup_fold(levels, cq[:, :, s:s + n].contiguous(), radius, weight, bias))
        del levels
    return torch.cat(outs, dim=2).reshape(b, h, w, -1)


def lookup_convc1(corr: Union[Sequence[torch.Tensor], AltCorr], coords: torch.Tensor,
                  radius: int, conv: torch.nn.Conv2d) -> torch.Tensor:
    """The motion encoder's convc1 (a 1x1 conv over the L*(2r+1)^2 window
    channels) of the windows at `coords` (B, H, W, 2) f32 -> (B, H, W, O):
    kernel G on the pyramid's levels, or ALT_CORR's chunks."""
    wc = conv.weight.reshape(conv.weight.shape[0], -1)
    if isinstance(corr, AltCorr):
        return alternate_corr_fold(corr, coords, radius, wc, conv.bias)
    return lookup_fold(corr, coords, radius, wc, conv.bias)
