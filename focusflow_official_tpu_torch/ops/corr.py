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
  chunk's product and pyramid, whatever the frame size, in training too:
  the walk is one autograd Function that keeps only the feature maps, the
  coordinates and the weight, and whose backward walks the chunks again
  (`alternate_corr_vjp`).

The windowed lookup over the pyramid is `kernels/lookup.py` (kernel A) and,
with convc1 applied in the same launch, `kernels/lookup_fold.py` (kernel
G), which `lookup_convc1` runs on either source.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Union

import torch

from ..kernels.lookup_fold import lookup_fold, lookup_fold_vjp
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


def _alt_operands(fmap1: torch.Tensor, fmap2: torch.Tensor, dt: torch.dtype):
    """The chunk product's operands: fmap1's rows times 1/sqrt(C) (in f32,
    then cast) and fmap2's transposed, both (B, ., .) in `dt`."""
    b, h, w, c = fmap1.shape
    f1 = (fmap1.reshape(b, h * w, c).float() * c ** -0.5).to(dt)
    f2t = fmap2.reshape(b, -1, c).to(dt).transpose(1, 2)
    return f1, f2t


def _chunk_levels(f1, f2t, s: int, n: int, h2: int, w2: int, num_levels: int, dt):
    """The pyramid of queries s..s+n: their rows of the volume (one product,
    accumulated in f32) pooled by `corr_pyramid`."""
    b = f1.shape[0]
    return corr_pyramid(torch.matmul(f1[:, s:s + n], f2t).reshape(b, n, h2, w2), num_levels, dt)


def _unpool_add(g: torch.Tensor, finer: torch.Tensor) -> torch.Tensor:
    """The VJP of `avg_pool2x2` from (..., h, w) onto (..., H, W), added to
    `finer`'s gradient: each 2x2 mean's gradient g / 4 on its four cells,
    0 on the odd last row and column that the pooling dropped."""
    up = g.repeat_interleave(2, -2).repeat_interleave(2, -1) * 0.25
    out = finer.clone()
    out[..., :up.shape[-2], :up.shape[-1]] += up
    return out


def alternate_corr_vjp(corr: AltCorr, coords: torch.Tensor, radius: int,
                       weight: torch.Tensor, g: torch.Tensor):
    """The VJP of `alternate_corr_fold`: g (B, H, W, O) -> (dfmap1, dfmap2
    in the maps' type, dweight in the weight's type, dbias f32). The
    chunks are walked again; for each: its product and pyramid
    recomputed, `lookup_fold_vjp` (kernel A rebuilds the window on the
    card) for the levels' gradients, those sent back through the 2x2 means
    into the level-0 rows (f32), then through the product: the chunk's
    rows of dfmap1 = dcorr · fmap2 · C^-1/2, and dfmap2 += dcorrᵀ ·
    fmap1's rows · C^-1/2, in f32. dfmap2, dweight and dbias are
    accumulated over the chunks in f32 and each rounded once. The
    coordinates take no gradient: every refinement detaches them."""
    fmap1, fmap2 = corr.fmap1, corr.fmap2
    b, h, w, c = fmap1.shape
    h2, w2 = fmap2.shape[1:3]
    q, dt = h * w, weight.dtype
    f1, f2t = _alt_operands(fmap1, fmap2, dt)
    cq = coords.reshape(b, 1, q, 2)
    gq = g.reshape(b, 1, q, -1)
    df1 = torch.empty((b, q, c), dtype=fmap1.dtype, device=fmap1.device)
    df2 = torch.zeros((b, h2 * w2, c), dtype=torch.float32, device=fmap1.device)
    f2 = f2t.transpose(1, 2).float()
    dweight = torch.zeros(weight.shape, dtype=torch.float32, device=weight.device)
    dbias = torch.zeros(weight.shape[:1], dtype=torch.float32, device=weight.device)
    for s in range(0, q, corr.chunk):
        n = min(corr.chunk, q - s)
        levels = _chunk_levels(f1, f2t, s, n, h2, w2, corr.num_levels, dt)
        dlevels, _, dw, db = lookup_fold_vjp(levels, cq[:, :, s:s + n].contiguous(), radius,
                                             weight, gq[:, :, s:s + n])
        del levels
        dweight += dw.float()
        dbias += db
        dcorr = dlevels[-1].float()
        for finer in reversed(dlevels[:-1]):
            dcorr = _unpool_add(dcorr, finer.float())
        del dlevels
        dcorr = dcorr.reshape(b, n, h2 * w2)
        df1[:, s:s + n] = (torch.matmul(dcorr, f2) * c ** -0.5).to(df1.dtype)
        df2 += torch.matmul(dcorr.transpose(1, 2), f1[:, s:s + n].float())
        del dcorr
    return (df1.reshape(fmap1.shape), df2.reshape(fmap2.shape).to(fmap2.dtype),
            dweight.to(dt), dbias)


class _AltCorrFold(torch.autograd.Function):
    @staticmethod
    def forward(ctx, radius, num_levels, chunk, coords, weight, bias, fmap1, fmap2):
        ctx.radius, ctx.num_levels, ctx.chunk = radius, num_levels, chunk
        ctx.save_for_backward(fmap1, fmap2, coords, weight)
        b, h, w, _ = fmap1.shape
        h2, w2 = fmap2.shape[1:3]
        q, dt = h * w, weight.dtype
        f1, f2t = _alt_operands(fmap1, fmap2, dt)
        cq = coords.reshape(b, 1, q, 2)
        outs = []
        for s in range(0, q, chunk):
            n = min(chunk, q - s)
            levels = _chunk_levels(f1, f2t, s, n, h2, w2, num_levels, dt)
            outs.append(lookup_fold(levels, cq[:, :, s:s + n].contiguous(), radius, weight,
                                    bias))
            del levels
        return torch.cat(outs, dim=2).reshape(b, h, w, -1)

    @staticmethod
    def backward(ctx, g):
        fmap1, fmap2, coords, weight = ctx.saved_tensors
        df1, df2, dweight, dbias = alternate_corr_vjp(
            AltCorr(fmap1, fmap2, ctx.num_levels, ctx.chunk), coords, ctx.radius, weight, g)
        return None, None, None, None, dweight, dbias.to(weight.dtype), df1, df2


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
    contiguous at any B.

    Differentiable in the feature maps, the weight and the bias through one
    Function (`alternate_corr_vjp`): autograd keeps the maps, the
    coordinates and the weight, no chunk's tensor, so a training step's
    extra memory is one chunk's too."""
    return _AltCorrFold.apply(radius, corr.num_levels, corr.chunk, coords, weight, bias,
                              corr.fmap1, corr.fmap2)


def lookup_convc1(corr: Union[Sequence[torch.Tensor], AltCorr], coords: torch.Tensor,
                  radius: int, conv: torch.nn.Conv2d) -> torch.Tensor:
    """The motion encoder's convc1 (a 1x1 conv over the L*(2r+1)^2 window
    channels) of the windows at `coords` (B, H, W, 2) f32 -> (B, H, W, O):
    kernel G on the pyramid's levels, or ALT_CORR's chunks."""
    wc = conv.weight.reshape(conv.weight.shape[0], -1)
    if isinstance(corr, AltCorr):
        return alternate_corr_fold(corr, coords, radius, wc, conv.bias)
    return lookup_fold(corr, coords, radius, wc, conv.bias)
