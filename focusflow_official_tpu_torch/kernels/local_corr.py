"""Kernel D: PWC-Net's local correlation (`csrc/local_corr.cu`).

out[b, y, x, (dy+r)(2r+1) + (dx+r)] = mean_c f1[b, y, x, c] * f2[b, y+dy, x+dx, c]
for dy, dx in [-r, r], zero outside f2, channels dy-major, NHWC in and out.
Products are summed in f32; the output has the inputs' type. Given a
`negative_slope`, the output is `F.leaky_relu` of that, in the same launch.

bf16 runs on the tensor cores (`local_corr_mma`) as `plan` lays the launch
out from the shape and the card's SM count; f32 runs the FMA entry, whose
dy split `plan` also gives.

`local_corr` is differentiable in both maps (a `torch.autograd.Function`):
its backward is `local_corr_vjp`, plain PyTorch on every device, the VJP
of the plain correlation in f32 that the JAX package differentiates
(`ops/pallas_local_corr.py::_bwd`), cast to the maps' types.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build, count_launch

_c = ctypes.c_void_p
_i = ctypes.c_int
MAX_RADIUS = 4  # the radii `csrc/local_corr.cu` is built for

# the tensor-core entry as built (`csrc/local_corr.cu`)
SEG = 16  # output pixels a segment: the rows of one m16 tile
HALO = 24  # f2 pixels staged a halo row (three n8 tiles)
PAD = 8  # values added to a staged row
MAX_WARPS = 8
MAX_CHUNK = 256  # channels staged at a time, at most
MAX_SMEM = 232448
ROWS = (8, 4, 2, 1)  # output rows a block, the most that still fill the card first
# the f32 FMA entry: 8 x 8 pixels a block, at least 256 threads
FMA_TILE = 8


@functools.cache
def _lib():
    lib = _build.load("local_corr")
    lib.ff_local_corr.argtypes = [_c, _c, _c] + [_i] * 11 + [ctypes.c_float, _i, _c]
    lib.ff_local_corr.restype = _i
    lib.ff_local_corr_smem.argtypes = [_i] * 6
    lib.ff_local_corr_smem.restype = ctypes.c_longlong
    return lib


def smem_built(c: int, radius: int, p: dict) -> int:
    """Shared memory (bytes) of a bf16 launch with plan `p`, as the library
    computes it (the card tests hold `plan`'s `smem` to it)."""
    return _lib().ff_local_corr_smem(c, radius, p["rows"], p["ndy"], p["split"], p["chunk"])


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(b: int, h: int, w: int, c: int, radius: int, dtype: torch.dtype,
         sms: int) -> dict:
    """The launch of a call on (b, h, w, c) maps on a card of `sms` SMs.

    f32, entry `fma`: 8 x 8 pixel tiles; where they number fewer than the
    SMs, the 2r+1 dy rows spread over `groups` blocks of `ndy` rows each.

    bf16, entry `mma`: a block takes `rows` output rows of one 16-pixel
    segment and `ndy` dy rows (a divisor of 2r+1). `rows` is the largest
    of 8, 4, 2, 1 whose blocks fill the SMs; where even one row a block does
    not, the dy rows spread over the fewest groups that do. Channels,
    padded to a multiple of 16, are staged `chunk` at a time: all at once
    up to C = 256, else in the fewest chunks whose ring stages fit an SM's
    shared memory. The block's (row, dy) pairs are cut into runs of
    `per`, and a warp takes one run and one of `split` slices of a chunk's
    k16 steps; the coarse levels split channels until the block has up to
    8 such tasks, and a block has a warp a task."""
    if not 1 <= radius <= MAX_RADIUS:
        raise ValueError(f"local_corr: radius 1 to {MAX_RADIUS}, got {radius}")
    k = 2 * radius + 1
    if dtype == torch.float32:
        tiles = b * _cdiv(h, FMA_TILE) * _cdiv(w, FMA_TILE)
        split = min(k, _cdiv(sms, tiles))
        ndy = _cdiv(k, split)
        groups = _cdiv(k, ndy)
        return dict(entry="fma", rows=FMA_TILE, ndy=ndy, groups=groups, split=1,
                    warps=0, chunk=0, grid=tiles * groups)
    segs = _cdiv(w, SEG)
    for rows in ROWS:
        bands = _cdiv(h, rows)
        if b * bands * segs >= sms:
            break
    tiles = b * bands * segs
    groups = next((g for g in range(1, k + 1) if k % g == 0 and tiles * g >= sms), k)
    ndy = k // groups
    pairs = rows * ndy
    ksteps = _cdiv(c, 16)
    for nchunks in range(_cdiv(ksteps * 16, MAX_CHUNK), ksteps + 1):
        chunk = _cdiv(ksteps, nchunks) * 16
        split = max(1, min(chunk // 16, MAX_WARPS // pairs))
        stage = (rows * SEG + (rows + ndy - 1) * HALO) * (chunk + PAD) * 2
        smem = (2 if nchunks > 1 else 1) * stage + split * rows * SEG * ndy * k * 4
        if smem <= MAX_SMEM:  # else more, smaller chunks
            break
    per = _cdiv(pairs, MAX_WARPS // split)  # pairs a warp walks
    warps = split * _cdiv(pairs, per)
    return dict(entry="mma", rows=rows, ndy=ndy, groups=groups, split=split,
                warps=warps, per=per, chunk=chunk, nchunks=nchunks, bands=bands, segs=segs,
                grid=tiles * groups, smem=smem)


def local_corr_plain(fmap1: torch.Tensor, fmap2: torch.Tensor, radius: int = 4,
                     negative_slope: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version: (2r+1)^2 shifted products of f32 copies, each
    summed over channels and scaled by 1/C, cast to fmap1's type; then
    `F.leaky_relu` where a slope is given."""
    b, h, w, c = fmap1.shape
    r = radius
    f1 = fmap1.float()
    f2p = F.pad(fmap2.float(), (0, 0, r, r, r, r))
    outs = [(f1 * f2p[:, dy:dy + h, dx:dx + w]).sum(-1)
            for dy in range(2 * r + 1) for dx in range(2 * r + 1)]
    out = (torch.stack(outs, dim=-1) * (1.0 / c)).to(fmap1.dtype)
    return out if negative_slope is None else F.leaky_relu(out, negative_slope)


def local_corr_vjp(fmap1: torch.Tensor, fmap2: torch.Tensor, radius: int,
                   g: torch.Tensor, out: Optional[torch.Tensor] = None,
                   negative_slope: Optional[float] = None):
    """The VJP of `local_corr`: g (B, H, W, (2r+1)^2) -> (dfmap1, dfmap2) in
    the maps' types, in f32 over the (2r+1)^2 shifts. With a slope, `out`
    is the forward's output: the slope is positive, so its sign is the
    pre-activation's, and g passes where out > 0 and is scaled by the slope
    elsewhere. fmap1's gradient sums each shift's cotangent times the
    shifted fmap2; fmap2's is the scatter of each cotangent times fmap1 back
    to the shifted place."""
    b, h, w, c = fmap1.shape
    r = radius
    gf = g.float()
    if negative_slope is not None:
        gf = torch.where(out > 0, gf, gf * negative_slope)
    gf = gf * (1.0 / c)
    f1 = fmap1.float()
    f2p = F.pad(fmap2.float(), (0, 0, r, r, r, r))
    df1 = torch.zeros_like(f1)
    df2p = torch.zeros_like(f2p)
    k = 0
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            gk = gf[..., k:k + 1]
            df1 += gk * f2p[:, dy:dy + h, dx:dx + w]
            df2p[:, dy:dy + h, dx:dx + w] += gk * f1
            k += 1
    return df1.to(fmap1.dtype), df2p[:, r:r + h, r:r + w].to(fmap2.dtype)


class _LocalCorr(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fmap1, fmap2, radius, negative_slope):
        out = _launch(fmap1, fmap2, radius, negative_slope)
        ctx.radius, ctx.slope = radius, negative_slope
        ctx.save_for_backward(fmap1, fmap2, None if negative_slope is None else out)
        return out

    @staticmethod
    def backward(ctx, g):
        fmap1, fmap2, out = ctx.saved_tensors
        df1, df2 = local_corr_vjp(fmap1, fmap2, ctx.radius, g.contiguous(), out, ctx.slope)
        return df1, df2, None, None


def local_corr(fmap1: torch.Tensor, fmap2: torch.Tensor, radius: int = 4,
               negative_slope: Optional[float] = None) -> torch.Tensor:
    """fmap1, fmap2: (B, H, W, C) of one type (bf16 or f32), contiguous on the
    card -> (B, H, W, (2r+1)^2) in that type; leaky_relu(·, negative_slope)
    of it where a slope is given. Differentiable in both maps
    (`local_corr_vjp`)."""
    return _LocalCorr.apply(fmap1, fmap2, radius, negative_slope)


def _launch(fmap1: torch.Tensor, fmap2: torch.Tensor, radius: int,
            negative_slope: Optional[float]) -> torch.Tensor:
    """The forward: the kernel on CUDA tensors, `local_corr_plain` on the
    CPU."""
    if fmap1.device.type == "cpu":
        return local_corr_plain(fmap1, fmap2, radius, negative_slope)
    if fmap1.device.type != "cuda":
        raise ValueError(f"local_corr: unsupported device {fmap1.device}")
    if not 1 <= radius <= MAX_RADIUS:
        raise ValueError(f"local_corr: radius 1 to {MAX_RADIUS}, got {radius}")
    if fmap1.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"local_corr: bf16 or f32, got {fmap1.dtype}")
    if fmap1.dim() != 4:
        raise ValueError(f"local_corr: expected (B, H, W, C), got {tuple(fmap1.shape)}")
    for t in (fmap1, fmap2):
        if (t.device != fmap1.device or t.dtype != fmap1.dtype
                or t.shape != fmap1.shape or not t.is_contiguous()):
            raise ValueError(
                f"local_corr: expected two contiguous {tuple(fmap1.shape)} "
                f"{fmap1.dtype} tensors on {fmap1.device}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}, strides {t.stride()}")
    b, h, w, c = fmap1.shape
    sms = torch.cuda.get_device_properties(fmap1.device).multi_processor_count
    p = plan(b, h, w, c, radius, fmap1.dtype, sms)
    out = torch.empty((b, h, w, (2 * radius + 1) ** 2), dtype=fmap1.dtype,
                      device=fmap1.device)
    err = _lib().ff_local_corr(
        fmap1.data_ptr(), fmap2.data_ptr(), out.data_ptr(), b, h, w, c, radius,
        int(fmap1.dtype == torch.bfloat16), p["rows"], p["ndy"], p["split"], p["warps"],
        p["chunk"], float(negative_slope or 0.0), int(negative_slope is not None),
        torch.cuda.current_stream(fmap1.device).cuda_stream)
    _build.check(err, "ff_local_corr")
    count_launch("local_corr", b, h, w, c, radius, str(fmap1.dtype), p["entry"],
                 "plain" if negative_slope is None else "leaky_relu")
    return out
