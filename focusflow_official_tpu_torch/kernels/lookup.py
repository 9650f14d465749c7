"""Kernel A: the correlation-pyramid window lookup (`csrc/lookup.cu`).

For each level l the bilinear (2r+1)^2 window of corr_l around coords/2^l,
zero outside the level, channels in the reference order (x-offset slow,
levels fine to coarse). Taps are summed in f32 and the output takes the
levels' type: bf16 levels give the f32 sum rounded once, the bits of the
f32 result cast to bf16.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from . import _build, count_launch

_c = ctypes.c_void_p
_i = ctypes.c_int
RADII = (3, 4)  # the radii `csrc/lookup.cuh::with_radius` builds


@functools.cache
def _lib():
    lib = _build.load("lookup")
    lib.ff_lookup.argtypes = [_c, _c, _c, _c] + [_i] * 9 + [
        _c, _c, ctypes.c_longlong, _i, _i, _c]
    lib.ff_lookup.restype = _i
    lib.ff_lookup_units_per_block.restype = _i
    return lib


def units_per_block() -> int:
    """The (query, level) units a block of the kernel takes, as built."""
    return _lib().ff_lookup_units_per_block()


def _lookup_level_plain(corr_l: torch.Tensor, coords: torch.Tensor,
                        radius: int) -> torch.Tensor:
    """One level: corr_l (B, Q, H2, W2), coords (B, Q, 2) at this level's
    scale -> (B, Q, (2r+1)^2) f32."""
    b, q, h2, w2 = corr_l.shape
    k = 2 * radius + 1
    d = torch.linspace(-radius, radius, k, dtype=torch.float32,
                       device=coords.device)
    dx = d.repeat_interleave(k)  # x-offset, slow axis (reference quirk)
    dy = d.repeat(k)
    cx = coords[..., 0:1] + dx
    cy = coords[..., 1:2] + dy
    x0 = torch.floor(cx)
    y0 = torch.floor(cy)
    wx1 = cx - x0
    wy1 = cy - y0
    corr_flat = corr_l.reshape(b, q, h2 * w2).float()

    def tap(xi, yi, wgt):
        valid = (xi >= 0) & (xi <= w2 - 1) & (yi >= 0) & (yi <= h2 - 1)
        idx = (yi.clamp(0, h2 - 1) * w2 + xi.clamp(0, w2 - 1)).long()
        vals = torch.gather(corr_flat, 2, idx)
        return vals * torch.where(valid, wgt, torch.zeros_like(wgt))

    return (tap(x0, y0, (1 - wx1) * (1 - wy1))
            + tap(x0 + 1, y0, wx1 * (1 - wy1))
            + tap(x0, y0 + 1, (1 - wx1) * wy1)
            + tap(x0 + 1, y0 + 1, wx1 * wy1))


def lookup_plain(levels: Sequence[torch.Tensor], coords: torch.Tensor,
                 radius: int) -> torch.Tensor:
    """Plain PyTorch version: (B, H1, W1, L*(2r+1)^2), summed in f32 and cast
    to the levels' type."""
    b, h1, w1, _ = coords.shape
    c = coords.reshape(b, h1 * w1, 2).float()
    outs = [_lookup_level_plain(corr_l, c / (2.0 ** i), radius)
            for i, corr_l in enumerate(levels)]
    return torch.cat(outs, dim=-1).reshape(b, h1, w1, -1).to(levels[0].dtype)


def lookup(levels: Sequence[torch.Tensor], coords: torch.Tensor,
           radius: int) -> torch.Tensor:
    """levels: up to 4 (B, H1*W1, H2_l, W2_l) volumes of one type (bf16 or
    f32); coords: (B, H1, W1, 2) f32 level-0 (x, y) -> (B, H1, W1, L*K2) in
    the levels' type."""
    if coords.device.type == "cpu":
        return lookup_plain(levels, coords, radius)
    if coords.device.type != "cuda":
        raise ValueError(f"lookup: unsupported device {coords.device}")
    b, h1, w1, two = coords.shape
    q = h1 * w1
    nl = len(levels)
    if (two != 2 or coords.dtype != torch.float32 or not coords.is_contiguous()
            or coords.data_ptr() % 8):
        raise ValueError("lookup: coords must be contiguous f32 (B, H, W, 2), "
                         "8-byte aligned")
    if not 1 <= nl <= 4:
        raise ValueError(f"lookup: 1 to 4 levels, got {nl}")
    if radius not in RADII:
        raise ValueError(f"lookup: radius {RADII}, got {radius}")
    if b * q * nl >= 2 ** 31:
        raise ValueError(f"lookup: {b * q} queries x {nl} levels is 2^31 or more")
    dt = levels[0].dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"lookup: levels must be bf16 or f32, got {dt}")
    dims = []
    for lv in levels:
        if (lv.device != coords.device or lv.dtype != dt or lv.dim() != 4
                or lv.shape[:2] != (b, q) or not lv.is_contiguous()):
            raise ValueError(
                f"lookup: level {tuple(lv.shape)} {lv.dtype} {lv.device} does "
                f"not fit coords {tuple(coords.shape)} (contiguous (B, Q, H, W))")
        dims += [lv.shape[2], lv.shape[3]]
    k2 = (2 * radius + 1) ** 2
    out = torch.empty((b, h1, w1, nl * k2), dtype=dt, device=coords.device)
    ptrs = [lv.data_ptr() for lv in levels] + [0] * (4 - nl)
    dims += [0] * (8 - len(dims))
    err = _lib().ff_lookup(
        *ptrs, *dims, nl, coords.data_ptr(), out.data_ptr(), b * q, radius,
        int(dt == torch.bfloat16), torch.cuda.current_stream(coords.device).cuda_stream)
    _build.check(err, "ff_lookup")
    count_launch("lookup", b, q, *dims[:2 * nl], str(dt))
    return out
