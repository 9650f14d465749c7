"""Kernel D: PWC-Net's local correlation (`csrc/local_corr.cu`).

out[b, y, x, (dy+r)(2r+1) + (dx+r)] = mean_c f1[b, y, x, c] * f2[b, y+dy, x+dx, c]
for dy, dx in [-r, r], zero outside f2, channels dy-major, NHWC in and out.
Products are summed in f32; the output has the inputs' type.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build, count_launch

_c = ctypes.c_void_p
_i = ctypes.c_int
MAX_RADIUS = 4  # the radii `csrc/local_corr.cu` is built for


@functools.cache
def _lib():
    lib = _build.load("local_corr")
    lib.ff_local_corr.argtypes = [_c, _c, _c] + [_i] * 6 + [_c]
    lib.ff_local_corr.restype = _i
    return lib


def local_corr_plain(fmap1: torch.Tensor, fmap2: torch.Tensor,
                     radius: int = 4) -> torch.Tensor:
    """Plain PyTorch version: (2r+1)^2 shifted products of f32 copies, each
    summed over channels and scaled by 1/C, cast to fmap1's type."""
    b, h, w, c = fmap1.shape
    r = radius
    f1 = fmap1.float()
    f2p = F.pad(fmap2.float(), (0, 0, r, r, r, r))
    outs = [(f1 * f2p[:, dy:dy + h, dx:dx + w]).sum(-1)
            for dy in range(2 * r + 1) for dx in range(2 * r + 1)]
    return (torch.stack(outs, dim=-1) * (1.0 / c)).to(fmap1.dtype)


def local_corr(fmap1: torch.Tensor, fmap2: torch.Tensor,
               radius: int = 4) -> torch.Tensor:
    """fmap1, fmap2: (B, H, W, C) of one type (bf16 or f32), contiguous on the
    card -> (B, H, W, (2r+1)^2) in that type."""
    if fmap1.device.type == "cpu":
        return local_corr_plain(fmap1, fmap2, radius)
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
    out = torch.empty((b, h, w, (2 * radius + 1) ** 2), dtype=fmap1.dtype,
                      device=fmap1.device)
    err = _lib().ff_local_corr(
        fmap1.data_ptr(), fmap2.data_ptr(), out.data_ptr(), b, h, w, c, radius,
        int(fmap1.dtype == torch.bfloat16),
        torch.cuda.current_stream(fmap1.device).cuda_stream)
    _build.check(err, "ff_local_corr")
    count_launch("local_corr", b, h, w, c, radius, str(fmap1.dtype))
    return out
