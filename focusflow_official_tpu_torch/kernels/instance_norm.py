"""Kernels C1 and C2: instance normalisation of NHWC tensors
(`csrc/instance_norm.cu`).

C1 `instance_norm_stats`: per (b, c) the f32 mean and
rsqrt(max(E[x^2] - mean^2, 0) + eps) over H*W.
C2 `instance_norm_apply`: (x - mean) * inv in x's type, optional ReLU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, count_launch

_c = ctypes.c_void_p
_i = ctypes.c_int
_SMS = 132  # H100 SXM streaming multiprocessors: the stats aim at 2 blocks each


@functools.cache
def _lib():
    lib = _build.load("instance_norm")
    lib.ff_in_stats.argtypes = [_c, _c, _c, _c, _i, _i, _i, _i,
                                ctypes.c_float, _i, _c]
    lib.ff_in_stats.restype = _i
    lib.ff_in_normalize.argtypes = [_c, _c, _c, _c, _i, _i, _i, _i, _i, _c]
    lib.ff_in_normalize.restype = _i
    return lib


def stats_plain(x: torch.Tensor, eps: float = 1e-5):
    """Plain PyTorch C1: NHWC x -> (mean, inv), each (B, C) f32."""
    xf = x.float()
    mean = xf.mean(dim=(1, 2))
    var = torch.clamp((xf * xf).mean(dim=(1, 2)) - mean * mean, min=0.0)
    return mean, torch.rsqrt(var + eps)


def apply_plain(x: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
                relu: bool) -> torch.Tensor:
    """Plain PyTorch C2: (x - mean) * inv in x's type."""
    d = x.dtype
    y = (x - mean[:, None, None, :].to(d)) * inv[:, None, None, :].to(d)
    return torch.relu(y) if relu else y


def _check_x(x: torch.Tensor, what: str) -> None:
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous NHWC, got "
                         f"{tuple(x.shape)} strides {x.stride()}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: x must be bf16 or f32, got {x.dtype}")


def instance_norm_stats(x: torch.Tensor, eps: float = 1e-5):
    """NHWC x (B, H, W, C) -> (mean, inv), each (B, C) f32."""
    if x.device.type == "cpu":
        return stats_plain(x, eps)
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm_stats: unsupported device {x.device}")
    _check_x(x, "instance_norm_stats")
    b, h, w, c = x.shape
    hw = h * w
    splits = max(1, min(-(-hw // 256), -(-2 * _SMS // max(b, 1))))
    partial = torch.empty((b, splits, 2, c), dtype=torch.float32, device=x.device)
    mean = torch.empty((b, c), dtype=torch.float32, device=x.device)
    inv = torch.empty_like(mean)
    err = _lib().ff_in_stats(x.data_ptr(), partial.data_ptr(), mean.data_ptr(),
                             inv.data_ptr(), b, hw, c, splits, eps,
                             int(x.dtype == torch.bfloat16),
                             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ff_in_stats")
    count_launch("in_stats", b, h, w, c, str(x.dtype))
    return mean, inv


def instance_norm_apply(x: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
                        relu: bool = False) -> torch.Tensor:
    """NHWC x and (B, C) f32 stats -> (x - mean) * inv [ReLU'd], x's type."""
    if x.device.type == "cpu":
        return apply_plain(x, mean, inv, relu)
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm_apply: unsupported device {x.device}")
    _check_x(x, "instance_norm_apply")
    b, h, w, c = x.shape
    for t in (mean, inv):
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != (b, c) or not t.is_contiguous()):
            raise ValueError("instance_norm_apply: stats must be contiguous "
                             f"(B, C) f32 on {x.device}")
    y = torch.empty_like(x)
    err = _lib().ff_in_normalize(x.data_ptr(), mean.data_ptr(), inv.data_ptr(),
                                 y.data_ptr(), b, h * w, c, int(relu),
                                 int(x.dtype == torch.bfloat16),
                                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ff_in_normalize")
    count_launch("in_normalize", b, h, w, c, str(x.dtype))
    return y


def instance_norm(x: torch.Tensor, eps: float = 1e-5,
                  relu: bool = False) -> torch.Tensor:
    """Instance norm of NHWC x: C1, then C2."""
    mean, inv = instance_norm_stats(x, eps)
    return instance_norm_apply(x, mean, inv, relu)
