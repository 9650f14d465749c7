"""Kernels C1 and C2: instance normalisation of NHWC tensors
(`csrc/instance_norm.cu`).

C1 `instance_norm_stats`: per (b, c) the f32 mean and
rsqrt(max(E[x^2] - mean^2, 0) + eps) over H*W, in one launch: `plan`
splits H*W into S slabs a sample, and the last block of a sample to finish
adds their partial sums in index order.
C2 `instance_norm_apply`: (x - mean) * inv in x's type, optional ReLU;
given a residual r of x's shape, relu(r + that) in the same launch (the
residual form, ResidualBlock's shortcut add), bit-equal to
`torch.relu(r + apply_plain(...))`.
`design(x, ...)` names the entry a CUDA call takes, for C1 and C2 alike:
"vector" (16-byte accesses: C a multiple of 8 in bf16 or 4 in f32, every
tensor 16-byte aligned) or "scalar".

`instance_norm_stats` and `instance_norm` are differentiable
(`torch.autograd.Function`s). Their backwards are plain PyTorch on every
device, the JAX package's VJPs (`kernels/instance_norm.py::_stats_bwd` and
`::_bwd`): `instance_norm_vjp` recomputes the stats in f32, with the
variance E[x^2] - mean^2 unclamped as the JAX VJP takes it (the forward
clamps it at 0; the two agree wherever the variance is positive), masks
the ReLU where x̂ > 0, and returns dx = inv·(g − mean(g) − x̂·mean(g·x̂));
the residual form relu(r + y) first takes its own mask, out > 0, which is
also the residual's gradient.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, count_launch, sm_count

_c = ctypes.c_void_p
_i = ctypes.c_int
ROWS_PER_BLOCK = 128  # the least rows a stats block takes, where there are enough
BLOCKS_PER_SM = 2  # what the stats aim at
NORMALIZE_BLOCKS_PER_SM = 8  # C2's grid cap: 8 blocks of 256 threads fill an SM


@functools.cache
def _lib():
    lib = _build.load("instance_norm")
    lib.ff_in_stats.argtypes = [_c, _c, _c, _c, _c, _i, _i, _i, _i,
                                ctypes.c_float, _i, _i, _c]
    lib.ff_in_stats.restype = _i
    lib.ff_in_normalize.argtypes = [_c, _c, _c, _c, _c, _i, _i, _i, _i, _i, _i, _i, _c]
    lib.ff_in_normalize.restype = _i
    return lib


# per (device, stream): the stats' per-sample tickets, zero between
# launches (the block that finishes a sample puts its counter back to 0).
# Launches on one stream run one after another, so they never share a
# counter that is in use; launches on two streams take two buffers.
_counters: dict[tuple[torch.device, int], torch.Tensor] = {}


def _tickets(device: torch.device, stream: int, b: int) -> torch.Tensor:
    t = _counters.get((device, stream))
    if t is None or t.numel() < b:
        t = torch.zeros(max(b, 64), dtype=torch.int32, device=device)
        _counters[(device, stream)] = t
    return t


def plan(hw: int, b: int, sms: int) -> int:
    """The stats' split S of a sample's H*W rows: BLOCKS_PER_SM blocks an
    SM over the B samples, no block under ROWS_PER_BLOCK rows where H*W
    allows it; block s takes rows [s * ceil(hw / S), (s + 1) * ceil(hw / S))."""
    return max(1, min(-(-hw // ROWS_PER_BLOCK), -(-BLOCKS_PER_SM * sms // max(b, 1))))


def vector_width(dtype: torch.dtype) -> int:
    """Values in one 16-byte access of the vector entries."""
    return 16 // (2 if dtype == torch.bfloat16 else 4)


def design(*tensors: torch.Tensor) -> str:
    """The entry that NHWC tensors of one type take on the card (C1: x;
    C2: x and its residual, if any): "vector" where C is a multiple of
    `vector_width` and every tensor starts on a 16-byte boundary, else
    "scalar"."""
    ok = all(t.shape[-1] % vector_width(t.dtype) == 0 and t.data_ptr() % 16 == 0
             for t in tensors)
    return "vector" if ok else "scalar"


def stats_plain(x: torch.Tensor, eps: float = 1e-5):
    """Plain PyTorch C1: NHWC x -> (mean, inv), each (B, C) f32."""
    xf = x.float()
    mean = xf.mean(dim=(1, 2))
    var = torch.clamp((xf * xf).mean(dim=(1, 2)) - mean * mean, min=0.0)
    return mean, torch.rsqrt(var + eps)


def apply_plain(x: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
                relu: bool, residual: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch C2: (x - mean) * inv in x's type, ReLU'd if `relu`;
    with `residual`, torch.relu(residual + that)."""
    d = x.dtype
    y = (x - mean[:, None, None, :].to(d)) * inv[:, None, None, :].to(d)
    if relu:
        y = torch.relu(y)
    return y if residual is None else torch.relu(residual + y)


def _check_x(x: torch.Tensor, what: str) -> None:
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous NHWC, got "
                         f"{tuple(x.shape)} strides {x.stride()}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: x must be bf16 or f32, got {x.dtype}")


def stats_vjp(x: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
              gmean: torch.Tensor, ginv: torch.Tensor) -> torch.Tensor:
    """The stats' VJP: d mean / dx = 1/N, d inv / dx = -inv^3 (x - mean) / N
    -> dx in x's type."""
    n = x.shape[1] * x.shape[2]
    col = lambda t: t[:, None, None, :]
    dx = col(gmean) / n - col(ginv) * col(inv) ** 3 * (x.float() - col(mean)) / n
    return dx.to(x.dtype)


def instance_norm_vjp(x: torch.Tensor, g: torch.Tensor, eps: float,
                      relu: bool) -> torch.Tensor:
    """The VJP of (x - mean)·inv [ReLU'd] -> dx in x's type, the stats
    recomputed in f32 with the variance unclamped."""
    xf, gf = x.float(), g.float()
    mean = xf.mean((1, 2), keepdim=True)
    var = (xf * xf).mean((1, 2), keepdim=True) - mean * mean
    inv = torch.rsqrt(var + eps)
    xhat = (xf - mean) * inv
    if relu:
        gf = gf * (xhat > 0)
    gm = gf.mean((1, 2), keepdim=True)
    gxm = (gf * xhat).mean((1, 2), keepdim=True)
    return (inv * (gf - gm - xhat * gxm)).to(x.dtype)


class _Stats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, eps):
        mean, inv = _stats_launch(x, eps)
        ctx.save_for_backward(x, mean, inv)
        return mean, inv

    @staticmethod
    def backward(ctx, gmean, ginv):
        return stats_vjp(*ctx.saved_tensors, gmean, ginv), None


class _InstanceNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, eps, relu, residual):
        mean, inv = _stats_launch(x, eps)
        y = instance_norm_apply(x, mean, inv, relu, residual)
        ctx.eps, ctx.relu, ctx.residual = eps, relu, residual is not None
        ctx.save_for_backward(x, y if residual is not None else None)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        dr = None
        if ctx.residual:  # out = relu(r + z): out > 0 passes to r and to z
            g = dr = torch.where(y > 0, g, torch.zeros_like(g))
        return instance_norm_vjp(x, g, ctx.eps, ctx.relu), None, None, dr


def instance_norm_stats(x: torch.Tensor, eps: float = 1e-5):
    """NHWC x (B, H, W, C) -> (mean, inv), each (B, C) f32. Differentiable
    (`stats_vjp`)."""
    return _Stats.apply(x, eps)


def _stats_launch(x: torch.Tensor, eps: float):
    """C1: the kernel on a CUDA tensor, `stats_plain` on the CPU."""
    if x.device.type == "cpu":
        return stats_plain(x, eps)
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm_stats: unsupported device {x.device}")
    _check_x(x, "instance_norm_stats")
    b, h, w, c = x.shape
    hw = h * w
    splits = plan(hw, b, sm_count(x.device))
    entry = design(x)
    partial = torch.empty((b, splits, 2, c), dtype=torch.float32, device=x.device)
    mean = torch.empty((b, c), dtype=torch.float32, device=x.device)
    inv = torch.empty_like(mean)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().ff_in_stats(x.data_ptr(), partial.data_ptr(), mean.data_ptr(),
                             inv.data_ptr(), _tickets(x.device, stream, b).data_ptr(),
                             b, hw, c, splits, eps, int(x.dtype == torch.bfloat16),
                             int(entry == "vector"), stream)
    _build.check(err, "ff_in_stats")
    count_launch("in_stats", b, h, w, c, str(x.dtype), splits, entry)
    return mean, inv


def instance_norm_apply(x: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
                        relu: bool = False,
                        residual: torch.Tensor | None = None) -> torch.Tensor:
    """NHWC x and (B, C) f32 stats -> (x - mean) * inv [ReLU'd], x's type;
    with an NHWC `residual` of x's shape and type, relu(residual + that).
    Not differentiable: `instance_norm` is the differentiable whole."""
    if x.device.type == "cpu":
        return apply_plain(x, mean, inv, relu, residual)
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm_apply: unsupported device {x.device}")
    _check_x(x, "instance_norm_apply")
    b, h, w, c = x.shape
    for t in (mean, inv):
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != (b, c) or not t.is_contiguous()):
            raise ValueError("instance_norm_apply: stats must be contiguous "
                             f"(B, C) f32 on {x.device}")
    if residual is not None and (
            residual.device != x.device or residual.dtype != x.dtype
            or residual.shape != x.shape or not residual.is_contiguous()):
        raise ValueError(
            "instance_norm_apply: the residual must be a contiguous NHWC "
            f"{tuple(x.shape)} {x.dtype} tensor on {x.device} (the NHWC view of "
            f"a channels_last tensor), got {tuple(residual.shape)} "
            f"{residual.dtype} on {residual.device}, strides {residual.stride()}")
    y = torch.empty_like(x)
    entry = design(x) if residual is None else design(x, residual)
    err = _lib().ff_in_normalize(
        x.data_ptr(), mean.data_ptr(), inv.data_ptr(),
        0 if residual is None else residual.data_ptr(), y.data_ptr(), b, h * w, c,
        int(relu), int(x.dtype == torch.bfloat16), int(entry == "vector"),
        NORMALIZE_BLOCKS_PER_SM * sm_count(x.device),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ff_in_normalize")
    count_launch("in_normalize", b, h, w, c, str(x.dtype), entry,
                 "plain" if residual is None else "residual")
    return y


def instance_norm(x: torch.Tensor, eps: float = 1e-5, relu: bool = False,
                  residual: torch.Tensor | None = None) -> torch.Tensor:
    """Instance norm of NHWC x: C1, then C2 (with `residual`: its residual
    form). Differentiable in x and the residual (`instance_norm_vjp`)."""
    return _InstanceNorm.apply(x, eps, relu, residual)
