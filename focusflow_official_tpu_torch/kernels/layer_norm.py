"""LayerNorm over the last axis in the input's own type
(`csrc/layer_norm.cu`).

`layer_norm(x, weight, bias, eps)` is `layer_norm_plain`'s function: the
mean and biased variance of each row in f32, rstd = rsqrt(var + eps),
weight * (rstd * (x - mean)) + bias rounded to x's type (bf16 or f32).
On the card one launch reads x in its type and writes y in it; weight and
bias are read in theirs. It replaces no TPU kernel (XLA fuses LayerNorm
on the TPU): the port's form before it, a cast to f32, `F.layer_norm` and
a cast back, moved 20 bytes an element where the kernel moves 4 (bf16).

`design(x)` names the entry a CUDA call takes: "vector" (16-byte
accesses: C a whole number of 16-byte vectors, at most `MAX_VECTORS`,
and x 16-byte aligned) or "scalar".

Where autograd records the call, it is a `torch.autograd.Function`: the
forward also writes the per-row f32 mean and rstd and saves them with x in
its own type; the backward (`layer_norm_vjp`) is plain PyTorch on every
device, the work autograd does through the plain version:
`native_layer_norm_backward` on f32 copies of g and x with the saved
statistics, each gradient cast back to its input's type. CPU tensors take
the plain version.

A launch is counted in `launch_counts["layer_norm"]` and not in
`launch_shapes`, whose keys the benchmark's roofline
(`benchmark/harness/roofline.py::work`) prices one by one.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build, launch_counts, sm_count

_c = ctypes.c_void_p
_i = ctypes.c_int
MAX_VECTORS = 128  # 16-byte vectors a row of the vector entry: 32 lanes x 4


@functools.cache
def _lib():
    lib = _build.load("layer_norm")
    lib.ff_layer_norm.argtypes = [_c, _c, _c, _c, _c, _c, ctypes.c_longlong, _i,
                                  ctypes.c_float, _i, _i, _i, _i, _c]
    lib.ff_layer_norm.restype = _i
    return lib


def design(x: torch.Tensor) -> str:
    """The entry a contiguous CUDA `x` takes: "vector" where its rows are a
    whole number of 16-byte vectors, at most `MAX_VECTORS` of them, and it
    starts on a 16-byte boundary (y, freshly allocated, always does), else
    "scalar"."""
    row = x.shape[-1] * x.element_size()
    ok = row % 16 == 0 and row // 16 <= MAX_VECTORS and x.data_ptr() % 16 == 0
    return "vector" if ok else "scalar"


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """Plain PyTorch: `F.layer_norm` in f32, the result in x's type."""
    y = F.layer_norm(x.float(), x.shape[-1:], weight.float(), bias.float(), eps)
    return y.to(x.dtype)


def layer_norm_vjp(g: torch.Tensor, x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                   weight: torch.Tensor, bias: torch.Tensor, needs=(True, True, True)):
    """The VJP of `layer_norm_plain` given the forward's f32 `mean` and
    `rstd` (x.shape[:-1] + (1,)) -> (dx, dweight, dbias), each in its
    input's type, None where `needs` says no."""
    grads = torch.ops.aten.native_layer_norm_backward(
        g.float(), x.float(), x.shape[-1:], mean, rstd, weight.float(), bias.float(),
        list(needs))
    return tuple(None if d is None else d.to(t.dtype)
                 for d, t in zip(grads, (x, weight, bias)))


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> None:
    c = x.shape[-1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"layer_norm: x must be bf16 or f32, got {x.dtype}")
    for name, t in (("weight", weight), ("bias", bias)):
        if (t.device != x.device or t.dtype not in (torch.bfloat16, torch.float32)
                or tuple(t.shape) != (c,) or not t.is_contiguous()):
            raise ValueError(f"layer_norm: {name} must be a contiguous ({c},) bf16 or f32 "
                             f"tensor on {x.device}, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
    if weight.dtype != bias.dtype:
        raise ValueError(f"layer_norm: weight {weight.dtype} and bias {bias.dtype} must "
                         "share a type")


def _rows(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
          stats: bool):
    """-> (y in x's type, and with `stats` the f32 mean and rstd of shape
    x.shape[:-1] + (1,), else None and None): the kernel on a CUDA tensor,
    `native_layer_norm` in f32 on the CPU (the plain version's op)."""
    if x.device.type == "cpu":
        y, mean, rstd = torch.ops.aten.native_layer_norm(
            x.float(), x.shape[-1:], weight.float(), bias.float(), eps)
        return (y.to(x.dtype), mean, rstd) if stats else (y.to(x.dtype), None, None)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: unsupported device {x.device}")
    _check(x, weight, bias)
    x = x.contiguous()
    c = x.shape[-1]
    y = torch.empty_like(x)
    mean = rstd = None
    if stats:
        mean = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mean)
    err = _lib().ff_layer_norm(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
        0 if mean is None else mean.data_ptr(), 0 if rstd is None else rstd.data_ptr(),
        x.numel() // max(c, 1), c, eps, int(x.dtype == torch.bfloat16),
        int(weight.dtype == torch.bfloat16),
        int(design(x) == "vector"), sm_count(x.device),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ff_layer_norm")
    launch_counts["layer_norm"] += 1
    return y, mean, rstd


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        y, mean, rstd = _rows(x, weight, bias, eps, stats=True)
        ctx.save_for_backward(x, mean, rstd, weight, bias)
        return y

    @staticmethod
    def backward(ctx, g):
        x, mean, rstd, weight, bias = ctx.saved_tensors
        return (*layer_norm_vjp(g, x, mean, rstd, weight, bias, ctx.needs_input_grad[:3]),
                None)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm of x's last axis, statistics in f32, output in x's type:
    the kernel for CUDA tensors, `layer_norm_plain` on the CPU.
    Differentiable in x, weight and bias (`layer_norm_vjp`)."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _LayerNorm.apply(x, weight, bias, eps)
    return _rows(x, weight, bias, eps, stats=False)[0]
