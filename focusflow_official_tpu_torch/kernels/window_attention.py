"""Kernel F: ws x ws window multi-head attention on natural-layout grids
(`csrc/window_attention.cu`, ws = 7).

q, k, v (B, Hp, Wp, C), Hp and Wp multiples of ws: each token attends to
the ws*ws tokens of its own window, per head (head h is the column slice
h*d:(h+1)*d), softmax in f32; the output keeps the layout and q's type.
The caller pads the grid before its q/k/v projections, so padded tokens
are ordinary (bias-carrying) keys. Every 7x7 window attention of the
FlowFormer path goes through here: Twins LSA and the vertical local layer.

`design(q, heads)` names the entry a CUDA call runs: "mma" (bf16, head
widths 16 or 32: every shape of the path) on the tensor cores, which
rounds the softmax weights to bf16 before the value sum and is held to
`bf16_bound`; "fma" (f32, or a head width of 8) on the f32 units.

`window_attention` is differentiable in q, k and v (a
`torch.autograd.Function`; q and k may come from one projection and v
from another, each takes its own gradient): its backward is
`window_attention_vjp`, plain PyTorch on every device, the VJP of
`window_attention_plain` in f32, as the JAX package's
`kernels/window_attention.py::_attention_bwd`, cast to the inputs' types.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, count_launch
from .attention import HEAD_DIMS, rounded_p_bound

_c = ctypes.c_void_p
_i = ctypes.c_int
WS = 7  # the window the kernel is built for


@functools.cache
def _lib():
    lib = _build.load("window_attention")
    lib.ff_window_attention.argtypes = [_c, _c, _c, _c] + [_i] * 5 + [
        ctypes.c_float, _i, _c]
    lib.ff_window_attention.restype = _i
    lib.ff_window_attention_entry.argtypes = [_i, _i]
    lib.ff_window_attention_entry.restype = _i
    return lib


def design(q: torch.Tensor, heads: int) -> str:
    """Which entry a call on this CUDA q runs, as the library itself decides
    it: "mma" (tensor cores) or "fma" (the per-query f32 loop)."""
    entry = _lib().ff_window_attention_entry(q.shape[-1] // heads,
                                             int(q.dtype == torch.bfloat16))
    return "mma" if entry == 1 else "fma"


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           ws: int, heads: int, scale: float) -> torch.Tensor:
    """Plain PyTorch version: window partition, einsum, f32 softmax,
    einsum, merge; q's type out."""
    b, hp, wp, c = q.shape
    d = c // heads
    nh, nw = hp // ws, wp // ws

    def windows(t):
        t = t.float().reshape(b, nh, ws, nw, ws, c).permute(0, 1, 3, 2, 4, 5)
        return t.reshape(b, nh * nw, ws * ws, heads, d)

    attn = torch.einsum("bwihd,bwjhd->bwhij", windows(q), windows(k)) * scale
    out = torch.einsum("bwhij,bwjhd->bwihd", torch.softmax(attn, dim=-1),
                       windows(v))
    out = out.reshape(b, nh, nw, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(b, hp, wp, c).to(q.dtype)


def bf16_bound(want: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor, heads: int, scale: float) -> torch.Tensor:
    """The bound on |tensor-core entry - plain version| at every output, for
    bf16 q, k, v, `want` being the plain version's output: E's
    (`attention.rounded_p_bound`) over the windows."""
    return rounded_p_bound(want, window_attention_plain(
        q.float(), k.float(), v.float().abs(), WS, heads, scale))


def window_attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ws: int,
                         heads: int, scale: float, g: torch.Tensor):
    """The VJP of `window_attention`: g (B, Hp, Wp, C) -> (dq, dk, dv), autograd
    through `window_attention_plain` on f32 copies, cast to each input's
    type."""
    with torch.enable_grad():
        qf, kf, vf = (t.detach().float().requires_grad_(True) for t in (q, k, v))
        out = window_attention_plain(qf, kf, vf, ws, heads, scale)
        grads = torch.autograd.grad(out, (qf, kf, vf), g.float())
    return tuple(d.to(t.dtype) for d, t in zip(grads, (q, k, v)))


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, ws, heads, scale):
        ctx.ws, ctx.heads, ctx.scale = ws, heads, scale
        ctx.save_for_backward(q, k, v)
        return _launch(q, k, v, ws, heads, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*window_attention_vjp(q, k, v, ctx.ws, ctx.heads, ctx.scale, g.contiguous()),
                None, None, None)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     ws: int, heads: int, scale: float) -> torch.Tensor:
    """q, k, v (B, Hp, Wp, C) of one type (bf16 or f32) -> (B, Hp, Wp, C).
    Differentiable in q, k and v (`window_attention_vjp`)."""
    return _WindowAttention.apply(q, k, v, ws, heads, scale)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ws: int, heads: int,
            scale: float) -> torch.Tensor:
    """The forward: the kernel on CUDA tensors, `window_attention_plain` on
    the CPU."""
    if q.dim() != 4 or q.shape[1] % ws or q.shape[2] % ws:
        raise ValueError(f"window_attention: (B, Hp, Wp, C) with Hp, Wp "
                         f"multiples of {ws}, got {tuple(q.shape)}")
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, ws, heads, scale)
    if q.device.type != "cuda":
        raise ValueError(f"window_attention: unsupported device {q.device}")
    b, hp, wp, c = q.shape
    if ws != WS:
        raise ValueError(f"window_attention: the kernel is built for ws={WS}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"window_attention: bf16 or f32, got {q.dtype}")
    if c % heads or c // heads not in HEAD_DIMS:
        raise ValueError(f"window_attention: head width C/heads = {c}/{heads} "
                         f"must be one of {HEAD_DIMS}")
    if c * q.element_size() % 16:  # every pixel row starts on a 16-byte boundary
        raise ValueError(f"window_attention: C * {q.element_size()} bytes must "
                         f"be a multiple of 16, got C={c}")
    for t in (q, k, v):
        if (t.device != q.device or t.dtype != q.dtype
                or t.shape != q.shape or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError("window_attention: q, k, v must be contiguous, "
                             f"16-byte aligned {tuple(q.shape)} {q.dtype} "
                             f"on {q.device}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = _lib().ff_window_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hp, wp,
        heads, c // heads, float(scale), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "ff_window_attention")
    count_launch("window_attention", b, hp, wp, c, heads, str(q.dtype),
                 design(q, heads))
    return out
