"""Kernel E: multi-head softmax attention with a small key/value side
(`csrc/attention.cu`).

q (B, N, C), k (B, M, C) and v (B, M, Cv) are the pre-head-split
projections; head h is the column slice h*d:(h+1)*d (d = C/heads, and
Cv/heads for v). out (B, N, Cv) = softmax(scale * q_h k_h^T) v_h per head,
scores, softmax and the value sum in f32, emitted in q's type. Every
non-window softmax attention of the FlowFormer path goes through here:
Twins GSA, the vertical global layer, the perceiver's input and latent
self-attention, and the decoder's cross-attend.

On bf16 tensors with head widths 16 or 32 and N >= 64 the kernel runs on
the tensor cores and rounds the softmax weights to bf16 before the value
sum (the row sum is of the unrounded weights): against the plain version
that is up to 2^-8 relative on each weight (`bf16_bound` is the bound
that follows for the output). Elsewhere the weights stay f32.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, count_launch

_c = ctypes.c_void_p
_i = ctypes.c_int
HEAD_DIMS = (8, 16, 32)  # head widths the kernel is built for


@functools.cache
def _lib():
    lib = _build.load("attention")
    lib.ff_attention.argtypes = [_c, _c, _c, _c] + [_i] * 6 + [
        ctypes.c_float, _i, _c]
    lib.ff_attention.restype = _i
    lib.ff_attention_entry.argtypes = [_i] * 6
    lib.ff_attention_entry.restype = _i
    return lib


def design(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> str:
    """Which entry of the kernel a call on these CUDA tensors runs, as the
    library itself decides it: "mma" (tensor cores: bf16, head widths 16 or
    32, N >= 64) or "fma" (the per-query f32 loop)."""
    (b, n, c), m, cv = q.shape, k.shape[1], v.shape[2]
    entry = _lib().ff_attention_entry(b, n, m, c // heads, cv // heads,
                                      int(q.dtype == torch.bfloat16))
    return "mma" if entry == 2 else "fma"


def small_kv_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             heads: int, scale: float) -> torch.Tensor:
    """Plain PyTorch version: einsum, f32 softmax, einsum; q's type out."""
    b, n, c = q.shape
    m = k.shape[1]
    qh = q.reshape(b, n, heads, c // heads).float()
    kh = k.reshape(b, m, heads, c // heads).float()
    vh = v.reshape(b, m, heads, v.shape[-1] // heads).float()
    attn = torch.softmax(torch.einsum("bihd,bjhd->bhij", qh, kh) * scale, dim=-1)
    out = torch.einsum("bhij,bjhd->bihd", attn, vh)
    return out.reshape(b, n, v.shape[-1]).to(q.dtype)


def rounded_p_bound(want: torch.Tensor, on_abs_v: torch.Tensor) -> torch.Tensor:
    """The bound on |tensor-core entry - plain version| at every output of
    an attention whose softmax weights are rounded to bf16 before the value
    sum, from the plain version's output `want` and the plain version's
    output on |v| in f32 (`on_abs_v`) -> f32, want's shape. Rounding a
    weight to bf16 (8 significant bits) moves it by up to 2^-8 of itself,
    so output (n, c) moves by up to 2^-8 sum_j p_nj |v_jc|. Both sides then
    round an f32 result once, half a bf16 ulp each: one ulp at the largest
    size either can have there. 1e-6 stands for the f32 sums' own order.
    Kernel F's tensor-core entry is held to it too
    (`window_attention.bf16_bound`)."""
    moved = 2.0 ** -8 * on_abs_v
    top = want.float().abs() * (1 + 2.0 ** -8) + moved
    ulp = torch.exp2(torch.floor(torch.log2(top.clamp_min(1e-30))) - 7)
    return moved + ulp + 1e-6


def bf16_bound(want: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor, heads: int, scale: float) -> torch.Tensor:
    """`rounded_p_bound` for bf16 q, k, v of this kernel, `want` being the
    plain version's output."""
    return rounded_p_bound(want, small_kv_attention_plain(
        q.float(), k.float(), v.float().abs(), heads, scale))


def small_kv_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       heads: int, scale: float) -> torch.Tensor:
    """q (B, N, C), k (B, M, C), v (B, M, Cv) of one type (bf16 or f32)
    -> (B, N, Cv)."""
    if q.device.type == "cpu":
        return small_kv_attention_plain(q, k, v, heads, scale)
    if q.device.type != "cuda":
        raise ValueError(f"small_kv_attention: unsupported device {q.device}")
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("small_kv_attention: q, k, v must be (B, N, C)")
    b, n, c = q.shape
    m, cv = k.shape[1], v.shape[2]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"small_kv_attention: bf16 or f32, got {q.dtype}")
    if c % heads or cv % heads:
        raise ValueError(f"small_kv_attention: {heads} heads do not split "
                         f"C={c} and Cv={cv}")
    d, dv = c // heads, cv // heads
    if d not in HEAD_DIMS or dv not in HEAD_DIMS or m < 1:
        raise ValueError(f"small_kv_attention: head widths {d}, {dv} (built "
                         f"for {HEAD_DIMS}) and M={m} >= 1")
    for t, shape in ((k, (b, m, c)), (v, (b, m, cv))):
        if tuple(t.shape) != shape:
            raise ValueError(f"small_kv_attention: expected {shape}, got "
                             f"{tuple(t.shape)}")
    for t in (q, k, v):
        if (t.device != q.device or t.dtype != q.dtype or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError("small_kv_attention: q, k, v must be contiguous, "
                             f"16-byte aligned {q.dtype} on {q.device}")
    out = torch.empty((b, n, cv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    err = _lib().ff_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n, m,
        heads, d, dv, float(scale), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "ff_attention")
    count_launch("attention", b, n, m, c, cv, heads, str(q.dtype))
    return out
