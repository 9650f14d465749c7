"""Kernel E: multi-head softmax attention with a small key/value side
(`csrc/attention.cu`).

q (B, N, C), k (B, M, C) and v (B, M, Cv) are the pre-head-split
projections; head h is the column slice h*d:(h+1)*d (d = C/heads, and
Cv/heads for v). out (B, N, Cv) = softmax(scale * q_h k_h^T) v_h per head,
scores, softmax and the value sum in f32, emitted in q's type. Every
non-window softmax attention of the FlowFormer path goes through here:
Twins GSA, the vertical global layer, the perceiver's input and latent
self-attention, and the decoder's cross-attend.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, launch_counts

_c = ctypes.c_void_p
_i = ctypes.c_int
HEAD_DIMS = (8, 16, 32)  # head widths the kernel is built for


@functools.cache
def _lib():
    lib = _build.load("attention")
    lib.ff_attention.argtypes = [_c, _c, _c, _c] + [_i] * 6 + [
        ctypes.c_float, _i, _c]
    lib.ff_attention.restype = _i
    return lib


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
    launch_counts["attention"] += 1
    return out
