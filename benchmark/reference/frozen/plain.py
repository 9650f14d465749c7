"""The plain PyTorch versions of the port's kernels, frozen: each is what
the port runs on a CPU tensor in place of its CUDA kernel (A: `lookup`,
B: `fold`, G: `lookup_fold`, C1 and C2: `instance_norm`, E:
`small_kv_attention`, F: `window_attention`), and 2x2 average pooling.
Gradients are autograd's through these.
"""

from __future__ import annotations

from typing import Sequence

import torch


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


def fold_plain(a: torch.Tensor, w: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (M, K) @ (N, K).T + bias in f32, cast to a's type."""
    return (a.float() @ w.float().t() + bias.float()).to(a.dtype)


def lookup_fold_plain(levels: Sequence[torch.Tensor], coords: torch.Tensor,
                      radius: int, weight: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: `fold_plain(lookup_plain(...))`, the window
    cast to the weight's type between the two."""
    b, h, w, _ = coords.shape
    window = lookup_plain(levels, coords, radius)
    out = fold_plain(window.reshape(b * h * w, -1).to(weight.dtype), weight, bias)
    return out.reshape(b, h, w, -1)


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


def instance_norm(x: torch.Tensor, eps: float = 1e-5, relu: bool = False,
                  residual: torch.Tensor | None = None) -> torch.Tensor:
    """Instance norm of NHWC x: C1's statistics, then C2."""
    mean, inv = stats_plain(x, eps)
    return apply_plain(x, mean, inv, relu, residual)


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


def avg_pool2x2(x: torch.Tensor) -> torch.Tensor:
    """Average-pool the two trailing axes of (..., H, W)."""
    h, w = x.shape[-2], x.shape[-1]
    nh, nw = h // 2, w // 2
    x = x[..., :nh * 2, :nw * 2]
    return x.reshape(*x.shape[:-2], nh, 2, nw, 2).mean(dim=(-3, -1))
