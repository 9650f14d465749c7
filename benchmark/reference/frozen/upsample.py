"""Convex (learned) 8x flow upsampling (NHWC).

Each fine pixel is a softmax-convex combination of the 3x3 coarse
neighbourhood of 8x the coarse flow. The mask's channel layout is (k, a, b)
row-major: neighbour k = ki*3 + kj at offset (ki-1, kj-1), subpixel a*8 + b.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor,
                    factor: int = 8) -> torch.Tensor:
    """(B, H, W, 2) flow and (B, H, W, 9*f*f) logits -> (B, f*H, f*W, 2)."""
    b, h, w, _ = flow.shape
    f = factor
    m = torch.softmax(mask.reshape(b, h, w, 9, f * f), dim=3)
    fp = F.pad((flow * float(f)).permute(0, 3, 1, 2), (1, 1, 1, 1))
    fp = fp.permute(0, 2, 3, 1)  # (B, H+2, W+2, 2)
    acc_x = torch.zeros((b, h, w, f * f), dtype=m.dtype, device=m.device)
    acc_y = torch.zeros_like(acc_x)
    for k in range(9):
        ki, kj = divmod(k, 3)
        nb = fp[:, ki:ki + h, kj:kj + w, :]
        wk = m[:, :, :, k, :]
        acc_x = acc_x + wk * nb[..., 0:1]
        acc_y = acc_y + wk * nb[..., 1:2]
    return depth_to_space_flow(torch.stack([acc_x, acc_y], dim=-1), f)


def depth_to_space_flow(up: torch.Tensor, factor: int = 8) -> torch.Tensor:
    """(..., H, W, f*f, C) -> (..., f*H, f*W, C), subpixel s = a*f + b at
    row a, column b of its f x f block."""
    *lead, h, w, _, c = up.shape
    f, n = factor, len(lead)
    up = up.reshape(*lead, h, w, f, f, c)
    perm = (*range(n), n, n + 2, n + 1, n + 3, n + 4)
    return up.permute(perm).reshape(*lead, f * h, f * w, c)
