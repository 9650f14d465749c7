"""Position encodings added to an NHWC feature map (FlowFormer's
`position_encoding.py`): the standard 2D sine encoding, the linear-
frequency sine encoding of the cost perceiver and learned row and column
embeddings. The JAX package defines them and wires them into no model; so
does the port.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.coords import coords_grid
from .latent_cost import linear_position_embedding_sine


class PositionEncodingSine(nn.Module):
    """x (B, H, W, d_model) + the sine encoding of each (x, y) position:
    channels 4i..4i+3 are sin x, cos x, sin y, cos y at frequency
    10000^(-4i / d_model), computed in f32."""

    def __init__(self, d_model: int = 256):
        super().__init__()
        self.d_model = d_model

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        d = self.d_model
        div = torch.exp(torch.arange(0, d // 2, 2, dtype=torch.float32, device=x.device)
                        * (-math.log(10000.0) / (d // 2)))
        xs = torch.arange(w, dtype=torch.float32, device=x.device)[:, None] * div
        ys = torch.arange(h, dtype=torch.float32, device=x.device)[:, None] * div
        pe = torch.stack([torch.sin(xs).expand(h, -1, -1), torch.cos(xs).expand(h, -1, -1),
                          torch.sin(ys)[:, None].expand(-1, w, -1),
                          torch.cos(ys)[:, None].expand(-1, w, -1)], dim=-1)
        return x + pe.reshape(h, w, d).to(x.dtype)


class LinearPositionEncoding(nn.Module):
    """x (B, H, W, C) + `linear_position_embedding_sine` of each (x, y)
    position at C channels."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w, c = x.shape[1:]
        enc = linear_position_embedding_sine(coords_grid(1, h, w, device=x.device), c)
        return x + enc.to(x.dtype)


class LearnedPositionEncoding(nn.Module):
    """x (B, H, W, d_model) + [col_embed[x], row_embed[y]], each half of the
    channels; H and W up to `max_size`. The tables are drawn from U[0, 1),
    as flax's `uniform(1.0)`."""

    def __init__(self, d_model: int = 256, max_size: int = 320):
        super().__init__()
        self.row_embed = nn.Parameter(torch.rand(max_size, d_model // 2))
        self.col_embed = nn.Parameter(torch.rand(max_size, d_model // 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        half = self.col_embed.shape[1]
        pe = torch.cat([self.col_embed[None, :w].expand(h, w, half),
                        self.row_embed[:h, None].expand(h, w, half)], dim=-1)
        return x + pe.to(x.dtype)
