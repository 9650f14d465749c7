"""The attention front end's mask-image transformer block: channel
(Restormer-style) mutual attention, where the tokens are the channels and
the features are the H*W positions.

Modules take NCHW-indexed tensors and return them in the input's type.
The normalisations, the L2 norms over H*W, the (C, C) score product, the
softmax and the product with v run in f32 (the JAX package takes its two
products at full precision), whatever the compute type.

- `ChannelLayerNorm`: LayerNorm over the channels of each position (the
  WithBias form, or BiasFree: no mean subtracted, no bias), eps 1e-5,
  biased variance;
- `MutualAttention`: q from x, k and v from y (1x1 convs, no bias), each
  head's q and k rows L2-normalised over H*W, softmax(q k^T * temperature)
  v, then a 1x1 `project_out`;
- `Mlp`: fc1, GELU (tanh in bf16, erf in f32, as `nn/twins.py::gelu`),
  fc2, over the channels;
- `MaskImageChannelAttentionTransformerBlock(mask, image)`: image +
  attn(norm1_mask(mask), norm1_image(image)), then + ffn(norm2(...)).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .twins import gelu


class ChannelLayerNorm(nn.Module):
    def __init__(self, dim: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.var(dim=1, unbiased=False, keepdim=True)
        col = lambda t: t[None, :, None, None]
        if self.bias is None:
            out = xf / torch.sqrt(var + 1e-5) * col(self.weight)
        else:
            out = ((xf - xf.mean(dim=1, keepdim=True)) / torch.sqrt(var + 1e-5)
                   * col(self.weight) + col(self.bias))
        return out.to(x.dtype)


class MutualAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, bias: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        for name in ("q", "k", "v", "project_out"):
            self.add_module(name, nn.Conv2d(dim, dim, 1, bias=bias))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        heads = lambda t: t.float().reshape(b, self.num_heads, c // self.num_heads, h * w)
        q, k, v = heads(self.q(x)), heads(self.k(y)), heads(self.v(y))
        q = F.normalize(q, dim=-1, eps=1e-12)
        k = F.normalize(k, dim=-1, eps=1e-12)
        attn = torch.softmax(q @ k.transpose(-2, -1) * self.temperature, dim=-1)
        out = (attn @ v).reshape(b, c, h, w).to(x.dtype)
        return self.project_out(out)


class Mlp(nn.Module):
    def __init__(self, in_features: int, hidden_features: int):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, in_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., in_features), channels last."""
        return self.fc2(gelu(self.fc1(x)))


class MaskImageChannelAttentionTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, ffn_expansion_factor: int = 2,
                 bias: bool = False):
        super().__init__()
        self.attn = MutualAttention(dim, num_heads, bias)
        self.norm1_mask_body = ChannelLayerNorm(dim)
        self.norm1_image_body = ChannelLayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.ffn = Mlp(dim, int(dim * ffn_expansion_factor))

    def forward(self, mask: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
        fused = image + self.attn(self.norm1_mask_body(mask), self.norm1_image_body(image))
        f = fused.permute(0, 2, 3, 1)  # channels last for the LayerNorm and the MLP
        normed = F.layer_norm(f.float(), f.shape[-1:], self.norm2.weight, self.norm2.bias,
                              self.norm2.eps).to(f.dtype)
        return (f + self.ffn(normed)).permute(0, 3, 1, 2)
