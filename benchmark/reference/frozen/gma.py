"""GMA (global motion aggregation) and FlowFormer's update block, frozen
from the port's `nn/gma.py`.

- `GMAAttention`: a content-only (B, heads, Q, Q) softmax map over the
  context features, taken in f32 and stored in the compute type; its
  relative-position tables are parameters the forward never reads, kept so
  checkpoints load strict;
- `GMAAggregate`: the map applied to the motion features, plus a learned
  `gamma` times the result;
- `FFBasicMotionEncoder`: the motion encoder over (cost_global, window),
  with convc1 split: the 81-wide window half through kernel B (it carries
  the bias) and the 64-wide global half as a matrix product; in the
  only-global form (`cor_planes` equal to the global cost's width) convc1
  reads cost_global alone, a matrix product, and takes no window;
- `GMAUpdateBlock`: encoder, aggregator, SepConvGRU, flow head, mask head.

Inside the decoder loop the hidden state and context are NCHW-indexed
(`channels_last` on the card), as in the RAFT update block.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .plain import fold_plain as fold
from .twins import conv1x1_nhwc
from .update import FlowHead, SepConvGRU


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class GMAAttention(nn.Module):
    def __init__(self, dim: int, heads: int = 1, dim_head: int = 128,
                 max_pos_size: int = 160):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_qk = nn.Conv2d(dim, 2 * inner, 1, bias=False)
        self.pos_emb_rel_height = nn.Parameter(torch.zeros(2 * max_pos_size - 1, dim_head))
        self.pos_emb_rel_width = nn.Parameter(torch.zeros(2 * max_pos_size - 1, dim_head))

    def forward(self, fmap: torch.Tensor) -> torch.Tensor:
        """NHWC (B, H, W, C) -> (B, heads, H*W, H*W) in fmap's type."""
        b, h, w, c = fmap.shape
        wq, wk = self.to_qk.weight.reshape(-1, c).chunk(2)

        def heads_of(t):
            return t.reshape(b, h * w, self.heads, self.dim_head).transpose(1, 2)

        q = heads_of(F.linear(fmap, wq) * self.dim_head ** -0.5).float()
        k = heads_of(F.linear(fmap, wk)).float()
        return torch.softmax(q @ k.transpose(-1, -2), dim=-1).to(fmap.dtype)


class GMAAggregate(nn.Module):
    def __init__(self, dim: int, heads: int = 1, dim_head: int = 128):
        super().__init__()
        if heads * dim_head != dim:
            raise ValueError("heads * dim_head must equal dim (no output projection)")
        self.heads, self.dim_head = heads, dim_head
        self.to_v = nn.Conv2d(dim, dim, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, attn: torch.Tensor, fmap: torch.Tensor) -> torch.Tensor:
        """attn (B, heads, N, N), NHWC fmap (B, H, W, C) -> NHWC, fmap's type."""
        b, h, w, c = fmap.shape
        v = conv1x1_nhwc(self.to_v, fmap)
        v = v.reshape(b, h * w, self.heads, self.dim_head).transpose(1, 2)
        out = (attn @ v).transpose(1, 2).reshape(b, h, w, c)
        return (fmap.float() + self.gamma * out.float()).to(fmap.dtype)


class FFBasicMotionEncoder(nn.Module):
    def __init__(self, cor_planes: int):
        super().__init__()
        self.convc1 = nn.Conv2d(cor_planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, 1, 1)
        self.convf1 = nn.Conv2d(2, 128, 7, 1, 3)
        self.convf2 = nn.Conv2d(128, 64, 3, 1, 1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, 1, 1)

    def forward(self, flow: torch.Tensor, cost_global: torch.Tensor,
                window: Optional[torch.Tensor]) -> torch.Tensor:
        """flow (B, H, W, 2), cost_global (B, H, W, Cg), window (B, H, W, 81)
        or None (only-global), NHWC -> (B, 128, H, W). convc1's input is
        [cost_global, window], or cost_global alone."""
        b, h, w, cg = cost_global.shape
        wc = self.convc1.weight.reshape(256, -1)
        if window is None:
            cor = F.linear(cost_global, wc, self.convc1.bias)
        else:
            cor = fold(window.reshape(b * h * w, -1), wc[:, cg:].contiguous(),
                       self.convc1.bias)
            cor = cor + cost_global.reshape(b * h * w, cg) @ wc[:, :cg].t()
        cor = torch.relu(_nchw(cor.reshape(b, h, w, 256)))
        cor = torch.relu(self.convc2(cor))
        flow = _nchw(flow)
        flo = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


def _heads(block: nn.Module, net: torch.Tensor, mask_needed: bool):
    """The flow head's delta (B, H, W, 2) and, where needed, the mask
    head's up-mask (B, H, W, 576), else None."""
    delta_flow = block.flow_head(net).permute(0, 2, 3, 1)
    up_mask: Optional[torch.Tensor] = None
    if mask_needed:
        up_mask = 0.25 * block.mask_2(torch.relu(block.mask_0(net)))
        up_mask = up_mask.permute(0, 2, 3, 1)
    return up_mask, delta_flow


class GMAUpdateBlock(nn.Module):
    def __init__(self, cor_planes: int, hidden_dim: int = 128):
        super().__init__()
        self.encoder = FFBasicMotionEncoder(cor_planes)
        self.aggregator = GMAAggregate(128, 1, 128)
        self.gru = SepConvGRU(hidden_dim, 128 + 2 * hidden_dim)
        self.flow_head = FlowHead(hidden_dim, 256)
        self.mask_0 = nn.Conv2d(128, 256, 3, 1, 1)
        self.mask_2 = nn.Conv2d(256, 64 * 9, 1)

    def forward(self, net, inp, cost_global, window, flow, attention,
                mask_needed: bool = True):
        """net, inp: (B, C, H, W); cost_global, window (or None), flow: NHWC;
        attention: (B, 1, H*W, H*W).

        Returns (net, up_mask (B, H, W, 576) or None, delta_flow (B, H, W, 2));
        the mask head runs only where its output is used."""
        motion = self.encoder(flow, cost_global, window)
        motion_global = _nchw(self.aggregator(attention, motion.permute(0, 2, 3, 1)))
        net = self.gru(net, torch.cat([inp, motion, motion_global], dim=1))
        return (net, *_heads(self, net, mask_needed))
