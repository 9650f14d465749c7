"""Twins-SVT, truncated to two stages (`TwinsSVT2Stage`, vanilla
FlowFormer's towers), and with the Condition Control Encoder's mirrored
mask pyramid (`TwinsSVT2StageCCE`), in token layout.

Per stage: a patch embed (4x4, then 2x2) and two blocks, a locally grouped
7x7-window attention (LSA, kernel F) and then a global sub-sampled
attention (GSA, kernel E, keys and values from an sr x sr strided conv), a
depthwise 3x3 position conv after the first block. Dims 128/256, heads
4/8, sr 8/4, MLP ratio 4, LayerNorm eps 1e-6. The CCE variant runs the same
pyramid over the mask and fuses after each stage with a 1x1conv unit
(bidirectional at stage 0, mask-to-image only at stage 1); both towers
build and run their stages with the same two functions. Output is the
stride-8, 256-channel NHWC feature map.

The strided convs (patch embeds, the GSA `sr` conv) pad as flax's default
'SAME' does: where sr does not divide the grid, out = ceil(size / sr) and
the pad is split low = total // 2, high = the rest (a 110-row grid at
sr 8 gives 14 rows, not the 13 of an unpadded conv).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.attention import small_kv_attention
from ..kernels.window_attention import window_attention
from .fusion_units import FusionUnit


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU keyed on the type: exact erf in f32, the tanh form in bf16."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


class LayerNorm(nn.Module):
    """LayerNorm over the last axis; statistics in f32, output in x's type."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor, same: bool = False) -> torch.Tensor:
    """Apply `conv` to NHWC `x` -> NHWC; `same` pads as flax 'SAME' does."""
    x = x.permute(0, 3, 1, 2)
    if same:
        pads = []
        for size, k, s in zip(x.shape[:1:-1], conv.kernel_size[::-1],
                              conv.stride[::-1]):
            total = max((-(-size // s) - 1) * s + k - size, 0)
            pads += [total // 2, total - total // 2]
        if any(pads):
            x = F.pad(x, pads)
    return conv(x).permute(0, 2, 3, 1)


def conv1x1_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 `conv` applied to NHWC `x` as a matrix product."""
    return F.linear(x, conv.weight.reshape(conv.out_channels, -1), conv.bias)


def pad_grid(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Zero-pad NHWC `x` at the bottom and right to multiples of `multiple`."""
    h, w = x.shape[1:3]
    return F.pad(x, (0, 0, 0, (-w) % multiple, 0, (-h) % multiple))


def linear_rows(x: torch.Tensor, linear: nn.Linear, parts: int):
    """`linear(x)` split into `parts` equal column blocks, each computed by
    its own product so every block comes out contiguous."""
    w = linear.weight.chunk(parts)
    b = linear.bias.chunk(parts)
    return [F.linear(x, wi, bi) for wi, bi in zip(w, b)]


class TwinsMlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class LocallyGroupedAttn(nn.Module):
    """LSA: attention within ws x ws windows. The grid is zero-padded to
    multiples of ws BEFORE the qkv projection (padded tokens carry its
    bias, as in the reference), then kernel F, then the crop and `proj`."""

    def __init__(self, dim: int, num_heads: int, ws: int = 7):
        super().__init__()
        self.num_heads, self.ws = num_heads, ws
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, size) -> torch.Tensor:
        b, n, c = x.shape
        h, w = size
        xg = pad_grid(x.reshape(b, h, w, c), self.ws)
        q, k, v = linear_rows(xg, self.qkv, 3)
        scale = (c // self.num_heads) ** -0.5
        out = window_attention(q, k, v, self.ws, self.num_heads, scale)
        return self.proj(out[:, :h, :w].reshape(b, n, c))


class GlobalSubSampleAttn(nn.Module):
    """GSA: every token attends to the sr x sr sub-sampled grid (kernel E)."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int):
        super().__init__()
        self.num_heads = num_heads
        self.q = nn.Linear(dim, dim)
        self.sr = nn.Conv2d(dim, dim, sr_ratio, sr_ratio)
        self.norm = LayerNorm(dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, size) -> torch.Tensor:
        b, n, c = x.shape
        h, w = size
        q = self.q(x)
        xs = conv_nhwc(self.sr, x.reshape(b, h, w, c), same=True)
        xs = self.norm(xs.reshape(b, -1, c))
        k, v = linear_rows(xs, self.kv, 2)
        scale = (c // self.num_heads) ** -0.5
        return self.proj(small_kv_attention(q, k, v, self.num_heads, scale))


class TwinsBlock(nn.Module):
    """Pre-norm block around an LSA (`ws` > 1) or a GSA, and the MLP."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int, ws: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        if ws > 1:
            self.attn = LocallyGroupedAttn(dim, num_heads, ws)
        else:
            self.attn = GlobalSubSampleAttn(dim, num_heads, sr_ratio)
        self.norm2 = LayerNorm(dim)
        self.mlp = TwinsMlp(dim, 4 * dim)

    def forward(self, x: torch.Tensor, size) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), size)
        return x + self.mlp(self.norm2(x))


class PosConv(nn.Module):
    """PEG: depthwise 3x3 conv plus the residual."""

    def __init__(self, dim: int):
        super().__init__()
        self.proj_0 = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim)

    def forward(self, x: torch.Tensor, size) -> torch.Tensor:
        b, n, c = x.shape
        feat = x.reshape(b, *size, c)
        return (conv_nhwc(self.proj_0, feat) + feat).reshape(b, n, c)


class TwinsPatchEmbed(nn.Module):
    """p x p stride-p conv ('SAME'), then LayerNorm over the tokens."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, patch_size)
        self.norm = LayerNorm(embed_dim)

    def forward(self, x: torch.Tensor):
        """NHWC (B, H, W, Cin) -> tokens (B, h*w, C), (h, w)."""
        x = conv_nhwc(self.proj, x, same=True)
        b, h, w, c = x.shape
        return self.norm(x.reshape(b, h * w, c)), (h, w)


_STAGE_DIMS = (128, 256)
_STAGE_HEADS = (4, 8)
_STAGE_SR = (8, 4)
_STAGE_PATCH = (4, 2)
_STAGE_DEPTH = (2, 2)
_WS = 7


def _add_stage(tower: nn.Module, s: int, in_chans: int, prefix: str = "") -> None:
    """Stage `s`'s patch embed, blocks and position conv, named
    `{prefix}patch_embeds_{s}`, `{prefix}blocks_{s}_{j}`,
    `{prefix}pos_block_{s}`."""
    dim = _STAGE_DIMS[s]
    tower.add_module(f"{prefix}patch_embeds_{s}", TwinsPatchEmbed(_STAGE_PATCH[s], in_chans, dim))
    for j in range(_STAGE_DEPTH[s]):
        tower.add_module(f"{prefix}blocks_{s}_{j}", TwinsBlock(
            dim, _STAGE_HEADS[s], _STAGE_SR[s], _WS if j % 2 == 0 else 1))
    tower.add_module(f"{prefix}pos_block_{s}", PosConv(dim))


def _run_stage(tower: nn.Module, s: int, x: torch.Tensor, prefix: str = "") -> torch.Tensor:
    """Stage `s` over NHWC `x` -> NHWC (B, h, w, dim): the patch embed, the
    blocks, the position conv after the first."""
    m = lambda name: getattr(tower, prefix + name)
    x, size = m(f"patch_embeds_{s}")(x)
    for j in range(_STAGE_DEPTH[s]):
        x = m(f"blocks_{s}_{j}")(x, size)
        if j == 0:
            x = m(f"pos_block_{s}")(x, size)
    return x.reshape(x.shape[0], *size, -1)


class TwinsSVT2Stage(nn.Module):
    """The image pyramid alone -> (B, H/8, W/8, 256)."""

    def __init__(self, in_chans: int = 3):
        super().__init__()
        for s in range(2):
            _add_stage(self, s, in_chans if s == 0 else _STAGE_DIMS[0])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC image (B, H, W, in_chans)."""
        for s in range(2):
            x = _run_stage(self, s, x)
        return x


class TwinsSVT2StageCCE(nn.Module):
    """Image and mask pyramids, fused after each stage -> (B, H/8, W/8, 256)."""

    def __init__(self, in_chans: int = 3, mask_chans: int = 3):
        super().__init__()
        for s in range(2):
            cin = (in_chans, mask_chans) if s == 0 else (_STAGE_DIMS[0],) * 2
            for prefix, ci in zip(("", "mask_"), cin):
                _add_stage(self, s, ci, prefix)
            self.add_module(f"fusion_blks_{s}",
                            FusionUnit(_STAGE_DIMS[s], "1x1conv", bi_direction=s == 0))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """NHWC image (B, H, W, 3) and mask (B, H, W, mask_chans)."""
        for s in range(2):
            x = _run_stage(self, s, x).permute(0, 3, 1, 2)
            mask = _run_stage(self, s, mask, "mask_").permute(0, 3, 1, 2)
            mask, x = getattr(self, f"fusion_blks_{s}")(mask, x)
            x, mask = x.permute(0, 2, 3, 1), mask.permute(0, 2, 3, 1)
        return x
