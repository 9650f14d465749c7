"""The cost perceiver's layers (FlowFormer's latent cost encoder), frozen
from the port's `nn/latent_cost.py`: K = 8 latent tokens, pe 'linear',
one cost head, vert_c_dim 64.

- `CostPatchEmbed`: each query's cost map, three 6x6 stride-2 convs, then
  a 1x1 over [features, sine encoding of the patch centres] and LayerNorm;
- `BroadCrossAttentionLayer`: the K latent tokens cross-attend to a cost
  map's tokens (kernel E's plain version);
- `SelfAttentionLayer`: the latent layer over the K tokens of each query;
- `VerticalSelfAttentionLayer`: the vertical layer over the H1 x W1 grid
  of one latent token, a 7x7-window block (kernel F's plain version) and a
  sub-sampled global block, each with a sine position encoding and the
  projected context added to the query/key input.
"""

from __future__ import annotations

import torch
from torch import nn

from .coords import coords_grid
from .plain import small_kv_attention_plain as small_kv_attention
from .plain import window_attention_plain as window_attention
from .twins import LayerNorm, TwinsMlp, conv1x1_nhwc, conv_nhwc, gelu, pad_grid


def linear_position_embedding_sine(x: torch.Tensor, dim: int,
                                   normalize_factor: float = 1.0 / 200) -> torch.Tensor:
    """(..., 2) (x, y) positions -> (..., dim) [sin x, cos x, sin y, cos y]
    at frequencies 0 .. dim/4 - 1, f32."""
    freq = torch.arange(dim // 4, dtype=torch.float32, device=x.device)
    px = x[..., -2:-1].float() * freq * (3.14 * normalize_factor)
    py = x[..., -1:].float() * freq * (3.14 * normalize_factor)
    return torch.cat([torch.sin(px), torch.cos(px), torch.sin(py),
                      torch.cos(py)], dim=-1)


class CostPatchEmbed(nn.Module):
    """(B*H1*W1, H2, W2, heads) cost maps -> tokens (B*H1*W1, h3*w3, 2*ed):
    three 6x6 stride-2 convs (ed/4, ed/2, ed: patch size 8), then a 1x1
    over [features, sine encoding of the patch centres], a 1x1 and
    LayerNorm (eps 1e-5)."""

    def __init__(self, in_chans: int = 1, embed_dim: int = 64):
        super().__init__()
        self.embed_dim, self.patch_size = embed_dim, 8
        self.proj_0 = nn.Conv2d(in_chans, embed_dim // 4, 6, 2, 2)
        self.proj_2 = nn.Conv2d(embed_dim // 4, embed_dim // 2, 6, 2, 2)
        self.proj_4 = nn.Conv2d(embed_dim // 2, embed_dim, 6, 2, 2)
        c2 = 2 * embed_dim
        self.ffn_with_coord_0 = nn.Conv2d(c2, c2, 1)
        self.ffn_with_coord_2 = nn.Conv2d(c2, c2, 1)
        self.norm = LayerNorm(c2, eps=1e-5)

    def forward(self, x: torch.Tensor):
        p = self.patch_size
        x = pad_grid(x, p).permute(0, 3, 1, 2)
        x = self.proj_4(torch.relu(self.proj_2(torch.relu(self.proj_0(x)))))
        x = x.permute(0, 2, 3, 1)
        b, h3, w3, _ = x.shape
        coord = coords_grid(1, h3, w3, device=x.device) * p + p / 2
        enc = linear_position_embedding_sine(coord, self.embed_dim).to(x.dtype)
        xp = torch.cat([x, enc.expand(b, -1, -1, -1)], dim=-1)
        xp = torch.relu(conv1x1_nhwc(self.ffn_with_coord_0, xp))
        xp = self.norm(conv1x1_nhwc(self.ffn_with_coord_2, xp))
        return xp.reshape(b, h3 * w3, -1), (h3, w3)


class BroadCrossAttentionLayer(nn.Module):
    """Shared latent queries (1, K, Cq) cross-attend to (B, M, Ct) tokens."""

    def __init__(self, qk_dim: int, v_dim: int, query_token_dim: int,
                 tgt_token_dim: int, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (qk_dim / num_heads) ** -0.5
        self.norm1 = LayerNorm(query_token_dim, eps=1e-5)
        self.q = nn.Linear(query_token_dim, qk_dim)
        self.k = nn.Linear(tgt_token_dim, qk_dim)
        self.v = nn.Linear(tgt_token_dim, v_dim)
        self.proj = nn.Linear(v_dim, query_token_dim)
        self.norm2 = LayerNorm(query_token_dim, eps=1e-5)
        self.ffn_0 = nn.Linear(query_token_dim, query_token_dim)
        self.ffn_3 = nn.Linear(query_token_dim, query_token_dim)

    def forward(self, query: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
        b = tgt.shape[0]
        q = self.q(self.norm1(query)).expand(b, -1, -1).contiguous()
        x = small_kv_attention(q, self.k(tgt), self.v(tgt), self.num_heads,
                               self.scale)
        x = query + self.proj(x)
        return x + self.ffn_3(gelu(self.ffn_0(self.norm2(x))))


class SelfAttentionLayer(nn.Module):
    """Self-attention over the K latent tokens of each query, (B, K, C)."""

    def __init__(self, dim: int, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim / num_heads) ** -0.5
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.ffn_0 = nn.Linear(dim, dim)
        self.ffn_3 = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xn = self.norm1(x)
        y = small_kv_attention(self.q(xn), self.k(xn), self.v(xn),
                               self.num_heads, self.scale)
        x = x + self.proj(y)
        return x + self.ffn_3(gelu(self.ffn_0(self.norm2(x))))


class _ContextProj(nn.Module):
    def __init__(self, context_dim: int, vert_c_dim: int):
        super().__init__()
        self.context_proj = nn.Linear(context_dim, vert_c_dim)

    def forward(self, context: torch.Tensor, b: int) -> torch.Tensor:
        """(B0, H, W, Cc) context, tiled to batch b -> (b, H, W, vert_c_dim)."""
        ctx = self.context_proj(context)
        reps = b // context.shape[0]
        return ctx if reps == 1 else ctx.repeat(reps, 1, 1, 1)


class _RPEContextAttn(nn.Module):
    """Shared by the local and global vertical attentions: the projections
    and the query/key input [x, projected context]."""

    def __init__(self, dim: int, num_heads: int, vert_c_dim: int,
                 context_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.c_qk = dim + vert_c_dim
        self.ctx = _ContextProj(context_dim, vert_c_dim)
        self.q = nn.Linear(self.c_qk, dim)
        self.proj = nn.Linear(dim, dim)

    def _inputs(self, x, size, context, multiple):
        """-> (xg, x_qk), NHWC, zero-padded to multiples of `multiple`."""
        b, n, c = x.shape
        xg = x.reshape(b, *size, c)
        x_qk = torch.cat([xg, self.ctx(context, b)], dim=-1)
        return pad_grid(xg, multiple), pad_grid(x_qk, multiple)


class LocallyGroupedAttnRPEContext(_RPEContextAttn):
    """7x7-window attention with a per-window-position sine encoding and
    the context in q/k. The encoding, tiled over the windows, is added to
    the padded natural grid; q/k come from that sum, v from the grid, and
    kernel F attends without partitioning anything."""

    def __init__(self, dim: int, num_heads: int, vert_c_dim: int,
                 context_dim: int, ws: int = 7):
        super().__init__(dim, num_heads, vert_c_dim, context_dim)
        self.ws = ws
        self.k = nn.Linear(self.c_qk, dim)
        self.v = nn.Linear(dim, dim)

    def forward(self, x, size, context):
        b, n, c = x.shape
        h, w = size
        ws = self.ws
        xg, x_qk = self._inputs(x, size, context, ws)
        hp, wp = xg.shape[1:3]
        coord = coords_grid(1, ws, ws, device=x.device)
        enc = linear_position_embedding_sine(coord, self.c_qk).to(x.dtype)
        xe = x_qk + enc.repeat(1, hp // ws, wp // ws, 1)
        out = window_attention(self.q(xe), self.k(xe), self.v(xg), ws,
                               self.num_heads, (c // self.num_heads) ** -0.5)
        return self.proj(out[:, :h, :w].reshape(b, n, c))


class GlobalSubSampleAttnRPEContext(_RPEContextAttn):
    """Every token attends to the sr x sr sub-sampled grid (kernel E), with
    absolute sine encodings on the queries and the sub-sampled keys."""

    def __init__(self, dim: int, num_heads: int, vert_c_dim: int,
                 context_dim: int, sr_ratio: int = 4):
        super().__init__(dim, num_heads, vert_c_dim, context_dim)
        self.sr_ratio = sr_ratio
        self.sr_key = nn.Conv2d(self.c_qk, dim, sr_ratio, sr_ratio)
        self.sr_value = nn.Conv2d(dim, dim, sr_ratio, sr_ratio)
        self.norm = LayerNorm(dim, eps=1e-5)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)

    def forward(self, x, size, context):
        b, n, c = x.shape
        h, w = size
        sr = self.sr_ratio
        xg, x_qk = self._inputs(x, size, context, sr)
        hp, wp = xg.shape[1:3]
        d = x.dtype
        coord = coords_grid(1, hp, wp, device=x.device).reshape(1, hp * wp, 2)
        enc = linear_position_embedding_sine(coord, self.c_qk).to(d)
        q = self.q(x_qk.reshape(b, hp * wp, self.c_qk) + enc)
        xk = self.norm(conv_nhwc(self.sr_key, x_qk, same=True).reshape(b, -1, c))
        xv = self.norm(conv_nhwc(self.sr_value, xg, same=True).reshape(b, -1, c))
        coord2 = coords_grid(1, hp // sr, wp // sr, device=x.device) * sr
        enc2 = linear_position_embedding_sine(coord2.reshape(1, -1, 2), c).to(d)
        out = small_kv_attention(q, self.k(xk + enc2), self.v(xv),
                                 self.num_heads, (c // self.num_heads) ** -0.5)
        out = out.reshape(b, hp, wp, c)[:, :h, :w].reshape(b, n, c)
        return self.proj(out)


class RPEBlock(nn.Module):
    """Pre-norm block (LayerNorm eps 1e-6) around a vertical attention and
    the Twins MLP."""

    def __init__(self, attn: nn.Module, dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = attn
        self.norm2 = LayerNorm(dim)
        self.mlp = TwinsMlp(dim, 4 * dim)

    def forward(self, x, size, context):
        x = x + self.attn(self.norm1(x), size, context)
        return x + self.mlp(self.norm2(x))


class VerticalSelfAttentionLayer(nn.Module):
    """A local 7x7-window block, then a global sub-sampled (sr 4) block,
    over (B*K, H1*W1, dim) tokens."""

    def __init__(self, dim: int, vert_c_dim: int, num_heads: int = 8,
                 context_dim: int = 256):
        super().__init__()
        args = (dim, num_heads, vert_c_dim, context_dim)
        self.local_block = RPEBlock(LocallyGroupedAttnRPEContext(*args), dim)
        self.global_block = RPEBlock(GlobalSubSampleAttnRPEContext(*args), dim)

    def forward(self, x, size, context):
        x = self.local_block(x, size, context)
        return self.global_block(x, size, context)
