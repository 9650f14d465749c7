"""FF-FlowFormer, keypoint-conditioned FlowFormer, and vanilla FlowFormer.

- context: a Twins tower over image 1 (FF-FlowFormer: the CCE tower over
  image 1 and its mask);
- memory: a Twins tower over both frames batched (FF-FlowFormer: the CCE
  tower over the frames and their masks), a 1x1 to
  `encoder_latent_dim`, the all-pairs cost volume (no sqrt scaling, stored
  in the compute type), and the cost perceiver, which compresses each
  query's cost map into K latent tokens: the patch embed (patch size 8 or
  4), the input layer, then `encoder_depth` x (latent self-attention, or
  MLP-Mixer with `use_mlp`; vertical attention, or ConvNext with
  `vertical_conv`), and the input layer's output added back unless
  `cost_encoder_res` is off;
- decoder: `decoder_depth` refinements (or the forward's `iters`) sharing
  one set of parameters. Each looks up the radius-4 window of the cost
  maps (kernel A, one level), encodes it into a flow token (kernel B,
  then a 1x1), cross-attends from the flow token plus the position
  encoding of the current coordinates (the encoding alone without
  `add_flow_token`) to the query's latent tokens (kernel E, keys and
  values computed once before the loop) and runs the update block: GMA's
  (with `gma`) or the basic one, each over [global cost, window]
  (convc1's window half as kernel B), or over the global cost alone with
  `only_global`. In eval mode only the final low-resolution flow is
  convex-upsampled; in train mode every refinement makes its up-mask and the forward returns
  each one's convex-upsampled flow, (iters, B, 8H1, 8W1, 2) f32, the form
  FF-RAFT's train mode returns and the sequence losses take. Each
  refinement starts from detached coordinates, as the JAX package's
  `stop_gradient` and the reference's `detach` do.

With B > 1 the vertical layers see each sample's own context (a
sample-major repeat), the JAX package's fix of the reference's pairing.

This port covers `fusion='parallel'` (`FFFlowFormer`) and None
(`FlowFormer`, which ignores the masks it is given) and every variant of
`FlowFormerConfig`, cost heads 1 (the JAX package runs no other); the
eval-mode `forward` returns (flow_lr, flow_up) as the port's FF-RAFT does
(the JAX model returns them the other way round).

The stages are profiler ranges (`trace.py`): `ff.model.encode` over the
masks and the context tower, and again over the memory's feature tower and
its 1x1; `ff.model.cost` over the cost volume and the perceiver;
`ff.model.refine` over the decoder.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..kernels.attention import small_kv_attention
from ..kernels.fold import fold
from ..kernels.lookup import lookup
from ..nn.gma import FFBasicUpdateBlock, GMAAttention, GMAUpdateBlock
from ..nn.latent_cost import (BroadCrossAttentionLayer, ConvNextLayer, CostPatchEmbed,
                              MLPMixerLayer, SelfAttentionLayer,
                              VerticalSelfAttentionLayer, linear_position_embedding_sine)
from ..nn.twins import (LayerNorm, TwinsSVT2Stage, TwinsSVT2StageCCE, conv1x1_nhwc,
                        gelu)
from ..ops.coords import coords_grid
from ..ops.upsample import convex_upsample
from ..trace import span
from .config import FlowFormerConfig
from .ff_raft import compute_dtype
from .mask_modal import init_mask

_RADIUS = 4
_CONTEXT_DIM = 256


def cost_volume(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """NHWC (B, H, W, C) features -> (B, H*W, H, W) cost maps, no sqrt
    scaling, accumulated in f32 and stored in the features' type."""
    b, h, w, c = f1.shape
    corr = torch.matmul(f1.reshape(b, h * w, c), f2.reshape(b, h * w, c).transpose(1, 2))
    return corr.reshape(b, h * w, h, w)


class CostPerceiverEncoder(nn.Module):
    def __init__(self, cfg: FlowFormerConfig):
        super().__init__()
        self.cfg = cfg
        d, kt = cfg.cost_latent_dim, cfg.cost_latent_token_num
        self.patch_embed = CostPatchEmbed(1, cfg.cost_latent_input_dim, cfg.patch_size)
        self.latent_tokens = nn.Parameter(torch.zeros(1, kt, d))
        self.input_layer = BroadCrossAttentionLayer(d, d, d, cfg.cost_latent_input_dim * 2)
        for i in range(cfg.encoder_depth):
            self.add_module(f"encoder_layers_{i}",
                            MLPMixerLayer(d, kt) if cfg.use_mlp else SelfAttentionLayer(d))
            self.add_module(f"vertical_encoder_layers_{i}", ConvNextLayer(d)
                            if cfg.vertical_conv else VerticalSelfAttentionLayer(
                                d, cfg.vert_c_dim, context_dim=_CONTEXT_DIM))

    def forward(self, cost_maps: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        """cost_maps (B, H1*W1, H2, W2), context NHWC (B, H1, W1, 256)
        -> latent memory (B*H1*W1, K, cost_latent_dim)."""
        cfg = self.cfg
        b, q, h2, w2 = cost_maps.shape
        h1, w1 = context.shape[1:3]
        kt = cfg.cost_latent_token_num
        x, _ = self.patch_embed(cost_maps.reshape(b * q, h2, w2, 1))
        x = self.input_layer(self.latent_tokens.to(x.dtype), x)
        short_cut = x
        ctx = None if cfg.vertical_conv else context.repeat_interleave(kt, dim=0)  # sample-major
        for i in range(cfg.encoder_depth):
            x = getattr(self, f"encoder_layers_{i}")(x)
            x = x.reshape(b, q, kt, -1).transpose(1, 2).reshape(b * kt, q, -1)
            vertical = getattr(self, f"vertical_encoder_layers_{i}")
            if cfg.vertical_conv:
                x = vertical(x.reshape(b * kt, h1, w1, -1)).reshape(b * kt, q, -1)
            else:
                x = vertical(x, (h1, w1), ctx)
            x = x.reshape(b, kt, q, -1).transpose(1, 2).reshape(b * q, kt, -1)
        return x + short_cut if cfg.cost_encoder_res else x


class MemoryEncoder(nn.Module):
    """`feat_encoder_svt` (the given tower, default a plain
    `TwinsSVT2Stage`) over both frames batched, the 1x1
    `channel_convertor`, the cost volume and the perceiver."""

    def __init__(self, cfg: FlowFormerConfig, feat_encoder: Optional[nn.Module] = None):
        super().__init__()
        self.feat_encoder_svt = feat_encoder if feat_encoder is not None else TwinsSVT2Stage(3)
        self.channel_convertor = nn.Conv2d(256, cfg.encoder_latent_dim, 1, bias=False)
        self.cost_perceiver_encoder = CostPerceiverEncoder(cfg)

    def forward(self, img1, img2, context, mask1=None, mask2=None):
        """-> (latent memory (B*Q, K, D), cost maps (B, Q, H1, W1)); the
        masks go to a CCE tower, which takes them."""
        with span("ff.model.encode"):
            masks = () if mask1 is None else (torch.cat([mask1, mask2]),)
            feats = self.feat_encoder_svt(torch.cat([img1, img2]), *masks)
            feats = conv1x1_nhwc(self.channel_convertor, feats)
        with span("ff.model.cost"):
            f1, f2 = feats.chunk(2)
            cost_maps = cost_volume(f1, f2)
            return self.cost_perceiver_encoder(cost_maps, context), cost_maps


class MemoryDecoder(nn.Module):
    def __init__(self, cfg: FlowFormerConfig):
        super().__init__()
        self.cfg = cfg
        dim = cfg.query_latent_dim
        k2 = (2 * _RADIUS + 1) ** 2
        self.proj = nn.Conv2d(_CONTEXT_DIM, 256, 1)
        if cfg.gma:
            self.att = GMAAttention(128, 1, 128)
        self.decoder_layer_cross_attend_k = nn.Linear(cfg.cost_latent_dim, dim)
        self.decoder_layer_cross_attend_v = nn.Linear(cfg.cost_latent_dim, dim)
        # the refinement step's modules (one set, shared by every iteration)
        self.flow_token_encoder_0 = nn.Conv2d(k2, dim, 1)
        self.flow_token_encoder_2 = nn.Conv2d(dim, dim, 1)
        self.decoder_layer_cross_attend_norm1 = LayerNorm(dim, eps=1e-5)
        self.decoder_layer_cross_attend_q = nn.Linear(dim, dim)
        self.decoder_layer_cross_attend_proj = nn.Linear(2 * dim, dim)
        self.decoder_layer_cross_attend_norm2 = LayerNorm(dim, eps=1e-5)
        self.decoder_layer_cross_attend_ffn_0 = nn.Linear(dim, dim)
        self.decoder_layer_cross_attend_ffn_3 = nn.Linear(dim, dim)
        # only-global: convc1 reads the global cost alone
        cor_planes = dim if cfg.only_global else k2 + dim
        self.update_block = (GMAUpdateBlock if cfg.gma else FFBasicUpdateBlock)(cor_planes, 128)

    def _cost_global(self, window, coords1, k_mem, v_mem):
        """The flow token of each query cross-attends to its latent memory:
        window (B*Q, 81) -> (B*Q, dim)."""
        dim = self.cfg.query_latent_dim
        w0 = self.flow_token_encoder_0.weight.reshape(dim, -1)
        tok = fold(window, w0, self.flow_token_encoder_0.bias)
        query = conv1x1_nhwc(self.flow_token_encoder_2, gelu(tok))[:, None]
        qc_enc = linear_position_embedding_sine(coords1.reshape(-1, 1, 2), dim)
        qc_enc = qc_enc.to(query.dtype)
        if self.cfg.add_flow_token:
            qc_enc = self.decoder_layer_cross_attend_norm1(query) + qc_enc
        q = self.decoder_layer_cross_attend_q(qc_enc)
        x = small_kv_attention(q, k_mem, v_mem, 8, (dim / 8) ** -0.5)
        x = query + self.decoder_layer_cross_attend_proj(torch.cat([x, query], dim=2))
        xn = self.decoder_layer_cross_attend_norm2(x)
        x = x + self.decoder_layer_cross_attend_ffn_3(
            gelu(self.decoder_layer_cross_attend_ffn_0(xn)))
        return x[:, 0]

    def forward(self, cost_memory, cost_maps, context, iters: int,
                flow_init: Optional[torch.Tensor] = None):
        """cost_memory (B*Q, K, D), cost_maps (B, Q, H1, W1), context NHWC
        (B, H1, W1, 256) -> (flow_lr (B, H1, W1, 2), flow_up (B, 8H1, 8W1, 2))
        after `iters` refinements from `coords0 + flow_init`; in train mode
        every refinement's flow_up, stacked (iters, B, 8H1, 8W1, 2)."""
        with span("ff.model.refine"):
            b, h1, w1, _ = context.shape
            d = cost_maps.dtype
            context = conv1x1_nhwc(self.proj, context)
            net = torch.tanh(context[..., :128]).permute(0, 3, 1, 2)
            inp = torch.relu(context[..., 128:])
            attention = self.att(inp) if self.cfg.gma else None
            inp = inp.permute(0, 3, 1, 2)
            k_mem = self.decoder_layer_cross_attend_k(cost_memory)
            v_mem = self.decoder_layer_cross_attend_v(cost_memory)

            coords0 = coords_grid(b, h1, w1, device=context.device)
            coords1 = (coords0.contiguous() if flow_init is None
                       else (coords0 + flow_init.float()).contiguous())
            up_mask, flows = None, []
            for it in range(iters):
                if self.training:
                    coords1 = coords1.detach()
                window = lookup([cost_maps], coords1, _RADIUS)  # (B, H1, W1, 81) in d
                cost_global = self._cost_global(window.reshape(b * h1 * w1, -1),
                                                coords1, k_mem, v_mem)
                net, up_mask, delta = self.update_block(
                    net, inp, cost_global.reshape(b, h1, w1, -1),
                    None if self.cfg.only_global else window,
                    (coords1 - coords0).to(d), attention,
                    mask_needed=self.training or it == iters - 1)
                coords1 = coords1 + delta.float()
                if self.training:
                    flows.append(convex_upsample(coords1 - coords0, up_mask.float()))

            if self.training:
                return torch.stack(flows)
            flow_lr = coords1 - coords0
            return flow_lr, convex_upsample(flow_lr, up_mask.float())


class FlowFormer(nn.Module):
    """Vanilla FlowFormer: [-1, 1] scaling, the Twins context tower, the
    memory encoder and the decoder. The masks are not read."""

    def __init__(self, cfg: FlowFormerConfig):
        super().__init__()
        if cfg.decoder_depth < 1:
            raise ValueError(f"decoder_depth {cfg.decoder_depth}: at least one "
                             "refinement makes the upsampling mask")
        self.cfg = cfg
        self.context_encoder_svt = self._tower()
        self.memory_encoder = MemoryEncoder(cfg, self._tower())
        self.memory_decoder = MemoryDecoder(cfg)

    def _tower(self) -> nn.Module:
        return TwinsSVT2Stage(3)

    def _masks(self, image1, image2, mask1, mask2) -> tuple:
        """The masks the towers read, prepared: none here."""
        return ()

    def forward(self, image1, image2, mask1=None, mask2=None, iters: Optional[int] = None,
                flow_init: Optional[torch.Tensor] = None):
        """NHWC images (0..255) and raw 0/255 masks -> (flow_lr, flow_up), f32,
        or in train mode every refinement's flow_up stacked, after `iters`
        refinements (default `decoder_depth`; the parameters are
        shared, so any count >= 1 runs) from `coords0 + flow_init` (the
        warm start, (B, H/8, W/8, 2))."""
        cfg = self.cfg
        if iters is None:
            iters = cfg.decoder_depth
        if iters < 1:
            raise ValueError(f"iters must be >= 1, got {iters}: the last "
                             "refinement makes the upsampling mask")
        d = compute_dtype(cfg)
        with span("ff.model.encode"):
            masks = self._masks(image1, image2, mask1, mask2)
            image1, image2 = ((2 * (t / 255.0) - 1.0).to(d) for t in (image1, image2))
            context = self.context_encoder_svt(image1, *masks[:1])
        memory, cost_maps = self.memory_encoder(image1, image2, context, *masks)
        return self.memory_decoder(memory, cost_maps, context, iters, flow_init)


class FFFlowFormer(FlowFormer):
    """FlowFormer with CCE Twins towers: mask modality preparation and
    [-1, 1] scaling of the masks, which both towers read."""

    def _tower(self) -> nn.Module:
        return TwinsSVT2StageCCE(3, self.cfg.mask_channel)

    def _masks(self, image1, image2, mask1, mask2) -> tuple:
        cfg = self.cfg
        mask1, mask2 = init_mask(
            image1, image2, mask1, mask2, mask_modal=cfg.mask_modal,
            mask_channel=cfg.mask_channel, mask_dilate=cfg.mask_dilate,
            kernel_size=cfg.kernel_size, kernel_sigma=cfg.kernel_sigma)
        d = compute_dtype(cfg)
        return tuple((2 * (t / 255.0) - 1.0).to(d) for t in (mask1, mask2))
