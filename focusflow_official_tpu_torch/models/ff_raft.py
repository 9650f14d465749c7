"""FF-RAFT: keypoint-conditioned RAFT with the Condition Control Encoder,
plain RAFT, the attention and conv front ends before a plain RAFT, and
the small model, in test mode and in train mode.

The feature encoder runs once over both frames batched together (exact
for the instance-norm fnet); the all-pairs volume and its 4-level pyramid
are built once; then `iters` refinement steps each run the update block,
whose motion encoder looks up the window and applies convc1 in one kernel
(`kernels/lookup_fold.py`). With ALT_CORR (`alt_corr`) no volume is
built: each step recomputes the volume's rows a chunk of queries at a time
from the feature maps (`ops/corr.py::AltCorr`). The coordinates are
detached at the start of every step, as the reference does. Test mode
upsamples only the final low-resolution flow; train mode returns every
step's upsampled flow, stacked. The full-width model upsamples convexly
(the mask head runs where its output is used); the small model (`small`:
hdim 96, cdim 64, radius 3, no mask head) bilinearly (`upflow8`).

The encoders follow the config, as the JAX package picks them:
- fnet: `ChannelProject` (`channel_pjt`) with `abandon_fnet`; else the
  CCE with `fusion='parallel'`; else an instance-norm `BasicEncoder`
  (`SmallEncoder` when small);
- cnet: the CCE with `fusion='parallel'` and `fuse_cnet`; else a
  `BasicEncoder` (`SmallEncoder`) over the image; batch norms at full
  width, none when small.
With `fusion=None` (plain RAFT) the masks are not read. With
`fusion='attention'` or `'conv'` the front end (`models/frontends.py`)
turns each frame and its mask into a `fusion_channel`-channel feature
image, and a plain RAFT with that many input channels runs on the two.

Train mode is the module's `training` flag (`model.train()`); the batch
norms then use the batch's statistics unless `freeze_bn()` put the RAFT
core's back in eval mode (a conv front end's stay in train mode, as in the
JAX package), and with `dropout` above 0 the encoders drop whole channels
of their outputs by the keep masks the caller drew (`dropout_sites` says
which; `train/loop.py` draws them). With ALT_CORR the chunk walk is one
autograd Function whose backward walks the chunks again
(`ops/corr.py::alternate_corr_fold`). The module holds its parameters in
f32; a bf16 forward takes its convolutions' weights in bf16
(`train/loop.py::compute_params` casts them at use for training,
`FlowPredictor` casts the module once for inference).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..nn.cce import BasicParallelFusionLayer
from ..nn.encoders import BasicEncoder, ChannelProject, SmallEncoder
from ..nn.norm import Norm
from ..nn.update import BasicUpdateBlock, SmallUpdateBlock
from ..ops.coords import coords_grid, upflow8
from ..ops.corr import AltCorr, all_pairs_corr, corr_pyramid
from ..ops.upsample import convex_upsample
from .config import FFRaftConfig
from .frontends import ConvFusionLayer, FusionLayer
from .mask_modal import init_mask

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: FFRaftConfig) -> torch.dtype:
    try:
        return DTYPES[cfg.compute_dtype]
    except KeyError:
        raise ValueError(f"compute_dtype must be one of {sorted(DTYPES)}, "
                         f"got {cfg.compute_dtype!r}") from None


class RAFT(nn.Module):
    """RAFT core; its encoders as the module docstring says. `in_channels`:
    the plain encoders' input channels (a front end's `fusion_channel`)."""

    corr_levels = 4

    def __init__(self, mask_channel: int = 3, fusion_type: str = "1x1conv",
                 fusion: Optional[str] = "parallel", fuse_cnet: bool = True,
                 abandon_fnet: bool = False, small: bool = False, in_channels: int = 3,
                 alt_corr: bool = False, alt_corr_chunk: int = 2048, dropout: float = 0.0):
        super().__init__()
        self.small, self.alt_corr, self.alt_corr_chunk = small, alt_corr, alt_corr_chunk
        self.hdim, cdim, self.corr_radius = (96, 64, 3) if small else (128, 128, 4)
        encoder = SmallEncoder if small else BasicEncoder
        parallel = fusion == "parallel"
        if abandon_fnet:
            self.channel_pjt = ChannelProject(in_channels, 128 if small else 256)
        elif parallel:
            self.fnet = BasicParallelFusionLayer(3, mask_channel, 256, "instance",
                                                 fusion_type, dropout)
        else:
            self.fnet = encoder(in_channels, 128 if small else 256, "instance", dropout)
        cnet_norm = "none" if small else "batch"
        if parallel and fuse_cnet:
            self.cnet = BasicParallelFusionLayer(3, mask_channel, self.hdim + cdim, cnet_norm,
                                                 fusion_type, dropout)
        else:
            self.cnet = encoder(3 if parallel else in_channels, self.hdim + cdim, cnet_norm,
                                dropout)
        self.update_block = (SmallUpdateBlock if small else BasicUpdateBlock)(
            self.corr_levels, self.corr_radius, self.hdim)

    def upsample(self, flow: torch.Tensor, up_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """(B, H/8, W/8, 2) f32 -> (B, H, W, 2): bilinear when small, else
        convex with the mask head's logits."""
        return upflow8(flow) if self.small else convex_upsample(flow, up_mask.float())

    def dropout_sites(self) -> Dict[str, Tuple[int, int]]:
        """The encoders whose outputs train-mode dropout drops channels of,
        in the order they are drawn: name -> (frames, channels); the fnet
        runs over both frames (none where it is `ChannelProject`), the cnet
        over the first. Empty at a rate of 0."""
        sites = {}
        for name, frames in (("fnet", 2), ("cnet", 1)):
            enc = getattr(self, name, None)
            if enc is not None and enc.dropout > 0:
                sites[name] = (frames, enc.conv2.out_channels)
        return sites

    def forward(self, image1, image2, mask1=None, mask2=None, iters: int = 12,
                dtype: torch.dtype = torch.float32,
                flow_init: Optional[torch.Tensor] = None,
                dropout: Optional[Dict[str, torch.Tensor]] = None):
        """NHWC inputs scaled to [-1, 1] (masks: those the CCE encoders
        read, else None) -> (flow_lr (B, H/8, W/8, 2), flow_up
        (B, H, W, 2)), both f32; in train mode every step's upsampled
        flow, (iters, B, H, W, 2) f32. `flow_init` (B, H/8, W/8, 2), the
        warm start, is added to the starting coordinates. `dropout`: the
        keep masks of each of `dropout_sites` (train mode, a rate above 0)."""
        if iters < 1:
            raise ValueError(f"iters must be >= 1, got {iters}")
        image1, image2 = image1.to(dtype), image2.to(dtype)
        if mask1 is not None:
            mask1, mask2 = mask1.to(dtype), mask2.to(dtype)

        drop = dropout or {}
        images = torch.cat([image1, image2])
        if hasattr(self, "channel_pjt"):
            fmaps = self.channel_pjt(images)
        elif isinstance(self.fnet, BasicParallelFusionLayer):
            fmaps = self.fnet(images, torch.cat([mask1, mask2]), drop.get("fnet"))
        else:
            fmaps = self.fnet(images, drop.get("fnet"))
        if self.alt_corr:
            corr = AltCorr(*fmaps.to(dtype).chunk(2), self.corr_levels, self.alt_corr_chunk)
        else:
            corr = corr_pyramid(all_pairs_corr(*fmaps.float().chunk(2)), self.corr_levels,
                                dtype)

        if isinstance(self.cnet, BasicParallelFusionLayer):
            cnet = self.cnet(image1, mask1, drop.get("cnet"))
        else:
            cnet = self.cnet(image1, drop.get("cnet"))
        cnet = cnet.permute(0, 3, 1, 2)
        net = torch.tanh(cnet[:, :self.hdim])
        inp = torch.relu(cnet[:, self.hdim:])

        b, h, w = fmaps.shape[0] // 2, *fmaps.shape[1:3]
        coords0 = coords_grid(b, h, w, device=fmaps.device)
        coords1 = coords0.clone() if flow_init is None else coords0 + flow_init.float()
        up_mask, flows = None, []
        for it in range(iters):
            coords1 = coords1.detach()
            flow = (coords1 - coords0).to(dtype)
            net, up_mask, delta = self.update_block(
                net, inp, corr, coords1.contiguous(), flow,
                mask_needed=self.training or it == iters - 1)
            coords1 = coords1 + delta.float()
            if self.training:
                flows.append(self.upsample(coords1 - coords0, up_mask))

        if self.training:
            return torch.stack(flows)
        flow_lr = coords1 - coords0
        return flow_lr, self.upsample(flow_lr, up_mask)


class FFRaft(nn.Module):
    """Mask modality preparation (all but plain RAFT), [-1, 1] scaling, the
    front end where `fusion` names one, and the RAFT core."""

    def __init__(self, cfg: FFRaftConfig):
        super().__init__()
        if cfg.fusion not in ("parallel", None, "attention", "conv"):
            raise ValueError(f"fusion must be 'parallel', None, 'attention' or 'conv'; "
                             f"got {cfg.fusion!r}")
        self.cfg = cfg
        if cfg.fusion == "attention":
            self.fusion_layer = FusionLayer(3, cfg.mask_channel, cfg.fusion_channel)
        elif cfg.fusion == "conv":
            self.fusion_layer = ConvFusionLayer(cfg.fusion_channel, 3, cfg.mask_channel)
        front = cfg.fusion in ("attention", "conv")
        self.flow_net = RAFT(cfg.mask_channel, cfg.fusion_type,
                             None if front else cfg.fusion, cfg.fuse_cnet, cfg.abandon_fnet,
                             cfg.small, cfg.fusion_channel if front else 3, cfg.alt_corr,
                             cfg.alt_corr_chunk, cfg.dropout)

    def dropout_sites(self) -> Dict[str, Tuple[int, int]]:
        """`RAFT.dropout_sites` of the RAFT core."""
        return self.flow_net.dropout_sites()

    def forward(self, image1, image2, mask1, mask2,
                iters: Optional[int] = None, flow_init: Optional[torch.Tensor] = None,
                dropout: Optional[Dict[str, torch.Tensor]] = None):
        """NHWC images (0..255) and raw 0/255 masks (plain RAFT ignores
        them) -> (flow_lr, flow_up), or in train mode the stacked flows;
        `flow_init` and `dropout` as in `RAFT.forward`."""
        cfg = self.cfg
        if iters is None:
            iters = cfg.iters
        dtype = compute_dtype(cfg)
        scale = lambda t: 2 * (t / 255.0) - 1.0
        if cfg.fusion is None:
            mask1 = mask2 = None
        else:
            mask1, mask2 = init_mask(
                image1, image2, mask1, mask2, mask_modal=cfg.mask_modal,
                mask_channel=cfg.mask_channel, mask_dilate=cfg.mask_dilate,
                kernel_size=cfg.kernel_size, kernel_sigma=cfg.kernel_sigma)
            mask1, mask2 = scale(mask1), scale(mask2)
        image1, image2 = scale(image1), scale(image2)
        if hasattr(self, "fusion_layer"):  # each frame with its mask, as the reference
            image1 = self.fusion_layer(image1.to(dtype), mask1.to(dtype))
            image2 = self.fusion_layer(image2.to(dtype), mask2.to(dtype))
            mask1 = mask2 = None
        return self.flow_net(image1, image2, mask1, mask2, iters=iters, dtype=dtype,
                             flow_init=flow_init, dropout=dropout)

    def freeze_bn(self) -> "FFRaft":
        """Put the RAFT core's batch norms in eval mode (the reference's
        `freeze_bn`): a training forward then normalises with their running
        statistics and leaves them as they are. A conv front end's batch
        norm stays in train mode, as the JAX package freezes `flow_net`
        alone."""
        for m in self.flow_net.modules():
            if isinstance(m, Norm) and m.kind == "batch":
                m.eval()
        return self
