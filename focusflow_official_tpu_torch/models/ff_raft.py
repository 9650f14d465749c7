"""FF-RAFT: keypoint-conditioned RAFT with the Condition Control Encoder,
and plain RAFT, in test mode and in train mode.

The feature encoder runs once over both frames batched together (exact
for the instance-norm fnet); the all-pairs volume and its 4-level pyramid
are built once; then `iters` refinement steps each run the update block,
whose motion encoder looks up the radius-4 window and applies convc1 in
one kernel (`kernels/lookup_fold.py`). The coordinates are detached at the
start of every step, as the reference does. Test mode convex-upsamples
only the final low-resolution flow; train mode runs the mask head on every
step and returns every step's upsampled flow, stacked.

The encoders follow the config, as the JAX package picks them:
- fnet: `ChannelProject` (`channel_pjt`) with `abandon_fnet`; else the
  CCE with `fusion='parallel'`; else an instance-norm `BasicEncoder`;
- cnet: the CCE with `fusion='parallel'` and `fuse_cnet`; else a
  batch-norm `BasicEncoder` over the image.
With `fusion=None` (plain RAFT) the masks are not read.

Train mode is the module's `training` flag (`model.train()`); the cnet's
batch norms then use the batch's statistics unless `freeze_bn()` put them
back in eval mode. The module holds its parameters in f32; a bf16 forward
takes its convolutions' weights in bf16 (`train/loop.py::compute_params`
casts them at use for training, `FlowPredictor` casts the module once for
inference).

This port covers the full-width model (`small=False`) with every CCE
fusion type (`nn/fusion_units.py`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.cce import BasicParallelFusionLayer
from ..nn.encoders import BasicEncoder, ChannelProject
from ..nn.norm import Norm
from ..nn.update import BasicUpdateBlock
from ..ops.coords import coords_grid
from ..ops.corr import all_pairs_corr, corr_pyramid
from ..ops.upsample import convex_upsample
from .config import FFRaftConfig
from .mask_modal import init_mask

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: FFRaftConfig) -> torch.dtype:
    try:
        return DTYPES[cfg.compute_dtype]
    except KeyError:
        raise ValueError(f"compute_dtype must be one of {sorted(DTYPES)}, "
                         f"got {cfg.compute_dtype!r}") from None


class RAFT(nn.Module):
    """RAFT core; its encoders as the module docstring says."""

    hdim = cdim = 128
    corr_levels, corr_radius = 4, 4

    def __init__(self, mask_channel: int = 3, fusion_type: str = "1x1conv",
                 fusion: Optional[str] = "parallel", fuse_cnet: bool = True,
                 abandon_fnet: bool = False):
        super().__init__()
        parallel = fusion == "parallel"
        if abandon_fnet:
            self.channel_pjt = ChannelProject(3, 256)
        elif parallel:
            self.fnet = BasicParallelFusionLayer(3, mask_channel, 256, "instance",
                                                 fusion_type)
        else:
            self.fnet = BasicEncoder(3, 256, "instance")
        cdim = self.hdim + self.cdim
        if parallel and fuse_cnet:
            self.cnet = BasicParallelFusionLayer(3, mask_channel, cdim, "batch",
                                                 fusion_type)
        else:
            self.cnet = BasicEncoder(3, cdim, "batch")
        self.update_block = BasicUpdateBlock(self.corr_levels, self.corr_radius,
                                             self.hdim)

    def forward(self, image1, image2, mask1=None, mask2=None, iters: int = 12,
                dtype: torch.dtype = torch.float32,
                flow_init: Optional[torch.Tensor] = None):
        """NHWC inputs scaled to [-1, 1] (masks: those the CCE encoders
        read, else None) -> (flow_lr (B, H/8, W/8, 2), flow_up
        (B, H, W, 2)), both f32; in train mode every step's upsampled
        flow, (iters, B, H, W, 2) f32. `flow_init` (B, H/8, W/8, 2), the
        warm start, is added to the starting coordinates."""
        if iters < 1:
            raise ValueError(f"iters must be >= 1, got {iters}")
        image1, image2 = image1.to(dtype), image2.to(dtype)
        if mask1 is not None:
            mask1, mask2 = mask1.to(dtype), mask2.to(dtype)

        images = torch.cat([image1, image2])
        if hasattr(self, "channel_pjt"):
            fmaps = self.channel_pjt(images)
        elif isinstance(self.fnet, BasicParallelFusionLayer):
            fmaps = self.fnet(images, torch.cat([mask1, mask2]))
        else:
            fmaps = self.fnet(images)
        fmap1, fmap2 = fmaps.float().chunk(2)
        levels = corr_pyramid(all_pairs_corr(fmap1, fmap2), self.corr_levels,
                              dtype)

        if isinstance(self.cnet, BasicParallelFusionLayer):
            cnet = self.cnet(image1, mask1)
        else:
            cnet = self.cnet(image1)
        cnet = cnet.permute(0, 3, 1, 2)
        net = torch.tanh(cnet[:, :self.hdim])
        inp = torch.relu(cnet[:, self.hdim:])

        b, h, w = fmap1.shape[:3]
        coords0 = coords_grid(b, h, w, device=fmap1.device)
        coords1 = coords0.clone() if flow_init is None else coords0 + flow_init.float()
        up_mask, flows = None, []
        for it in range(iters):
            coords1 = coords1.detach()
            flow = (coords1 - coords0).to(dtype)
            net, up_mask, delta = self.update_block(
                net, inp, levels, coords1.contiguous(), flow,
                mask_needed=self.training or it == iters - 1)
            coords1 = coords1 + delta.float()
            if self.training:
                flows.append(convex_upsample(coords1 - coords0, up_mask.float()))

        if self.training:
            return torch.stack(flows)
        flow_lr = coords1 - coords0
        return flow_lr, convex_upsample(flow_lr, up_mask.float())


class FFRaft(nn.Module):
    """Mask modality preparation (the CCE models), [-1, 1] scaling and the
    RAFT core."""

    def __init__(self, cfg: FFRaftConfig):
        super().__init__()
        if cfg.fusion not in ("parallel", None) or cfg.small:
            raise NotImplementedError(
                "this port covers fusion 'parallel' or None at full width "
                f"(small=False); got {cfg}")
        self.cfg = cfg
        self.flow_net = RAFT(cfg.mask_channel, cfg.fusion_type, cfg.fusion,
                             cfg.fuse_cnet, cfg.abandon_fnet)

    def forward(self, image1, image2, mask1, mask2,
                iters: Optional[int] = None, flow_init: Optional[torch.Tensor] = None):
        """NHWC images (0..255) and raw 0/255 masks (plain RAFT ignores
        them) -> (flow_lr, flow_up), or in train mode the stacked flows;
        `flow_init` as in `RAFT.forward`."""
        cfg = self.cfg
        if iters is None:
            iters = cfg.iters
        scale = lambda t: 2 * (t / 255.0) - 1.0
        if cfg.fusion is None:
            mask1 = mask2 = None
        else:
            mask1, mask2 = init_mask(
                image1, image2, mask1, mask2, mask_modal=cfg.mask_modal,
                mask_channel=cfg.mask_channel, mask_dilate=cfg.mask_dilate,
                kernel_size=cfg.kernel_size, kernel_sigma=cfg.kernel_sigma)
            mask1, mask2 = scale(mask1), scale(mask2)
        return self.flow_net(scale(image1), scale(image2), mask1, mask2,
                             iters=iters, dtype=compute_dtype(cfg),
                             flow_init=flow_init)

    def freeze_bn(self) -> "FFRaft":
        """Put every batch norm in eval mode (the reference's `freeze_bn`):
        a training forward then normalises with the running statistics and
        leaves them as they are."""
        for m in self.modules():
            if isinstance(m, Norm) and m.kind == "batch":
                m.eval()
        return self
