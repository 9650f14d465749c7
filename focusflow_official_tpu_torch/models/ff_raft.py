"""FF-RAFT inference: keypoint-conditioned RAFT with the Condition Control
Encoder, in test mode.

The feature encoder runs once over both frames batched together (exact
for the instance-norm fnet); the all-pairs volume and its 4-level pyramid
are built once; then `iters` refinement steps each run the update block,
whose motion encoder looks up the radius-4 window and applies convc1 in
one kernel (`kernels/lookup_fold.py`). Only the final low-resolution flow
is convex-upsampled.

This slice covers `fusion='parallel'`, `fuse_cnet=True`, the full-width
model (`small=False`) and the `1x1conv` fusion units.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.cce import BasicParallelFusionLayer
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
    """RAFT core with CCE feature and context encoders."""

    hdim = cdim = 128
    corr_levels, corr_radius = 4, 4

    def __init__(self, mask_channel: int = 3, fusion_type: str = "1x1conv"):
        super().__init__()
        self.fnet = BasicParallelFusionLayer(3, mask_channel, 256, "instance",
                                             fusion_type)
        self.cnet = BasicParallelFusionLayer(3, mask_channel,
                                             self.hdim + self.cdim, "batch",
                                             fusion_type)
        self.update_block = BasicUpdateBlock(self.corr_levels, self.corr_radius,
                                             self.hdim)

    def forward(self, image1, image2, mask1, mask2, iters: int = 12,
                dtype: torch.dtype = torch.float32):
        """NHWC inputs scaled to [-1, 1] -> (flow_lr (B, H/8, W/8, 2),
        flow_up (B, H, W, 2)), both f32."""
        if iters < 1:
            raise ValueError(f"iters must be >= 1, got {iters}")
        image1, image2 = image1.to(dtype), image2.to(dtype)
        mask1, mask2 = mask1.to(dtype), mask2.to(dtype)

        fmaps = self.fnet(torch.cat([image1, image2]), torch.cat([mask1, mask2]))
        fmap1, fmap2 = fmaps.float().chunk(2)
        levels = corr_pyramid(all_pairs_corr(fmap1, fmap2), self.corr_levels,
                              dtype)

        cnet = self.cnet(image1, mask1).permute(0, 3, 1, 2)
        net = torch.tanh(cnet[:, :self.hdim])
        inp = torch.relu(cnet[:, self.hdim:])

        b, h, w = fmap1.shape[:3]
        coords0 = coords_grid(b, h, w, device=fmap1.device)
        coords1 = coords0.clone()
        up_mask = None
        for it in range(iters):
            flow = (coords1 - coords0).to(dtype)
            net, up_mask, delta = self.update_block(
                net, inp, levels, coords1.contiguous(), flow,
                mask_needed=it == iters - 1)
            coords1 = coords1 + delta.float()

        flow_lr = coords1 - coords0
        return flow_lr, convex_upsample(flow_lr, up_mask.float())


class FFRaft(nn.Module):
    """Mask modality preparation, [-1, 1] scaling and the RAFT core."""

    def __init__(self, cfg: FFRaftConfig):
        super().__init__()
        if cfg.fusion != "parallel" or not cfg.fuse_cnet or cfg.small:
            raise NotImplementedError(
                "this port covers fusion='parallel', fuse_cnet=True, "
                f"small=False; got {cfg}")
        self.cfg = cfg
        self.flow_net = RAFT(cfg.mask_channel, cfg.fusion_type)

    def forward(self, image1, image2, mask1, mask2,
                iters: Optional[int] = None):
        """NHWC images (0..255) and raw 0/255 masks -> (flow_lr, flow_up)."""
        cfg = self.cfg
        if iters is None:
            iters = cfg.iters
        mask1, mask2 = init_mask(
            image1, image2, mask1, mask2, mask_modal=cfg.mask_modal,
            mask_channel=cfg.mask_channel, mask_dilate=cfg.mask_dilate,
            kernel_size=cfg.kernel_size, kernel_sigma=cfg.kernel_sigma)
        scale = lambda t: 2 * (t / 255.0) - 1.0
        return self.flow_net(scale(image1), scale(image2), scale(mask1),
                             scale(mask2), iters=iters, dtype=compute_dtype(cfg))
