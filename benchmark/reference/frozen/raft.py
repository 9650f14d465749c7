"""FF-RAFT in plain PyTorch, frozen from the port's `models/ff_raft.py`
at the benchmark's configuration: the Condition Control Encoder (CCE,
`fusion='parallel'`) as fnet over both frames and, with `fuse_cnet`, as
cnet; the all-pairs volume in f32 and its 4-level pyramid; `iters`
refinements, each the motion encoder's lookup and convc1
(`corr.py::lookup_convc1`, plain), the separable ConvGRU and the heads;
convex 8x upsampling. Test mode returns (flow_lr, flow_up); train mode
every step's upsampled flow, stacked. The coordinates are detached at the
start of every step. The port's other variants (plain RAFT, the front
ends, RAFT-S, ALT_CORR, query sharding) are left out: no cell runs them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .cce import BasicParallelFusionLayer
from .config import FFRaftConfig, compute_dtype
from .coords import coords_grid
from .corr import all_pairs_corr, corr_pyramid
from .mask_modal import init_mask
from .norm import Norm
from .update import BasicUpdateBlock
from .upsample import convex_upsample


class RAFT(nn.Module):
    """RAFT core with CCE encoders (the module docstring)."""

    corr_levels = 4

    def __init__(self, mask_channel: int = 3, fusion_type: str = "1x1conv",
                 fuse_cnet: bool = True, dropout: float = 0.0):
        super().__init__()
        if not fuse_cnet:
            raise ValueError("the frozen FF-RAFT fuses the cnet (FUSE_CNET: true)")
        self.hdim, cdim, self.corr_radius = 128, 128, 4
        self.fnet = BasicParallelFusionLayer(3, mask_channel, 256, "instance",
                                             fusion_type, dropout)
        self.cnet = BasicParallelFusionLayer(3, mask_channel, self.hdim + cdim, "batch",
                                             fusion_type, dropout)
        self.update_block = BasicUpdateBlock(self.corr_levels, self.corr_radius, self.hdim)

    def dropout_sites(self) -> Dict[str, Tuple[int, int]]:
        """The encoders whose outputs train-mode dropout drops channels of,
        in the order they are drawn: name -> (frames, channels)."""
        return {name: (frames, getattr(self, name).conv2.out_channels)
                for name, frames in (("fnet", 2), ("cnet", 1))
                if getattr(self, name).dropout > 0}

    def forward(self, image1, image2, mask1, mask2, iters: int = 12,
                dtype: torch.dtype = torch.float32,
                flow_init: Optional[torch.Tensor] = None,
                dropout: Optional[Dict[str, torch.Tensor]] = None):
        """NHWC inputs scaled to [-1, 1] -> (flow_lr (B, H/8, W/8, 2),
        flow_up (B, H, W, 2)), both f32; in train mode every step's
        upsampled flow, (iters, B, H, W, 2) f32."""
        image1, image2 = image1.to(dtype), image2.to(dtype)
        mask1, mask2 = mask1.to(dtype), mask2.to(dtype)
        drop = dropout or {}
        fmaps = self.fnet(torch.cat([image1, image2]), torch.cat([mask1, mask2]),
                          drop.get("fnet"))
        corr = corr_pyramid(all_pairs_corr(*fmaps.float().chunk(2)), self.corr_levels, dtype)
        cnet = self.cnet(image1, mask1, drop.get("cnet")).permute(0, 3, 1, 2)
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
                flows.append(convex_upsample(coords1 - coords0, up_mask.float()))

        if self.training:
            return torch.stack(flows)
        flow_lr = coords1 - coords0
        return flow_lr, convex_upsample(flow_lr, up_mask.float())


class FFRaft(nn.Module):
    """Mask modality preparation, [-1, 1] scaling and the RAFT core."""

    def __init__(self, cfg: FFRaftConfig):
        super().__init__()
        if cfg.fusion != "parallel" or cfg.small or cfg.alt_corr or cfg.abandon_fnet:
            raise ValueError("the frozen FF-RAFT is the CCE model at full width "
                             "with the materialized volume")
        self.cfg = cfg
        self.flow_net = RAFT(cfg.mask_channel, cfg.fusion_type, cfg.fuse_cnet, cfg.dropout)

    def dropout_sites(self) -> Dict[str, Tuple[int, int]]:
        return self.flow_net.dropout_sites()

    def forward(self, image1, image2, mask1, mask2,
                iters: Optional[int] = None, flow_init: Optional[torch.Tensor] = None,
                dropout: Optional[Dict[str, torch.Tensor]] = None):
        """NHWC images (0..255) and raw 0/255 masks -> (flow_lr, flow_up),
        or in train mode the stacked flows."""
        cfg = self.cfg
        scale = lambda t: 2 * (t / 255.0) - 1.0
        mask1, mask2 = init_mask(
            image1, image2, mask1, mask2, mask_modal=cfg.mask_modal,
            mask_channel=cfg.mask_channel, mask_dilate=cfg.mask_dilate,
            kernel_size=cfg.kernel_size, kernel_sigma=cfg.kernel_sigma)
        return self.flow_net(scale(image1), scale(image2), scale(mask1), scale(mask2),
                             iters=cfg.iters if iters is None else iters,
                             dtype=compute_dtype(cfg), flow_init=flow_init,
                             dropout=dropout)

    def freeze_bn(self) -> "FFRaft":
        """The RAFT core's batch norms in eval mode (past the chairs stage)."""
        for m in self.flow_net.modules():
            if isinstance(m, Norm) and m.kind == "batch":
                m.eval()
        return self
