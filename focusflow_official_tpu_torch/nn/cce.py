"""Condition Control Encoder (CCE): `BasicParallelFusionLayer`.

A BasicEncoder-shaped image branch and a mirror mask branch, stride 8,
with a bidirectional fusion unit after every stage (fusion1..4) and a
mask-to-image fusion at the output (fusion5). This is the reference form,
run unchunked over the whole image; the mask arrives with `mask_channel`
channels (tiled by `init_mask`) into a plain 7x7 stem. In train mode the
image output drops whole channels at rate `dropout` (`nn/dropout.py`), as
the JAX CCE does after fusion5.
"""

from __future__ import annotations

import torch
from torch import nn

from .blocks import STAGES, add_stage, run_stage, stem
from .dropout import maybe_apply
from .fusion_units import FusionUnit
from .norm import Norm


class BasicParallelFusionLayer(nn.Module):
    def __init__(self, img_channel: int = 3, mask_channel: int = 3,
                 output_dim: int = 128, norm_fn: str = "batch",
                 fusion_type: str = "1x1conv", dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.conv1 = stem(img_channel)
        self.mask_conv1 = stem(mask_channel)
        self.norm1 = Norm(norm_fn, 64, 8)
        self.mask_norm1 = Norm(norm_fn, 64, 8)
        self.fusion1 = FusionUnit(64, fusion_type, True)
        for li, (_, cout, _) in enumerate(STAGES, start=1):
            for prefix in ("", "mask_"):
                add_stage(self, li, norm_fn, prefix)
            self.add_module(f"fusion{li + 1}", FusionUnit(cout, fusion_type, True))
        self.conv2 = nn.Conv2d(128, output_dim, 1)
        self.mask_conv2 = nn.Conv2d(128, output_dim, 1)
        self.fusion5 = FusionUnit(output_dim, fusion_type, False)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                drop: torch.Tensor | None = None) -> torch.Tensor:
        """x: (B, H, W, img_channel), mask: (B, H, W, mask_channel), NHWC
        -> (B, H/8, W/8, output_dim) NHWC. `drop`: the (B, output_dim) keep
        masks of train-mode dropout."""
        x = x.permute(0, 3, 1, 2)
        mask = mask.permute(0, 3, 1, 2)
        mask = self.mask_norm1(self.mask_conv1(mask), relu=True)
        x = self.norm1(self.conv1(x), relu=True)
        mask, x = self.fusion1(mask, x)
        for li in range(1, len(STAGES) + 1):
            mask = run_stage(self, li, mask, "mask_")
            x = run_stage(self, li, x)
            mask, x = getattr(self, f"fusion{li + 1}")(mask, x)
        mask = self.mask_conv2(mask)
        x = self.conv2(x)
        _, x = self.fusion5(mask, x)
        return maybe_apply(self, x, drop).permute(0, 2, 3, 1)
