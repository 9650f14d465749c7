"""The stride-8 encoders of plain RAFT and of the small model.

- `BasicEncoder`: the 7x7/2 stem, `norm1` with ReLU, the three residual
  stages of `nn/blocks.py` (64, 96, 128 channels; strides 1, 2, 2) and a
  1x1 `conv2`: the image branch of the CCE (`nn/cce.py`) alone, built from
  the same stage code. Its norms are
  `nn/norm.py::Norm` ('instance': kernels C1 and C2 on the card; 'batch';
  'none').
- `SmallEncoder` (SMALL): the same with a 32-channel stem and three
  stages of `BottleneckBlock`s (32, 64, 96 channels).
- `ChannelProject` (ABANDON_FNET): a half-pixel bilinear resize to H/8 x
  W/8, then a 1x1 `conv1`.

Each takes NHWC (B, H, W, C) and returns NHWC (B, H/8, W/8, output_dim).
`BasicEncoder` and `SmallEncoder` drop whole channels of `conv2`'s output
in train mode at rate `dropout` (`nn/dropout.py`; `drop`: the keep masks
the trainer drew), as the JAX encoders do.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.coords import resize_bilinear
from .blocks import SMALL_STAGES, STAGES, BottleneckBlock, add_stage, run_stage, stem
from .dropout import maybe_apply
from .norm import Norm


class BasicEncoder(nn.Module):
    def __init__(self, in_channel: int = 3, output_dim: int = 128,
                 norm_fn: str = "batch", dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.conv1 = stem(in_channel)
        self.norm1 = Norm(norm_fn, 64, 8)
        for li in range(1, len(STAGES) + 1):
            add_stage(self, li, norm_fn)
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x: torch.Tensor, drop: torch.Tensor | None = None) -> torch.Tensor:
        x = self.norm1(self.conv1(x.permute(0, 3, 1, 2)), relu=True)
        for li in range(1, len(STAGES) + 1):
            x = run_stage(self, li, x)
        return maybe_apply(self, self.conv2(x), drop).permute(0, 2, 3, 1)


class SmallEncoder(nn.Module):
    def __init__(self, in_channel: int = 3, output_dim: int = 128,
                 norm_fn: str = "batch", dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.conv1 = stem(in_channel, 32)
        self.norm1 = Norm(norm_fn, 32, 8)
        for li in range(1, len(SMALL_STAGES) + 1):
            add_stage(self, li, norm_fn, stages=SMALL_STAGES, block=BottleneckBlock)
        self.conv2 = nn.Conv2d(96, output_dim, 1)

    forward = BasicEncoder.forward


class ChannelProject(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        x = resize_bilinear(x, (h // 8, w // 8)).permute(0, 3, 1, 2)
        return self.conv1(x).permute(0, 2, 3, 1)
