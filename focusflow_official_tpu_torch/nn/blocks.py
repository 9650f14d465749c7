"""The 7x7/2 stem, the residual and bottleneck blocks and the three
stages of the stride-8 encoders (`nn/cce.py`'s two branches,
`nn/encoders.py`).

As in the reference, the downsample branch is normalised by the block's
`norm3` (the bottleneck's `norm4`), so checkpoint names map one to one.
The shortcut add and the final ReLU go to the block's last norm
(`Norm.forward`'s residual): with instance norm on the card they run
inside C2's launch.
"""

from __future__ import annotations

import torch
from torch import nn

from .norm import Norm


def stem(in_channels: int, features: int = 64) -> nn.Conv2d:
    """7x7, stride 2, padding 3."""
    return nn.Conv2d(in_channels, features, 7, 2, 3)


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, norm_fn: str = "group",
                 stride: int = 1):
        super().__init__()
        g = planes // 8
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1)
        self.norm1 = Norm(norm_fn, planes, g)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1)
        self.norm2 = Norm(norm_fn, planes, g)
        self.stride = stride
        if stride != 1:
            self.downsample_conv = nn.Conv2d(in_planes, planes, 1, stride, 0)
            self.norm3 = Norm(norm_fn, planes, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm1(self.conv1(x), relu=True)
        if self.stride != 1:
            x = self.norm3(self.downsample_conv(x))
        return self.norm2(self.conv2(y), relu=True, residual=x)


class BottleneckBlock(nn.Module):
    """The small model's block: a 1x1 conv to planes / 4, a 3x3 conv with
    the stride, a 1x1 conv back to planes, each normalised with a ReLU;
    relu(shortcut + that) in `norm3`'s residual form."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str = "group",
                 stride: int = 1):
        super().__init__()
        p4, g = planes // 4, planes // 8
        self.conv1 = nn.Conv2d(in_planes, p4, 1)
        self.norm1 = Norm(norm_fn, p4, g)
        self.conv2 = nn.Conv2d(p4, p4, 3, stride, 1)
        self.norm2 = Norm(norm_fn, p4, g)
        self.conv3 = nn.Conv2d(p4, planes, 1)
        self.norm3 = Norm(norm_fn, planes, g)
        self.stride = stride
        if stride != 1:
            self.downsample_conv = nn.Conv2d(in_planes, planes, 1, stride, 0)
            self.norm4 = Norm(norm_fn, planes, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm1(self.conv1(x), relu=True)
        y = self.norm2(self.conv2(y), relu=True)
        if self.stride != 1:
            x = self.norm4(self.downsample_conv(x))
        return self.norm3(self.conv3(y), relu=True, residual=x)


STAGES = ((64, 64, 1), (64, 96, 2), (96, 128, 2))  # (in, out, stride)
SMALL_STAGES = ((32, 32, 1), (32, 64, 2), (64, 96, 2))  # `SmallEncoder`'s


def add_stage(encoder: nn.Module, li: int, norm_fn: str, prefix: str = "",
              stages=STAGES, block=ResidualBlock) -> None:
    """Stage `li` (1-3) of `stages`: two blocks named `{prefix}layer{li}_0`
    and `{prefix}layer{li}_1`, the first with the stage's stride."""
    cin, cout, stride = stages[li - 1]
    encoder.add_module(f"{prefix}layer{li}_0", block(cin, cout, norm_fn, stride))
    encoder.add_module(f"{prefix}layer{li}_1", block(cout, cout, norm_fn, 1))


def run_stage(encoder: nn.Module, li: int, x: torch.Tensor, prefix: str = "") -> torch.Tensor:
    block = lambda j: getattr(encoder, f"{prefix}layer{li}_{j}")
    return block(1)(block(0)(x))
