"""The 7x7/2 stem and the residual block of the stride-8 encoders.

As in the reference, the downsample branch is normalised by the block's
`norm3`, so checkpoint names map one to one. The shortcut add and the
final ReLU go to `norm2` (`Norm.forward`'s residual): with instance norm
on the card they run inside C2's launch.
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
