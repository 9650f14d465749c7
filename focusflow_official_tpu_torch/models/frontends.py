"""The paper's earlier front ends, each before a plain RAFT whose input
has `fusion_channel` channels (MODEL.FUSION):

- 'attention' (`FusionLayer`): a three-level UNet. A mask encoder over
  cat(mask, image) (`UNetMaskConvBlock`s) and an image encoder
  (`UNetConvBlock`s) whose every level fuses the mask encoder's features
  of that level through `MaskImageChannelAttentionTransformerBlock`
  (heads 1, 2, 4), a decoder with skip convs (`UNetUpBlock`s) and a
  supervised-attention head (`SAM`); `wf` channels out.
- 'conv' (`ConvFusionLayer`): a small UNet over cat(image, mask), a
  batch-norm stem and two group-norm residual stages down
  (`ConvEncoder`), two transposed-conv stages up (`ConvDecoder`).
- `ConvPromptLayer`: a small conv stack with batch norms and a 1x1
  residual, from the same reference module.

Modules take NHWC (B, H, W, C) and return NHWC; inside they run NCHW
(`channels_last` on the card). H and W must be multiples of 4.
`ConvTranspose2x` is torch's `ConvTranspose2d(k=2, s=2, p=0)`: an exact 2x
upsample, each input pixel writing its own 2x2 block.

The reference quirk stays: `UNetConvBlock` passes its image features as
the transformer's mask argument and the mask features as its image
argument, so q comes from the image branch, k and v from the mask branch,
and the block's output is the mask features plus the attention.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.attention import MaskImageChannelAttentionTransformerBlock
from ..nn.norm import Norm


def _lrelu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def ConvTranspose2x(in_ch: int, out_ch: int, bias: bool = True) -> nn.ConvTranspose2d:
    return nn.ConvTranspose2d(in_ch, out_ch, 2, 2, 0, bias=bias)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class SAM(nn.Module):
    """Supervised attention: x1 * sigmoid(conv3(img)) + x, where img =
    conv2(x) + x_img -> (that, img)."""

    def __init__(self, n_feat: int, img_channel: int = 3):
        super().__init__()
        self.conv1 = nn.Conv2d(n_feat, n_feat, 3, 1, 1)
        self.conv2 = nn.Conv2d(n_feat, img_channel, 3, 1, 1)
        self.conv3 = nn.Conv2d(img_channel, n_feat, 3, 1, 1)

    def forward(self, x, x_img):
        img = self.conv2(x) + x_img
        return self.conv1(x) * torch.sigmoid(self.conv3(img)) + x, img


class UNetConvBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, downsample: bool, relu_slope: float = 0.2,
                 num_heads: int | None = None):
        super().__init__()
        self.slope = relu_slope
        self.conv_1 = nn.Conv2d(in_ch, out_ch, 3, 1, 1)
        self.conv_2 = nn.Conv2d(out_ch, out_ch, 3, 1, 1)
        self.identity = nn.Conv2d(in_ch, out_ch, 1)
        if num_heads is not None:
            self.image_event_transformer = MaskImageChannelAttentionTransformerBlock(
                out_ch, num_heads, 4, False)
        if downsample:
            self.downsample = nn.Conv2d(out_ch, out_ch, 4, 2, 1, bias=False)

    def forward(self, x, mask_filter=None):
        """-> (the downsampled output, the output) where the block
        downsamples, else the output."""
        out = _lrelu(self.conv_2(_lrelu(self.conv_1(x), self.slope)), self.slope)
        out = out + self.identity(x)
        if mask_filter is not None:
            out = self.image_event_transformer(out, mask_filter)  # the reference quirk
        if hasattr(self, "downsample"):
            return self.downsample(out), out
        return out


class UNetMaskConvBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, downsample: bool, relu_slope: float = 0.2):
        super().__init__()
        self.slope = relu_slope
        self.conv_1 = nn.Conv2d(in_ch, out_ch, 3, 1, 1)
        self.conv_2 = nn.Conv2d(out_ch, out_ch, 3, 1, 1)
        self.identity = nn.Conv2d(in_ch, out_ch, 1)
        if downsample:
            self.downsample = nn.Conv2d(out_ch, out_ch, 4, 2, 1, bias=False)
        self.conv_before_merge = nn.Conv2d(out_ch, out_ch, 1)

    def forward(self, x):
        """-> (the downsampled output, the merge features) where the block
        downsamples, else the merge features."""
        out = _lrelu(self.conv_2(_lrelu(self.conv_1(x), self.slope)), self.slope)
        out = out + self.identity(x)
        if hasattr(self, "downsample"):
            return self.downsample(out), self.conv_before_merge(out)
        return self.conv_before_merge(out)


class UNetUpBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, relu_slope: float = 0.2):
        super().__init__()
        self.up = ConvTranspose2x(in_ch, out_ch)
        self.conv_block = UNetConvBlock(in_ch, out_ch, False, relu_slope)

    def forward(self, x, bridge):
        return self.conv_block(torch.cat([self.up(x), bridge], dim=1))


class FusionLayer(nn.Module):
    """The 'attention' front end: (image (B, H, W, img_channel), mask (B,
    H, W, mask_channel)) -> (B, H, W, wf)."""

    def __init__(self, img_channel: int = 3, mask_channel: int = 3, wf: int = 64,
                 depth: int = 3, relu_slope: float = 0.2,
                 num_heads: Sequence[int] = (1, 2, 4)):
        super().__init__()
        self.depth = depth
        self.conv_mask0 = nn.Conv2d(mask_channel + img_channel, 8, 1)
        self.conv_mask1 = nn.Conv2d(8, wf, 3, 1, 1)
        self.conv_01 = nn.Conv2d(img_channel, wf, 3, 1, 1)
        prev = wf
        for i in range(depth):
            down = i + 1 < depth
            self.add_module(f"down_path_mask_{i}",
                            UNetMaskConvBlock(prev, 2 ** i * wf, down, relu_slope))
            self.add_module(f"down_path_1_{i}",
                            UNetConvBlock(prev, 2 ** i * wf, down, relu_slope, num_heads[i]))
            prev = 2 ** i * wf
        for j, i in enumerate(reversed(range(depth - 1))):
            self.add_module(f"skip_conv_1_{j}", nn.Conv2d(2 ** i * wf, 2 ** i * wf, 3, 1, 1))
            self.add_module(f"up_path_1_{j}", UNetUpBlock(prev, 2 ** i * wf, relu_slope))
            prev = 2 ** i * wf
        self.sam12 = SAM(prev, img_channel)

    def forward(self, x, mask):
        image = _nchw(x)
        m = self.conv_mask1(self.conv_mask0(torch.cat([_nchw(mask), image], dim=1)))
        masks = []
        for i in range(self.depth):
            out = getattr(self, f"down_path_mask_{i}")(m)
            m, merge = out if isinstance(out, tuple) else (out, out)
            masks.append(merge)
        x1, encs = self.conv_01(image), []
        for i in range(self.depth):
            out = getattr(self, f"down_path_1_{i}")(x1, masks[i])
            if isinstance(out, tuple):  # a level that downsamples: its skip
                x1, skip = out
                encs.append(skip)
            else:
                x1 = out
        for j in range(self.depth - 1):
            bridge = getattr(self, f"skip_conv_1_{j}")(encs[-j - 1])
            x1 = getattr(self, f"up_path_1_{j}")(x1, bridge)
        return _nhwc(self.sam12(x1, image)[0])


class _GNResBlock(nn.Module):
    """A group-norm residual block: two 3x3 convs (the first with the
    stride), each normalised with a ReLU; the shortcut a 1x1 conv and a
    norm where the stride is not 1; relu(shortcut + that)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        g = out_ch // 8
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, stride, 1)
        self.norm1 = Norm("group", out_ch, g)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, 1, 1)
        self.norm2 = Norm("group", out_ch, g)
        self.stride = stride
        if stride != 1:
            self.downsample_conv = nn.Conv2d(in_ch, out_ch, 1, stride, 0)
            self.norm3 = Norm("group", out_ch, g)

    def forward(self, x):
        y = self.norm2(self.conv2(self.norm1(self.conv1(x), relu=True)), relu=True)
        if self.stride != 1:
            x = self.norm3(self.downsample_conv(x))
        return torch.relu(x + y)


class ConvEncoder(nn.Module):
    def __init__(self, in_ch: int, out_channels: int = 128):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, 32, 3, 1, 1)
        self.norm1 = Norm("batch", 32)
        self.block1_0 = _GNResBlock(32, 64, 2)
        self.block1_1 = _GNResBlock(64, 64, 1)
        self.block2_0 = _GNResBlock(64, 128, 2)
        self.block2_1 = _GNResBlock(128, 128, 1)
        self.conv2 = nn.Conv2d(128, out_channels, 1)

    def forward(self, x):
        """NCHW -> (features at 1/4, [the stem's, the first stage's])."""
        x = self.norm1(self.conv1(x), relu=True)
        x1 = self.block1_1(self.block1_0(x))
        x2 = self.block2_1(self.block2_0(x1))
        return self.conv2(x2), [x, x1]


class _DecoderBlock(nn.Module):
    def __init__(self, in_ch: int, skip_ch: int, out_ch: int):
        super().__init__()
        self.up = ConvTranspose2x(in_ch, out_ch)
        self.norm1 = Norm("group", out_ch, out_ch // 8)
        self.conv = nn.Conv2d(out_ch + skip_ch, out_ch, 3, 1, 1)
        self.norm2 = Norm("group", out_ch, out_ch // 8)

    def forward(self, x1, x2):
        x1 = self.norm1(self.up(x1), relu=True)
        return self.norm2(self.conv(torch.cat([x1, x2], dim=1)), relu=True)


class ConvDecoder(nn.Module):
    def __init__(self, in_ch: int = 128, out_channels: int = 32):
        super().__init__()
        self.decoder2 = _DecoderBlock(in_ch, 64, 64)
        self.decoder1 = _DecoderBlock(64, 32, 32)
        self.conv = nn.Conv2d(32, out_channels, 1)

    def forward(self, x, x_list):
        return self.conv(self.decoder1(self.decoder2(x, x_list[-1]), x_list[-2]))


class ConvFusionLayer(nn.Module):
    """The 'conv' front end: (image (B, H, W, img_channel), mask (B, H, W,
    mask_channel)) -> (B, H, W, out_channels)."""

    def __init__(self, out_channels: int, img_channel: int = 3, mask_channel: int = 3):
        super().__init__()
        self.encoder = ConvEncoder(img_channel + mask_channel, 128)
        self.decoder = ConvDecoder(128, out_channels)

    def forward(self, image, mask):
        x_down, x_list = self.encoder(torch.cat([_nchw(image), _nchw(mask)], dim=1))
        return _nhwc(self.decoder(x_down, x_list))


class ConvPromptLayer(nn.Module):
    """NHWC (B, H, W, in_channels) -> (B, H, W, out_channels)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv_0 = nn.Conv2d(in_channels, 8, 3, 1, 1)
        self.conv_2 = nn.Conv2d(8, 16, 5, 1, 2)
        self.conv_3 = Norm("batch", 16)
        self.conv_5 = nn.Conv2d(16, 8, 3, 1, 1)
        self.conv_7 = nn.Conv2d(8, 4, 3, 1, 1)
        self.conv_8 = Norm("batch", 4)
        self.conv_10 = nn.Conv2d(4, out_channels, 1)
        if in_channels != out_channels:
            self.conv0_0 = nn.Conv2d(in_channels, out_channels, 1)
            self.conv0_1 = Norm("batch", out_channels)

    def forward(self, x):
        x = _nchw(x)
        y = self.conv_3(self.conv_2(torch.relu(self.conv_0(x))), relu=True)
        y = self.conv_8(self.conv_7(torch.relu(self.conv_5(y))), relu=True)
        y = self.conv_10(y)
        if hasattr(self, "conv0_0"):
            y = y + self.conv0_1(self.conv0_0(x))
        return _nhwc(y)
