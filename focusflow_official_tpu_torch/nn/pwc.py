"""PWC-Net building blocks: extractor, CCE extractor, decoder, refiner.

A 6-level conv pyramid (16/32/64/96/128/196 channels, each level half the
size of the one before), coarse-to-fine DenseNet-style decoders fed by the
81-channel local cost volume (kernel D), and a dilated-conv context
refiner. Module names are the flax ones (`netOne_0`, `mask_netOne_0`,
`fusion1`, `netUpflow`, `netMain_0`, ...), so checkpoints map one to one.

Public inputs and outputs are NHWC. Inside, convolutions see NCHW-indexed
views (`channels_last` on the card), so a feature map permuted back to
NHWC is contiguous, which is what kernel D takes.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.local_corr import local_corr
from ..ops.warp import backwarp
from .fusion_units import FusionUnit

_LEVEL_DIMS = (16, 32, 64, 96, 128, 196)
_LEVEL_NAMES = ("netOne", "netTwo", "netThr", "netFou", "netFiv", "netSix")
_SLOPE = 0.1  # every leaky ReLU of the PWC nets


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=_SLOPE)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _add_stage(module: nn.Module, in_dim: int, out_dim: int, prefix: str) -> None:
    """Three 3x3 convs `<prefix>_0`, `_2`, `_4` on `module`; the first has
    stride 2."""
    module.add_module(f"{prefix}_0", nn.Conv2d(in_dim, out_dim, 3, 2, 1))
    module.add_module(f"{prefix}_2", nn.Conv2d(out_dim, out_dim, 3, 1, 1))
    module.add_module(f"{prefix}_4", nn.Conv2d(out_dim, out_dim, 3, 1, 1))


def _stage(module: nn.Module, x: torch.Tensor, prefix: str) -> torch.Tensor:
    for i in (0, 2, 4):
        x = lrelu(getattr(module, f"{prefix}_{i}")(x))
    return x


class PWCExtractor(nn.Module):
    """6-level feature pyramid of one frame."""

    def __init__(self, in_dim: int = 3):
        super().__init__()
        for dim, name in zip(_LEVEL_DIMS, _LEVEL_NAMES):
            _add_stage(self, in_dim, dim, name)
            in_dim = dim

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """(B, H, W, 3) -> six (B, H/2^l, W/2^l, C_l), l = 1..6."""
        x = _nchw(x)
        feats = []
        for name in _LEVEL_NAMES:
            x = _stage(self, x, name)
            feats.append(_nhwc(x))
        return tuple(feats)


class PWCFusionExtractor(nn.Module):
    """CCE extractor: mirrored mask stages and a fusion unit after each
    level (`fusion1`-`fusion5` bidirectional, `fusion6` mask-to-image)."""

    def __init__(self, fusion_type: str = "1x1conv", in_dim: int = 3,
                 mask_dim: int = 3):
        super().__init__()
        for i, (dim, name) in enumerate(zip(_LEVEL_DIMS, _LEVEL_NAMES)):
            _add_stage(self, in_dim, dim, name)
            _add_stage(self, mask_dim, dim, f"mask_{name}")
            self.add_module(f"fusion{i + 1}", FusionUnit(dim, fusion_type, i < 5))
            in_dim = mask_dim = dim

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """x (B, H, W, 3), mask (B, H, W, mask_dim) -> six image feature maps."""
        x, mask = _nchw(x), _nchw(mask)
        feats = []
        for i, name in enumerate(_LEVEL_NAMES):
            x = _stage(self, x, name)
            mask = _stage(self, mask, f"mask_{name}")
            mask, x = getattr(self, f"fusion{i + 1}")(mask, x)
            feats.append(_nhwc(x))
        return tuple(feats)


# the previous level's flow, in pixels of this level's warp
_BACKWARP_SCALE = {5: 0.625, 4: 1.25, 3: 2.5, 2: 5.0}
_DENSE = (("netOne", 128), ("netTwo", 128), ("netThr", 96), ("netFou", 64),
          ("netFiv", 32))


def _input_dim(level: int) -> int:
    """Channels into a level's conv stack: the volume alone at level 6, else
    [volume, this level's features, up-sampled flow, up-sampled features]."""
    return 81 if level == 6 else 81 + _LEVEL_DIMS[level - 1] + 2 + 2


class PWCDecoder(nn.Module):
    """One coarse-to-fine level: up-sample the previous level's flow and
    features (4x4 transposed convs, stride 2), warp the second frame's
    features by that flow, take the 81-channel local cost volume, and run a
    DenseNet conv stack down to a 2-channel flow."""

    def __init__(self, level: int):
        super().__init__()
        self.level = level
        if level < 6:
            prev_dim = _input_dim(level + 1) + sum(c for _, c in _DENSE)
            self.netUpflow = nn.ConvTranspose2d(2, 2, 4, 2, 1)
            self.netUpfeat = nn.ConvTranspose2d(prev_dim, 2, 4, 2, 1)
        dim = _input_dim(level)
        for name, c in _DENSE:
            self.add_module(f"{name}_0", nn.Conv2d(dim, c, 3, 1, 1))
            dim += c
        self.netSix_0 = nn.Conv2d(dim, 2, 3, 1, 1)
        self.feat_dim = dim

    def forward(self, ten_one: torch.Tensor, ten_two: torch.Tensor,
                prev: Optional[tuple[torch.Tensor, torch.Tensor]]):
        """ten_one, ten_two: (B, h, w, C) NHWC features of this level; prev:
        the level above's (flow (B, 2, h/2, w/2), feat (B, F, h/2, w/2)),
        NCHW-indexed, or None at the coarsest level.
        Returns (flow (B, 2, h, w), feat (B, feat_dim, h, w)), NCHW-indexed."""
        d = ten_one.dtype
        if prev is None:
            feat = _nchw(local_corr(ten_one, ten_two, 4, negative_slope=_SLOPE))
        else:
            prev_flow, prev_feat = prev
            flow = self.netUpflow(prev_flow)
            feat_up = self.netUpfeat(prev_feat)
            warped = backwarp(ten_two, _nhwc(flow).float() * _BACKWARP_SCALE[self.level])
            volume = _nchw(local_corr(ten_one, warped.to(d), 4, negative_slope=_SLOPE))
            feat = torch.cat([volume, _nchw(ten_one), flow, feat_up], dim=1)
        for name, _ in _DENSE:
            y = lrelu(getattr(self, f"{name}_0")(feat))
            feat = torch.cat([y, feat], dim=1)  # new channels first
        return self.netSix_0(feat), feat


class PWCRefiner(nn.Module):
    """Dilated context network over the finest level's features."""

    _SPEC = ((128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1), (2, 1))

    def __init__(self, in_dim: int = 565):
        super().__init__()
        for i, (c, dil) in enumerate(self._SPEC):
            self.add_module(f"netMain_{2 * i}",
                            nn.Conv2d(in_dim, c, 3, 1, dil, dilation=dil))
            in_dim = c

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        """(B, in_dim, h, w) -> (B, 2, h, w)."""
        x = feat
        last = len(self._SPEC) - 1
        for i in range(last + 1):
            x = getattr(self, f"netMain_{2 * i}")(x)
            if i < last:
                x = lrelu(x)
        return x
