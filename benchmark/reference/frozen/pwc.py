"""FF-PWCNet in plain PyTorch, in f32, written from the published models:
PWC-Net (Sun et al., arXiv:1709.02371, in its common PyTorch form) with
FocusFlow's Condition Control Encoder (arXiv:2308.07104,
`config/ff-pwcnet/*.yaml`, `FUSION: parallel`). NCHW inside, NHWC at the
edges.

- The frames and the raw masks are resized to a multiple of 64 (bilinear,
  half-pixel centres), then the mask modality is applied to the resized
  masks; the frames stay raw 0..255 (this family scales nothing).
- A six-level extractor (16/32/64/96/128/196 channels, three 3x3 convs a
  level, the first with stride 2, leaky ReLU 0.1 after each) runs on the
  frame and, mirrored, on the mask; after each level a fusion unit
  (`fusion_units.py`: both ways at levels 1-5, mask to image at level 6).
- Five decoders, levels 6 to 2. Below level 6 the previous flow and
  features are up-sampled by 4x4 transposed convs (stride 2), the second
  frame's features are warped backward by the flow times 0.625, 1.25, 2.5
  or 5.0 (`backwarp`: `F.grid_sample` on the published normalised grid,
  with a ones channel thresholded at 0.999). The cost volume is the
  81-channel local correlation (radius 4): 81 shifted f32 products summed
  over channels and scaled by 1/C, then a leaky ReLU. A DenseNet stack of
  128/128/96/64/32 channels puts each new map in front of its input; a 3x3
  conv gives the flow.
- A dilated refiner (128/128/128/96/64/32/2 at dilations 1/2/4/8/16/1/1)
  adds to the level-2 flow, which is resized back to the input's size and
  scaled by (w / nw, h / nh).

Departures from the published model: the forward is the test mode's
alone and returns (the five flows finest first, NHWC f32; the flow at the
input's size); there is no training mode, no checkpoint loader and no
vanilla PWC-Net (`FUSION: null`); the correlation is the plain product in
place of the published CUDA kernel (the same sums); every tensor is f32.
Module names are the port's, so its state loads as it is.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import _mask_fields
from .coords import resize_bilinear
from .fusion_units import FusionUnit
from .mask_modal import init_mask

LEVEL_DIMS = (16, 32, 64, 96, 128, 196)
LEVEL_NAMES = ("netOne", "netTwo", "netThr", "netFou", "netFiv", "netSix")
DENSE = (("netOne", 128), ("netTwo", 128), ("netThr", 96), ("netFou", 64), ("netFiv", 32))
BACKWARP = {5: 0.625, 4: 1.25, 3: 2.5, 2: 5.0}
REFINER = ((128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1), (2, 1))
RADIUS = 4
SLOPE = 0.1


@dataclasses.dataclass(frozen=True)
class PWCConfig:
    fusion_type: str = "1x1conv"
    mask_modal: str = "point"
    mask_channel: int = 3
    mask_dilate: int = 31
    kernel_size: int = 31
    kernel_sigma: float = 5.0


def pwc_config(yaml: Dict[str, Any]) -> PWCConfig:
    """FF-PWCNet's fields from a reference YAML tree (nested dicts)."""
    m = yaml["MODEL"]
    if m.get("FUSION", "parallel") != "parallel":
        raise ValueError("the frozen FF-PWCNet is the CCE model (FUSION: parallel)")
    return PWCConfig(fusion_type=m.get("FUSION_TYPE", "1x1conv"), **_mask_fields(yaml["TRAIN"]))


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, SLOPE)


def correlation(one: torch.Tensor, two: torch.Tensor, radius: int = RADIUS) -> torch.Tensor:
    """(B, C, H, W) maps -> (B, (2r+1)^2, H, W): channel (dy+r)(2r+1) + (dx+r)
    is the mean over channels of one times two shifted by (dy, dx), zero
    outside two."""
    _, c, h, w = one.shape
    padded = F.pad(two, (radius, radius, radius, radius))
    k = 2 * radius + 1
    return torch.stack([(one * padded[:, :, dy:dy + h, dx:dx + w]).sum(1)
                        for dy in range(k) for dx in range(k)], 1) / c


def backwarp(two: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The published backward warp: `two` (B, C, H, W) sampled at the pixel
    centres' grid moved by `flow` (B, 2, H, W) over (size - 1) / 2, zero
    outside; a pixel whose warped ones channel falls under 0.999 is zeroed."""
    b, _, h, w = two.shape
    hor = torch.linspace(-1.0 + 1.0 / w, 1.0 - 1.0 / w, w, device=two.device)
    ver = torch.linspace(-1.0 + 1.0 / h, 1.0 - 1.0 / h, h, device=two.device)
    grid = torch.stack([hor.view(1, w).expand(h, w), ver.view(h, 1).expand(h, w)])[None]
    flow = torch.cat([flow[:, 0:1] / ((w - 1.0) / 2.0), flow[:, 1:2] / ((h - 1.0) / 2.0)], 1)
    out = F.grid_sample(torch.cat([two, two.new_ones(b, 1, h, w)], 1),
                        (grid + flow).permute(0, 2, 3, 1), mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out[:, :-1] * (out[:, -1:] > 0.999).to(out.dtype)


def _add_stage(module: nn.Module, in_dim: int, out_dim: int, prefix: str) -> None:
    module.add_module(f"{prefix}_0", nn.Conv2d(in_dim, out_dim, 3, 2, 1))
    module.add_module(f"{prefix}_2", nn.Conv2d(out_dim, out_dim, 3, 1, 1))
    module.add_module(f"{prefix}_4", nn.Conv2d(out_dim, out_dim, 3, 1, 1))


def _stage(module: nn.Module, x: torch.Tensor, prefix: str) -> torch.Tensor:
    for i in (0, 2, 4):
        x = lrelu(getattr(module, f"{prefix}_{i}")(x))
    return x


class FusionExtractor(nn.Module):
    """The image and mask pyramids, fused after each level -> six image maps."""

    def __init__(self, fusion_type: str, mask_dim: int):
        super().__init__()
        in_dim = 3
        for i, (dim, name) in enumerate(zip(LEVEL_DIMS, LEVEL_NAMES)):
            _add_stage(self, in_dim, dim, name)
            _add_stage(self, mask_dim, dim, f"mask_{name}")
            self.add_module(f"fusion{i + 1}", FusionUnit(dim, fusion_type, i < 5))
            in_dim = mask_dim = dim

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for i, name in enumerate(LEVEL_NAMES):
            x = _stage(self, x, name)
            mask = _stage(self, mask, f"mask_{name}")
            mask, x = getattr(self, f"fusion{i + 1}")(mask, x)
            feats.append(x)
        return feats


def _input_dim(level: int) -> int:
    return 81 if level == 6 else 81 + LEVEL_DIMS[level - 1] + 4


class Decoder(nn.Module):
    def __init__(self, level: int):
        super().__init__()
        self.level = level
        if level < 6:
            self.netUpflow = nn.ConvTranspose2d(2, 2, 4, 2, 1)
            self.netUpfeat = nn.ConvTranspose2d(
                _input_dim(level + 1) + sum(c for _, c in DENSE), 2, 4, 2, 1)
        dim = _input_dim(level)
        for name, c in DENSE:
            self.add_module(f"{name}_0", nn.Conv2d(dim, c, 3, 1, 1))
            dim += c
        self.netSix_0 = nn.Conv2d(dim, 2, 3, 1, 1)

    def forward(self, one, two, prev):
        if prev is None:
            feat = lrelu(correlation(one, two))
        else:
            flow = self.netUpflow(prev[0])
            up = self.netUpfeat(prev[1])
            volume = lrelu(correlation(one, backwarp(two, flow * BACKWARP[self.level])))
            feat = torch.cat([volume, one, flow, up], 1)
        for name, _ in DENSE:
            feat = torch.cat([lrelu(getattr(self, f"{name}_0")(feat)), feat], 1)
        return self.netSix_0(feat), feat


class Refiner(nn.Module):
    def __init__(self, in_dim: int = 565):
        super().__init__()
        for i, (c, dil) in enumerate(REFINER):
            self.add_module(f"netMain_{2 * i}", nn.Conv2d(in_dim, c, 3, 1, dil, dilation=dil))
            in_dim = c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(REFINER)):
            x = getattr(self, f"netMain_{2 * i}")(x)
            if i < len(REFINER) - 1:
                x = lrelu(x)
        return x


class FFPWCNet(nn.Module):
    """The module docstring's model, test mode."""

    def __init__(self, cfg: PWCConfig):
        super().__init__()
        self.cfg = cfg
        self.netExtractor = FusionExtractor(cfg.fusion_type, cfg.mask_channel)
        for level, name in zip((6, 5, 4, 3, 2), LEVEL_NAMES[::-1][:5]):
            self.add_module(name, Decoder(level))
        self.netRefiner = Refiner()

    def forward(self, image1, image2, mask1, mask2) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """NHWC frames (0..255) and raw 0/255 masks -> (the five flows finest
        first, (B, h, w, 2) at each level; the flow (B, H, W, 2))."""
        cfg = self.cfg
        _, h, w, _ = image1.shape
        nh, nw = (h + 63) // 64 * 64, (w + 63) // 64 * 64
        one, two, mask1, mask2 = (resize_bilinear(t.float(), (nh, nw))
                                  for t in (image1, image2, mask1, mask2))
        mask1, mask2 = init_mask(one, two, mask1, mask2, mask_modal=cfg.mask_modal,
                                 mask_channel=cfg.mask_channel, mask_dilate=cfg.mask_dilate,
                                 kernel_size=cfg.kernel_size, kernel_sigma=cfg.kernel_sigma)
        nchw = lambda t: t.permute(0, 3, 1, 2)
        feats1 = self.netExtractor(nchw(one), nchw(mask1))
        feats2 = self.netExtractor(nchw(two), nchw(mask2))
        prev, flows = None, []
        for idx, name in zip((5, 4, 3, 2, 1), LEVEL_NAMES[::-1][:5]):
            prev = getattr(self, name)(feats1[idx], feats2[idx], prev)
            flows.insert(0, prev[0])
        flows[0] = flows[0] + self.netRefiner(prev[1])
        flows = [f.permute(0, 2, 3, 1) for f in flows]
        flow = resize_bilinear(flows[0], (h, w))
        return flows, flow * torch.tensor([w / nw, h / nh], device=flow.device)
