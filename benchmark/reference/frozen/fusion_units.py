"""Mask <-> image fusion units of the Condition Control Encoder (NCHW).

The reference's five interchangeable units, each wrapped bi- or
uni-directionally by `FusionUnit`:

- `Conv1x1`: q + conv1x1(v), the published unit;
- `Concat`: conv1x1([q, v]), which replaces q rather than adding to it;
- `SA`: spatial attention, sigmoid(conv3x3([mean_c, max_c] of q1)) gates
  conv3x3(v), plus q (no biases);
- `CA`: channel attention, c_map(avg_hw q1) + c_map(max_hw q1) (two
  sigmoids, reduction 16) gates conv3x3(v), plus q;
- '1x1conv-unidirection': `Conv1x1` mask-to-image only.

SA and CA read q1 = conv3x3([q, v]). Module names are the JAX package's
(`conv_v_0`, `c_map_0`, ...), which `compat/torch_import.py` maps to the
reference's `nn.Sequential` keys (`conv_v.0`, `c_map.0`, ...).
"""

from __future__ import annotations

import torch
from torch import nn


class Conv1x1(nn.Module):
    """q + conv1x1(v)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 1)

    def forward(self, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return q + self.conv(v)


class Concat(nn.Module):
    """conv1x1([q, v])."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(2 * channels, channels, 1)

    def forward(self, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return self.conv(torch.cat([q, v], dim=1))


class SA(nn.Module):
    """sigmoid(s_map([mean_c q1, max_c q1])) * conv_v(v) + q."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv_q = nn.Conv2d(2 * channels, channels, 3, 1, 1, bias=False)
        self.conv_v_0 = nn.Conv2d(channels, channels, 3, 1, 1, bias=False)
        self.s_map_0 = nn.Conv2d(2, 1, 3, 1, 1, bias=False)

    def forward(self, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        q1 = self.conv_q(torch.cat([q, v], dim=1))
        stats = torch.cat([q1.mean(dim=1, keepdim=True),
                           q1.amax(dim=1, keepdim=True)], dim=1)
        return torch.sigmoid(self.s_map_0(stats)) * self.conv_v_0(v) + q


class CA(nn.Module):
    """(c_map(avg_hw q1) + c_map(max_hw q1)) * conv_v(v) + q, where c_map
    is sigmoid(1x1(relu(1x1 to channels / reduction)))."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.conv_q = nn.Conv2d(2 * channels, channels, 3, 1, 1)
        self.conv_v_0 = nn.Conv2d(channels, channels, 3, 1, 1)
        self.c_map_0 = nn.Conv2d(channels, channels // reduction, 1)
        self.c_map_2 = nn.Conv2d(channels // reduction, channels, 1)

    def _c_map(self, t: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.c_map_2(torch.relu(self.c_map_0(t))))

    def forward(self, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        q1 = self.conv_q(torch.cat([q, v], dim=1))
        gate = (self._c_map(q1.mean(dim=(2, 3), keepdim=True))
                + self._c_map(q1.amax(dim=(2, 3), keepdim=True)))
        return gate * self.conv_v_0(v) + q


_FUSION_OPS = {"1x1conv": Conv1x1, "concat": Concat, "SA": SA, "CA": CA}
FUSION_TYPES = (*_FUSION_OPS, "1x1conv-unidirection")


class FusionUnit(nn.Module):
    """Returns (mask_out, img_out): img_out = op(img, mask) and, both ways,
    mask_out = op(mask, img); each direction reads the inputs as given.
    '1x1conv-unidirection' forces `Conv1x1` mask-to-image only."""

    def __init__(self, channels: int, fusion_type: str = "1x1conv",
                 bi_direction: bool = True):
        super().__init__()
        if fusion_type == "1x1conv-unidirection":
            fusion_type, bi_direction = "1x1conv", False
        if fusion_type not in _FUSION_OPS:
            raise ValueError(f"Fusion type {fusion_type} not supported.")
        op = _FUSION_OPS[fusion_type]
        self.mask2img = op(channels)
        self.img2mask = op(channels) if bi_direction else None

    def forward(self, mask: torch.Tensor, img: torch.Tensor):
        img_out = self.mask2img(img, mask)
        mask_out = mask if self.img2mask is None else self.img2mask(mask, img)
        return mask_out, img_out
