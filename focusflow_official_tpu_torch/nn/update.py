"""RAFT update blocks: motion encoder, separable ConvGRU, flow head and the
upsample-mask head; and the small model's (`SmallUpdateBlock`: its motion
encoder, a 3x3 `ConvGRU`, a narrower flow head, no mask head).

Inside the refinement loop the hidden state, context and features are
NCHW-indexed (`channels_last` on the card). convc1 is a 1x1 conv over the
324 looked-up window channels and the window's only consumer, so the
motion encoder takes the pyramid and the coordinates and runs the lookup
and convc1 as one kernel (`kernels/lookup_fold.py`; ALT_CORR: once a
chunk of queries, `ops/corr.py::alternate_corr_fold`); the window never
reaches device memory.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.corr import lookup_convc1


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_levels: int = 4, corr_radius: int = 4):
        super().__init__()
        self.corr_radius = corr_radius
        cor_planes = corr_levels * (2 * corr_radius + 1) ** 2
        self.convc1 = nn.Conv2d(cor_planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, 1, 1)
        self.convf1 = nn.Conv2d(2, 128, 7, 1, 3)
        self.convf2 = nn.Conv2d(128, 64, 3, 1, 1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, 1, 1)

    def forward(self, flow: torch.Tensor, levels: Sequence[torch.Tensor],
                coords: torch.Tensor) -> torch.Tensor:
        """flow: (B, H, W, 2) NHWC; levels: the correlation pyramid,
        (B, H*W, H_l, W_l) each, in convc1's type, or ALT_CORR's
        `ops/corr.py::AltCorr`; coords: (B, H, W, 2) f32 level-0 (x, y)
        -> (B, 128, H, W)."""
        cor = torch.relu(_nchw(lookup_convc1(levels, coords, self.corr_radius, self.convc1)))
        cor = torch.relu(self.convc2(cor))
        flow = _nchw(flow)
        flo = torch.relu(self.convf1(flow))
        flo = torch.relu(self.convf2(flo))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class SmallMotionEncoder(nn.Module):
    def __init__(self, corr_levels: int = 4, corr_radius: int = 3):
        super().__init__()
        self.corr_radius = corr_radius
        self.convc1 = nn.Conv2d(corr_levels * (2 * corr_radius + 1) ** 2, 96, 1)
        self.convf1 = nn.Conv2d(2, 64, 7, 1, 3)
        self.convf2 = nn.Conv2d(64, 32, 3, 1, 1)
        self.conv = nn.Conv2d(128, 80, 3, 1, 1)

    def forward(self, flow, levels, coords) -> torch.Tensor:
        """As `BasicMotionEncoder.forward` -> (B, 82, H, W)."""
        cor = torch.relu(_nchw(lookup_convc1(levels, coords, self.corr_radius, self.convc1)))
        flow = _nchw(flow)
        flo = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class ConvGRU(nn.Module):
    """The small model's GRU: 3x3 gates over [h, x]."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 192 + 128):
        super().__init__()
        for gate in ("z", "r", "q"):
            self.add_module(f"conv{gate}", nn.Conv2d(hidden_dim + input_dim, hidden_dim, 3, 1, 1))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q


class SepConvGRU(nn.Module):
    """A horizontal (1x5) GRU pass, then a vertical (5x1) one."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 192 + 128):
        super().__init__()
        cin = hidden_dim + input_dim
        for suffix, kern, pad in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in ("z", "r", "q"):
                self.add_module(f"conv{gate}{suffix}",
                                nn.Conv2d(cin, hidden_dim, kern, 1, pad))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        for s in ("1", "2"):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{s}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{s}")(hx))
            q = torch.tanh(getattr(self, f"convq{s}")(torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self, input_dim: int = 128, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, 1, 1)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(torch.relu(self.conv1(x)))


class BasicUpdateBlock(nn.Module):
    def __init__(self, corr_levels: int = 4, corr_radius: int = 4,
                 hidden_dim: int = 128):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_levels, corr_radius)
        self.gru = SepConvGRU(hidden_dim, 128 + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, 256)
        self.mask_0 = nn.Conv2d(128, 256, 3, 1, 1)
        self.mask_2 = nn.Conv2d(256, 64 * 9, 1)

    def forward(self, net, inp, levels, coords, flow, mask_needed: bool = True):
        """net, inp: (B, C, H, W); levels, coords: the correlation pyramid
        and where to look it up (see `BasicMotionEncoder`); flow: (B, H, W, 2).

        Returns (net, up_mask (B, H, W, 576) or None, delta_flow (B, H, W, 2)).
        Test mode needs the upsample mask after the last iteration only, so
        the caller skips the mask head on the others."""
        motion = self.encoder(flow, levels, coords)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        delta_flow = self.flow_head(net).permute(0, 2, 3, 1)
        up_mask: Optional[torch.Tensor] = None
        if mask_needed:
            # 0.25 balances gradients into the mask (reference update.py:134)
            up_mask = 0.25 * self.mask_2(torch.relu(self.mask_0(net)))
            up_mask = up_mask.permute(0, 2, 3, 1)
        return net, up_mask, delta_flow


class SmallUpdateBlock(nn.Module):
    def __init__(self, corr_levels: int = 4, corr_radius: int = 3, hidden_dim: int = 96):
        super().__init__()
        self.encoder = SmallMotionEncoder(corr_levels, corr_radius)
        self.gru = ConvGRU(hidden_dim, 82 + 64)
        self.flow_head = FlowHead(hidden_dim, 128)

    def forward(self, net, inp, levels, coords, flow, mask_needed: bool = True):
        """As `BasicUpdateBlock.forward`; the small model has no mask head,
        so up_mask is None."""
        motion = self.encoder(flow, levels, coords)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, None, self.flow_head(net).permute(0, 2, 3, 1)
