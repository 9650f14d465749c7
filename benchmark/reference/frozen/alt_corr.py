"""FF-RAFT with RAFT's alternate correlation (MODEL.ALT_CORR) in plain
PyTorch: the frozen FF-RAFT (`raft.py`) with the correlation computed from
the feature maps, never from a volume.

`AlternateCorrBlock` follows RAFT's (Teed & Deng, arXiv:2003.12039,
"Efficient Computation for High Resolution Images"; princeton-vl/RAFT
`core/corr.py`): a pyramid of fmap2 by 2x2 means with floor semantics
(`F.avg_pool2d`), then for each query the (2r+1)^2 window sampled
bilinearly from each level at coords / 2^l, zeros outside, dotted with the
query's fmap1 row over sqrt(C). By linearity this is the materialized
volume's pyramid looked up at the same window (`raft.py`), in exact
arithmetic. Departures from RAFT's description, each for a reason:

- RAFT samples in a CUDA extension (`alt_cuda_corr`); here the window's
  four bilinear taps are gathered by index and weighted, a tap outside the
  level weighted 0 (no `F.grid_sample`, whose align-corners grid has no
  scale on a level one cell wide);
- the window's taps are in the materialized lookup's order, the x offset
  the slow axis (`plain.py::_lookup_level_plain`), which the motion
  encoder's convc1 weight is laid out for;
- the queries are walked in chunks of `chunk`, so that what a chunk holds
  beyond the maps, its window features (B, n, (2r+1)^2, C) in f32, is
  about 170 MB a level at n = 2048 and C = 256, whatever the frame size;
- the dot product of a chunk's window with its fmap1 rows is one batched
  matrix product, so the fp8 control (`reference/lowp.py`) rounds its
  operands as it rounds the materialized volume's product;
- RAFT also pools fmap1, which its lookup never reads; here it is not.

The refinements are the frozen RAFT's, with the motion encoder's convc1
applied to the walked windows as a dense layer (a 1x1 conv).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .config import FFRaftConfig
from .coords import coords_grid
from .raft import RAFT, FFRaft
from .update import BasicMotionEncoder, _nchw
from .upsample import convex_upsample

CHUNK = 2048


class AlternateCorrBlock:
    """The correlation features of query chunks from NHWC feature maps
    (B, H, W, C), f32: `__call__(coords)` -> (B, H, W, L*(2r+1)^2)."""

    def __init__(self, fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int = 4,
                 radius: int = 4, chunk: int = CHUNK):
        self.fmap1, self.radius, self.chunk = fmap1.float(), radius, chunk
        level = fmap2.float().permute(0, 3, 1, 2)
        self.pyramid: List[torch.Tensor] = []
        for i in range(num_levels):
            if i:
                level = F.avg_pool2d(level, 2, stride=2)
            self.pyramid.append(level.permute(0, 2, 3, 1))  # NHWC

    def _window(self, f1: torch.Tensor, level: torch.Tensor,
                coords: torch.Tensor) -> torch.Tensor:
        """A chunk's rows f1 (B, n, C) against one level (B, h, w, C) at
        coords (B, n, 2) on that level's scale -> (B, n, (2r+1)^2)."""
        b, h, w, c = level.shape
        n = f1.shape[1]
        r = self.radius
        d = torch.arange(-r, r + 1, dtype=torch.float32, device=coords.device)
        dx, dy = d.repeat_interleave(2 * r + 1), d.repeat(2 * r + 1)
        cx, cy = coords[..., 0:1] + dx, coords[..., 1:2] + dy  # (B, n, K)
        x0, y0 = torch.floor(cx), torch.floor(cy)
        fx, fy = cx - x0, cy - y0
        rows = level.reshape(b, h * w, c)
        batch = torch.arange(b, device=coords.device)[:, None]
        window = None
        for xi, yi, wgt in ((x0, y0, (1 - fx) * (1 - fy)), (x0 + 1, y0, fx * (1 - fy)),
                            (x0, y0 + 1, (1 - fx) * fy), (x0 + 1, y0 + 1, fx * fy)):
            inside = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long().reshape(b, -1)
            tap = rows[batch, idx].reshape(b, n, -1, c) * torch.where(
                inside, wgt, torch.zeros_like(wgt))[..., None]
            window = tap if window is None else window + tap
        return torch.matmul(window, f1[..., None])[..., 0] / math.sqrt(c)

    def __call__(self, coords: torch.Tensor) -> torch.Tensor:
        b, h, w, c = self.fmap1.shape
        q = h * w
        f1 = self.fmap1.reshape(b, q, c)
        cq = coords.reshape(b, q, 2).float()
        # on the meta device (the FLOP count) nothing is held: one chunk
        chunk = q if f1.is_meta else self.chunk
        out = []
        for s in range(0, q, chunk):
            n = min(chunk, q - s)
            out.append(torch.cat([self._window(f1[:, s:s + n], level, cq[:, s:s + n] / 2 ** i)
                                  for i, level in enumerate(self.pyramid)], dim=-1))
        return torch.cat(out, dim=1).reshape(b, h, w, -1)


class AltMotionEncoder(BasicMotionEncoder):
    """The motion encoder on an `AlternateCorrBlock`'s features."""

    def forward(self, flow: torch.Tensor, corr: AlternateCorrBlock,
                coords: torch.Tensor) -> torch.Tensor:
        wc = self.convc1.weight.reshape(self.convc1.weight.shape[0], -1)
        cor = torch.relu(_nchw(F.linear(corr(coords), wc, self.convc1.bias)))
        cor = torch.relu(self.convc2(cor))
        flow = _nchw(flow)
        flo = torch.relu(self.convf1(flow))
        flo = torch.relu(self.convf2(flo))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class AltRAFT(RAFT):
    """The frozen RAFT core with `AlternateCorrBlock` in place of the
    volume (test mode only: no cell trains it)."""

    def __init__(self, mask_channel: int, fusion_type: str, chunk: int = CHUNK):
        super().__init__(mask_channel, fusion_type, fuse_cnet=True)
        self.chunk = chunk
        self.update_block.encoder = AltMotionEncoder(self.corr_levels, self.corr_radius)

    def forward(self, image1, image2, mask1, mask2, iters: int = 12,
                dtype: torch.dtype = torch.float32,
                flow_init: Optional[torch.Tensor] = None,
                dropout: Optional[Dict[str, torch.Tensor]] = None):
        """As `RAFT.forward` in test mode -> (flow_lr, flow_up), f32."""
        if self.training:
            raise ValueError("the frozen ALT_CORR FF-RAFT runs in test mode only")
        image1, image2 = image1.to(dtype), image2.to(dtype)
        mask1, mask2 = mask1.to(dtype), mask2.to(dtype)
        fmaps = self.fnet(torch.cat([image1, image2]), torch.cat([mask1, mask2]))
        corr = AlternateCorrBlock(*fmaps.float().chunk(2), self.corr_levels, self.corr_radius,
                                  self.chunk)
        cnet = self.cnet(image1, mask1).permute(0, 3, 1, 2)
        net = torch.tanh(cnet[:, :self.hdim])
        inp = torch.relu(cnet[:, self.hdim:])

        b, h, w = fmaps.shape[0] // 2, *fmaps.shape[1:3]
        coords0 = coords_grid(b, h, w, device=fmaps.device)
        coords1 = coords0.clone() if flow_init is None else coords0 + flow_init.float()
        up_mask = None
        for it in range(iters):
            flow = (coords1 - coords0).to(dtype)
            net, up_mask, delta = self.update_block(net, inp, corr, coords1.contiguous(), flow,
                                                    mask_needed=it == iters - 1)
            coords1 = coords1 + delta.float()
        flow_lr = coords1 - coords0
        return flow_lr, convex_upsample(flow_lr, up_mask.float())


class FFRaftAlt(FFRaft):
    """The frozen FF-RAFT (mask preparation, [-1, 1] scaling) around
    `AltRAFT`."""

    def __init__(self, cfg: FFRaftConfig, chunk: int = CHUNK):
        nn.Module.__init__(self)
        if (cfg.fusion != "parallel" or cfg.small or not cfg.alt_corr or cfg.abandon_fnet
                or not cfg.fuse_cnet):
            raise ValueError("the frozen ALT_CORR FF-RAFT is the CCE model at full width "
                             "with ALT_CORR")
        self.cfg = cfg
        self.flow_net = AltRAFT(cfg.mask_channel, cfg.fusion_type, chunk)
