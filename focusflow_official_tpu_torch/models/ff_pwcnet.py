"""FF-PWCNet: keypoint-conditioned PWC-Net, and the vanilla PWC-Net.

- Frames (and, in FF mode, masks) are resized to a multiple of 64
  (bilinear, half-pixel centres); at test time the flow is resized back and
  scaled by the size ratio.
- FF mode applies the mask modality after the resize and feeds raw 0-255
  images: this family has no [-1, 1] scaling.
- The coarse-to-fine chain runs levels 6 to 2, each through a `PWCDecoder`
  (one launch of kernel D a level), then the refiner adds to the level-2
  flow.

The forward returns (flow, flows): the test-mode flow (B, H, W, 2) at the
input's size, and the five-level list (finest first, level 2 refined) in
pixels of the resized frames at each level's scale, all f32.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.pwc import PWCDecoder, PWCExtractor, PWCFusionExtractor, PWCRefiner
from ..ops.coords import resize_bilinear
from .config import FFPWCNetConfig
from .ff_raft import compute_dtype
from .mask_modal import init_mask


def _padded_size(h: int, w: int) -> tuple[int, int]:
    return (h + 63) // 64 * 64, (w + 63) // 64 * 64


class _PWCBase(nn.Module):
    """The decoders and the refiner, shared by both variants."""

    def __init__(self):
        super().__init__()
        for lvl, name in ((6, "netSix"), (5, "netFiv"), (4, "netFou"),
                          (3, "netThr"), (2, "netTwo")):
            self.add_module(name, PWCDecoder(lvl))
        self.netRefiner = PWCRefiner(self.netTwo.feat_dim)

    def _decode(self, feats1, feats2, orig_hw, new_hw):
        h, w = orig_hw
        nh, nw = new_hw
        prev = None
        flows = []
        for idx, name in ((5, "netSix"), (4, "netFiv"), (3, "netFou"),
                          (2, "netThr"), (1, "netTwo")):
            prev = getattr(self, name)(feats1[idx], feats2[idx], prev)
            flows.insert(0, prev[0])
        flows[0] = flows[0] + self.netRefiner(prev[1])
        flows = [f.permute(0, 2, 3, 1).float() for f in flows]
        out = resize_bilinear(flows[0], (h, w))
        out = out * torch.tensor([w / nw, h / nh], device=out.device)
        return out, flows


class PWCNet(_PWCBase):
    """Vanilla PWC-Net: no masks."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.netExtractor = PWCExtractor()

    def forward(self, image1, image2, mask1=None, mask2=None):
        """NHWC images (0..255) -> (flow (B, H, W, 2), five-level list). The
        masks are accepted, so both variants are called alike, and ignored."""
        _, h, w, _ = image1.shape
        new_hw = _padded_size(h, w)
        ten_one = resize_bilinear(image1, new_hw).to(self.dtype)
        ten_two = resize_bilinear(image2, new_hw).to(self.dtype)
        return self._decode(self.netExtractor(ten_one), self.netExtractor(ten_two),
                            (h, w), new_hw)


class FFPWCNet(_PWCBase):
    """CCE extractor and mask modalities around the PWC-Net decoders."""

    def __init__(self, cfg: FFPWCNetConfig):
        super().__init__()
        if cfg.fusion != "parallel":
            raise ValueError(f"FFPWCNet needs fusion='parallel', got {cfg.fusion!r}; "
                             "fusion=None is the vanilla PWCNet")
        self.cfg = cfg
        self.netExtractor = PWCFusionExtractor(cfg.fusion_type, 3, cfg.mask_channel)

    def forward(self, image1, image2, mask1, mask2):
        """NHWC images (0..255) and raw 0/255 masks -> (flow (B, H, W, 2),
        five-level list)."""
        cfg = self.cfg
        d = compute_dtype(cfg)
        _, h, w, _ = image1.shape
        new_hw = _padded_size(h, w)
        ten_one = resize_bilinear(image1, new_hw)
        ten_two = resize_bilinear(image2, new_hw)
        mask1 = resize_bilinear(mask1, new_hw)
        mask2 = resize_bilinear(mask2, new_hw)
        mask1, mask2 = init_mask(
            ten_one, ten_two, mask1, mask2, mask_modal=cfg.mask_modal,
            mask_channel=cfg.mask_channel, mask_dilate=cfg.mask_dilate,
            kernel_size=cfg.kernel_size, kernel_sigma=cfg.kernel_sigma)
        feats1 = self.netExtractor(ten_one.to(d), mask1.to(d))
        feats2 = self.netExtractor(ten_two.to(d), mask2.to(d))
        return self._decode(feats1, feats2, (h, w), new_hw)
