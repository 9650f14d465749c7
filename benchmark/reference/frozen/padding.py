"""Pad-to-divisible input padding for NHWC tensors (replicate padding),
frozen from the port's `ops/padding.py`.

'sintel' mode centres the pad; any other mode pads H only at the bottom
and splits W like 'sintel'.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class InputPadder:
    """Pads NHWC tensors so H and W are divisible by `divis` (default 8)."""

    def __init__(self, dims, mode: str = "sintel", divis: int = 8):
        # dims: a shape whose [-3:-1] are (H, W)
        self.ht, self.wd = dims[-3], dims[-2]
        d = divis
        pad_ht = (((self.ht // d) + 1) * d - self.ht) % d
        pad_wd = (((self.wd // d) + 1) * d - self.wd) % d
        if mode == "sintel":
            # (left, right, top, bottom)
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2,
                         pad_ht // 2, pad_ht - pad_ht // 2]
        else:
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht]

    def pad(self, *inputs: torch.Tensor):
        out = [F.pad(x.permute(0, 3, 1, 2), self._pad, mode="replicate")
               .permute(0, 2, 3, 1) for x in inputs]
        return out if len(out) > 1 else out[0]

    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        ht, wd = x.shape[-3], x.shape[-2]
        l, r, t, b = self._pad
        return x[..., t:ht - b, l:wd - r, :]
