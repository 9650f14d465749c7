"""User-facing inference: config + weights -> flow.

    from focusflow_official_tpu_torch.models import FFRaftConfig, FlowFormerConfig
    from focusflow_official_tpu_torch.predict import FlowPredictor
    p = FlowPredictor(FFRaftConfig(fuse_cnet=True), "weights.npz",
                      dtype=torch.bfloat16)
    flow = p(img1, img2, mask1, mask2)   # (H, W, 2) float32 numpy
    p = FlowPredictor(FlowFormerConfig(encoder_depth=1), "weights_ff.npz")
    p = FlowPredictor(FFPWCNetConfig(), "weights_pwc.npz")

The config's type picks the model: `FFRaftConfig` -> FF-RAFT,
`FlowFormerConfig` -> FF-FlowFormer, `FFPWCNetConfig` -> FF-PWCNet (the
vanilla PWC-Net with `fusion=None`).

Frames are padded (replicate) to a multiple of 8, run through the
test-mode forward and unpadded; FF-PWCNet then resizes to a multiple of 64
itself and resizes its flow back. Inputs are HWC or NHWC, uint8 or float
in 0..255, numpy or torch; masks default to zeros (no keypoint prior).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from .compat.weights import load_npz
from .models.config import FFPWCNetConfig, FFRaftConfig, FlowFormerConfig
from .models.ff_flowformer import FFFlowFormer
from .models.ff_pwcnet import FFPWCNet, PWCNet
from .models.ff_raft import DTYPES, FFRaft, compute_dtype
from .ops.padding import InputPadder

_DTYPE_NAMES = {v: k for k, v in DTYPES.items()}


def _as_nhwc(arr, channels: int, device) -> torch.Tensor:
    a = torch.as_tensor(np.asarray(arr) if not torch.is_tensor(arr) else arr)
    a = a.to(device=device, dtype=torch.float32)
    if a.dim() == 2:
        a = a[..., None]
    if a.dim() == 3:
        a = a[None]
    if a.dim() != 4:
        raise ValueError(f"expected HWC or NHWC, got shape {tuple(a.shape)}")
    if channels == 3 and a.shape[-1] == 1:
        a = a.repeat(1, 1, 1, 3)
    return a


# the settings that decide TF32 in cuBLAS matmuls and cuDNN convolutions
_TF32_BACKENDS = (torch.backends.cuda.matmul, torch.backends.cudnn.conv)


@contextlib.contextmanager
def _no_tf32():
    """TF32 off in cuBLAS matmuls and cuDNN convolutions inside the block
    (each backend's `fp32_precision` "ieee"); the caller's settings are put
    back on the way out, raise or not. Reading and restoring the backends'
    own settings keeps the caller's state whole, whichever API set it: the
    boolean `allow_tf32` would turn `set_float32_matmul_precision("medium")`
    into "high", and raises where the caller set `fp32_precision`."""
    saved = [b.fp32_precision for b in _TF32_BACKENDS]
    try:
        for b in _TF32_BACKENDS:
            b.fp32_precision = "ieee"
        yield
    finally:
        for b, precision in zip(_TF32_BACKENDS, saved):
            b.fp32_precision = precision


class FlowPredictor:
    """Load a config and weights once; call on frame pairs.

    weights_npz: flat flax variables as saved by the JAX package's
    `scripts/export_fixture.py`. dtype: compute type (bf16 or f32),
    default `cfg.compute_dtype`. Runs on `device` ("cuda" unless the
    caller asks for "cpu").

    An f32 predictor is full f32 on the card: its forward runs with TF32
    off in matmuls and convolutions, as the JAX package computes its f32
    path (`HIGHEST` precision), and the caller's flags are restored after
    the call. bf16 runs in bf16 and leaves the flags as they are."""

    def __init__(self, cfg: FFRaftConfig | FlowFormerConfig | FFPWCNetConfig,
                 weights_npz: str, *,
                 device="cuda", dtype: Optional[torch.dtype] = None):
        if dtype is not None:
            if dtype not in _DTYPE_NAMES:
                raise ValueError(f"dtype must be one of {list(_DTYPE_NAMES)}")
            cfg = dataclasses.replace(cfg, compute_dtype=_DTYPE_NAMES[dtype])
        self.cfg = cfg
        self.device = torch.device(device)
        # the model, and where the full-resolution flow stands in what its
        # test-mode forward returns
        if isinstance(cfg, FFRaftConfig):
            model, self._flow_at = FFRaft(cfg), 1  # (low-resolution flow, flow)
        elif isinstance(cfg, FlowFormerConfig):
            model, self._flow_at = FFFlowFormer(cfg), 1
        elif isinstance(cfg, FFPWCNetConfig):
            model = (PWCNet(compute_dtype(cfg)) if cfg.fusion is None
                     else FFPWCNet(cfg))
            self._flow_at = 0  # (flow, per-level flows)
        else:
            raise TypeError("expected FFRaftConfig, FlowFormerConfig or "
                            f"FFPWCNetConfig, got {cfg!r}")
        model.load_state_dict(load_npz(weights_npz), strict=True)
        model.to(self.device).eval()
        # convs and dense layers run in the compute type; norms and free
        # parameters stay f32 and cast at use
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                m.to(compute_dtype(cfg), memory_format=torch.channels_last)
            elif isinstance(m, nn.Linear):
                m.to(compute_dtype(cfg))
        self.model = model

    @torch.inference_mode()
    def forward(self, image1, image2, mask1, mask2) -> torch.Tensor:
        """NHWC f32 tensors on the device -> (B, H, W, 2) f32 flow there."""
        padder = InputPadder(image1.shape)
        full_f32 = compute_dtype(self.cfg) == torch.float32
        with _no_tf32() if full_f32 else contextlib.nullcontext():
            out = self.model(*padder.pad(image1, image2, mask1, mask2))
        return padder.unpad(out[self._flow_at])

    def __call__(self, image1, image2, mask1=None, mask2=None) -> np.ndarray:
        """Returns (H, W, 2) float32 for HWC inputs, (B, H, W, 2) for NHWC."""
        single = np.ndim(image1) == 3
        i1 = _as_nhwc(image1, 3, self.device)
        i2 = _as_nhwc(image2, 3, self.device)
        zeros = lambda: torch.zeros(i1.shape[:3] + (1,), device=self.device)
        m1 = zeros() if mask1 is None else _as_nhwc(mask1, 1, self.device)
        m2 = zeros() if mask2 is None else _as_nhwc(mask2, 1, self.device)
        flow = self.forward(i1, i2, m1, m2).cpu().numpy()
        return flow[0] if single else flow
