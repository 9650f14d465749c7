"""User-facing inference: config + weights -> flow.

    from focusflow_official_tpu_torch.models import FFRaftConfig, FlowFormerConfig
    from focusflow_official_tpu_torch.predict import FlowPredictor
    p = FlowPredictor(FFRaftConfig(fuse_cnet=True), "weights.npz",
                      dtype=torch.bfloat16)
    flow = p(img1, img2, mask1, mask2)   # (H, W, 2) float32 numpy
    p = FlowPredictor(FlowFormerConfig(encoder_depth=1), "weights_ff.npz")
    p = FlowPredictor(FFPWCNetConfig(), "weights_pwc.npz")
    p = FlowPredictor("configs/ff-raft/experiment/ffraft_chairs_orb.yaml",
                      "raft-chairs.pth")           # a reference checkpoint
    flows = p.sequence(frames)                     # warm-started video

The config's type picks the model: `FFRaftConfig` -> FF-RAFT,
`FlowFormerConfig` -> FF-FlowFormer, `FFPWCNetConfig` -> FF-PWCNet; with
`fusion=None` each is the paper's baseline (plain RAFT, vanilla
FlowFormer, the vanilla PWC-Net), which ignores the masks it is given. A
YAML path is read into one of them (`config.py`). Weights are an `.npz` of flat flax variables (the JAX
package's `scripts/export_fixture.py` writes one from an orbax
checkpoint) or a reference `.pth` / `.pth.tar` / `.pt`.

With a `mesh` (`train/mesh.py`, one process a card under torchrun), each
rank runs its rows of the batch (data_rank, data_rank + data, ..., the
trainer's split) inside `spatial_sharding(mesh)`, so FF-RAFT's volume is
query-sharded over the model axis, and every rank returns the whole
batch's flow.

Frames are padded (replicate) to a multiple of 8, run through the
test-mode forward and unpadded; FF-PWCNet then resizes to a multiple of 64
itself and resizes its flow back. Inputs are HWC or NHWC, uint8 or float
in 0..255, numpy or torch; masks default to zeros (no keypoint prior).
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .compat.torch_import import load_torch_pretrained
from .compat.weights import load_npz
from .config import config_from_yaml, load_yaml_config, model_from_config
from .models.ff_raft import DTYPES, compute_dtype
from .ops.coords import forward_interpolate
from .ops.padding import InputPadder
from .train.mesh import Mesh, spatial_sharding

_DTYPE_NAMES = {v: k for k, v in DTYPES.items()}
_TORCH_SUFFIXES = (".pth", ".pth.tar", ".pt")


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


def runs_f32(model: nn.Module) -> bool:
    """True where no parameter of `model` is bf16: an f32 model, whose
    forward `eval_forward` runs in full f32."""
    return not any(p.dtype == torch.bfloat16 for p in model.parameters())


def eval_forward(model: nn.Module, image1, image2, mask1, mask2, *,
                 iters: Optional[int] = None,
                 flow_init: Optional[torch.Tensor] = None):
    """One test-mode forward of a port model on NHWC f32 tensors (sizes a
    multiple of 8) -> (flow at the input's size, the low-resolution flow),
    both f32 (B, h, w, 2); a model without one gives its flow twice.

    `iters` goes to a model whose forward takes it (FF-PWCNet has no
    refinement loop), `flow_init` ((B, H/8, W/8, 2), the warm start) to the
    model as given. An f32 model (`runs_f32`) runs with TF32 off in matmuls
    and convolutions, as the JAX package computes its f32 path (`HIGHEST`
    precision), and the caller's flags are restored after the call; a bf16
    model leaves them as they are."""
    kwargs = {}
    if iters is not None and "iters" in inspect.signature(model.forward).parameters:
        kwargs["iters"] = iters
    if flow_init is not None:
        kwargs["flow_init"] = flow_init
    with torch.inference_mode(), (_no_tf32() if runs_f32(model) else contextlib.nullcontext()):
        out = model(image1, image2, mask1, mask2, **kwargs)
    if torch.is_tensor(out):
        return out, out
    flows = [o for o in out if torch.is_tensor(o)]
    full = [o for o in flows if o.shape[1:3] == image1.shape[1:3]]
    low = [o for o in flows if o.shape[1:3] != image1.shape[1:3]]
    return full[0], (low[0] if low else full[0])


def load_weights(path: str, model: nn.Module) -> dict:
    """An `.npz` of flat flax variables or a reference `.pth` / `.pth.tar` /
    `.pt` -> the state dict of `model`. An orbax checkpoint directory is
    refused: the JAX package's `scripts/export_fixture.py` turns one into
    the `.npz`."""
    path = os.fspath(path)
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory (an orbax checkpoint?): the port "
                         "reads .npz or .pth weights; the JAX package's "
                         "scripts/export_fixture.py writes the .npz")
    if path.endswith(_TORCH_SUFFIXES):
        return load_torch_pretrained(path, model)
    if path.endswith(".npz"):
        return load_npz(path)
    raise ValueError(f"{path}: expected .npz, or {', '.join(_TORCH_SUFFIXES)}")


# the modules whose parameters run in the compute type; norms and free
# parameters stay f32 and cast at use
CAST_MODULES = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)


def for_inference(model: nn.Module, dtype: torch.dtype, device) -> nn.Module:
    """`model` moved to `device` in eval mode, its `CAST_MODULES` cast to
    the compute type `dtype` (convs `channels_last`). Returns the same
    module."""
    model.to(device).eval()
    for m in model.modules():
        if isinstance(m, CAST_MODULES):
            m.to(dtype, **({} if isinstance(m, nn.Linear)
                           else {"memory_format": torch.channels_last}))
    return model


class FlowPredictor:
    """Load a config and weights once; call on frame pairs.

    cfg: a port config (`FFRaftConfig`, `FlowFormerConfig`,
    `FFPWCNetConfig`) or the path of a reference YAML. weights: see
    `load_weights`. dtype: compute type (bf16 or f32), default
    `cfg.compute_dtype`, and bf16 for a YAML (the serving type). iters:
    refinements a pair (default the config's: FF-RAFT `iters`, FF-FlowFormer
    `decoder_depth`; FF-PWCNet has none). pad_to: an (H, W) that every
    input is edge-padded to first, so mixed sizes run at one shape. Runs
    on `device` ("cuda" unless the caller asks for "cpu"), or on the
    device of `mesh`, a `train/mesh.py::Mesh`: then the batch is split over
    its data axis and the volume's queries over its model axis (module
    docstring); every rank must call the predictor with the same inputs.

    An f32 predictor is full f32 on the card (`eval_forward`); bf16 runs in
    bf16 and leaves the TF32 flags as they are."""

    def __init__(self, cfg, weights: str, *, device="cuda",
                 dtype: Optional[torch.dtype] = None, iters: Optional[int] = None,
                 pad_to: Optional[Tuple[int, int]] = None, mesh: Optional[Mesh] = None):
        if dtype is not None and dtype not in _DTYPE_NAMES:
            raise ValueError(f"dtype must be one of {list(_DTYPE_NAMES)}")
        if isinstance(cfg, (str, os.PathLike)):
            cfg = config_from_yaml(load_yaml_config(cfg),
                                   compute_dtype=_DTYPE_NAMES[dtype or torch.bfloat16])
        elif dtype is not None:
            cfg = dataclasses.replace(cfg, compute_dtype=_DTYPE_NAMES[dtype])
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else torch.device(device)
        model, cfg_iters = model_from_config(cfg)
        self.iters = iters or cfg_iters
        self.pad_to = pad_to
        model.load_state_dict(load_weights(weights, model), strict=True)
        self.model = for_inference(model, compute_dtype(cfg), self.device)

    def _pad(self, *tensors: torch.Tensor):
        """Edge-pad NHWC tensors at the bottom and right to `pad_to`."""
        if self.pad_to is None:
            return tensors
        h, w = tensors[0].shape[1:3]
        th, tw = self.pad_to
        if th < h or tw < w:
            raise ValueError(f"pad_to {self.pad_to} is smaller than the input {(h, w)}")
        return tuple(F.pad(t.permute(0, 3, 1, 2), (0, tw - w, 0, th - h), mode="replicate")
                     .permute(0, 2, 3, 1) for t in tensors)

    def forward(self, image1, image2, mask1, mask2,
                flow_init: Optional[torch.Tensor] = None):
        """NHWC f32 tensors on the device -> ((B, H, W, 2) f32 flow there,
        the low-resolution flow on the padded /8 grid, which `flow_init`
        shares)."""
        h, w = image1.shape[1:3]
        inputs = self._pad(image1, image2, mask1, mask2)
        padder = InputPadder(inputs[0].shape)
        inputs = padder.pad(*inputs)
        mesh = self.mesh
        if mesh is None:
            flow, flow_lr = eval_forward(self.model, *inputs, iters=self.iters,
                                         flow_init=flow_init)
        else:
            b = inputs[0].shape[0]
            if b < mesh.data:
                raise ValueError(f"a batch of {b} cannot split over {mesh.data} data ranks")
            rows = slice(mesh.data_rank, None, mesh.data)
            with spatial_sharding(mesh):
                flow, flow_lr = eval_forward(
                    self.model, *(t[rows] for t in inputs), iters=self.iters,
                    flow_init=None if flow_init is None else flow_init[rows])
            flow, flow_lr = mesh.gather_batch(flow, b), mesh.gather_batch(flow_lr, b)
        return padder.unpad(flow)[:, :h, :w], flow_lr

    def prepare(self, image1, image2, mask1=None, mask2=None):
        """Frames and masks as `__call__` takes them -> NHWC f32 tensors on
        the device, as `forward` takes them (no mask: zeros)."""
        i1 = _as_nhwc(image1, 3, self.device)
        i2 = _as_nhwc(image2, 3, self.device)
        zeros = lambda: torch.zeros(i1.shape[:3] + (1,), device=self.device)
        m1 = zeros() if mask1 is None else _as_nhwc(mask1, 1, self.device)
        m2 = zeros() if mask2 is None else _as_nhwc(mask2, 1, self.device)
        return i1, i2, m1, m2

    def __call__(self, image1, image2, mask1=None, mask2=None) -> np.ndarray:
        """Returns (H, W, 2) float32 for HWC inputs, (B, H, W, 2) for NHWC."""
        single = np.ndim(image1) == 3
        flow = self.forward(*self.prepare(image1, image2, mask1, mask2))[0].cpu().numpy()
        return flow[0] if single else flow

    def sequence(self, frames, masks=None, *, warm_start: bool = True) -> np.ndarray:
        """Flow of each consecutive pair of a clip: frames (T, H, W, 3) or a
        list of HWC frames, masks optional and as many -> (T-1, H, W, 2)
        float32. With `warm_start`, each pair's low-resolution flow is
        forward-splatted (`forward_interpolate`, on the host) into the next
        pair's `flow_init`, as the reference's Sintel submission does."""
        frames = list(frames)
        masks = [None] * len(frames) if masks is None else list(masks)
        if len(frames) < 2 or len(masks) != len(frames):
            raise ValueError(f"{len(frames)} frames and {len(masks)} masks: need two "
                             "or more frames and a mask for each, or none")
        flows, flow_prev = [], None
        for i in range(len(frames) - 1):
            inputs = self.prepare(frames[i], frames[i + 1], masks[i], masks[i + 1])
            init = (None if flow_prev is None
                    else torch.from_numpy(flow_prev[None]).to(self.device))
            flow, flow_lr = self.forward(*inputs, flow_init=init)
            flows.append(flow[0].cpu().numpy())
            if warm_start:
                flow_prev = forward_interpolate(flow_lr[0].cpu().numpy())
        return np.stack(flows)
