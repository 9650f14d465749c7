"""The multiscale losses of FF-PWCNet: EPE, CPCL and Mix over the
five-level flow list (finest first) that the model returns in train mode.

- Each level's target is the ground truth downsampled to the level's size
  by area interpolation (`F.adaptive_avg_pool2d`, which is
  `F.interpolate(mode="area")`). The model resizes its input to a
  multiple of 64, so a level's size need not divide the crop's
  (368x496 against a 96x128 finest level); where it does, this is the
  block mean.
- Sparse (KITTI) targets take the block max of the positive part minus
  the block max of the negative part (`F.adaptive_max_pool2d`), so an
  invalid pixel, exactly (0, 0), never blends into a valid one; a target
  of exactly (0, 0) is invalid.
- 'pretrain' mode takes the L2 norm of the error a pixel, any other mode
  the robust (|error|_1 + eps)^q.
- CPCL and Mix weight a level's error map by the keypoint mask,
  downsampled bilinearly and smeared with a Gaussian (`smear_mask`), over
  the smeared mask's mass, times h * w. Mix adds the plain sum; an empty
  mask adds nothing.

Each returns (loss, metrics): `epe`, the finest level upsampled
bilinearly to the ground truth's size against it (over the valid pixels
when sparse), and `loss`, as 0-d tensors on the device.

`reduce` (default the identity) takes every denominator: the batch size,
the masks' mass, the valid count and the pixel count of the EPE's mean.
Under data parallelism it is `train/mesh.py::Mesh.global_sum`, so a rank's
loss and metrics are its shares of the global batch's.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F

from ..ops.coords import resize_bilinear
from .sequence import _global_count, _identity, _mean, smear_mask


def area_downsample(x: torch.Tensor, hw) -> torch.Tensor:
    """(B, H, W, C) -> (B, h, w, C) by area interpolation."""
    return F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), tuple(hw)).permute(0, 2, 3, 1)


def sparse_max_pool(x: torch.Tensor, hw) -> torch.Tensor:
    """(B, H, W, C) -> (B, h, w, C): the area's largest positive value minus
    its largest negative magnitude, so zeros (invalid) never win over a
    valid value."""
    xc = x.permute(0, 3, 1, 2)
    pos = F.adaptive_max_pool2d(xc.clamp_min(0.0), tuple(hw))
    neg = F.adaptive_max_pool2d((-xc).clamp_min(0.0), tuple(hw))
    return (pos - neg).permute(0, 2, 3, 1)


def _target(flow_gt: torch.Tensor, hw, sparse: bool) -> torch.Tensor:
    return sparse_max_pool(flow_gt, hw) if sparse else area_downsample(flow_gt, hw)


def _invalid(target: torch.Tensor) -> torch.Tensor:
    return (target[..., 0] == 0) & (target[..., 1] == 0)


def _epe_map(pred, target, mode: str, q: float, eps: float) -> torch.Tensor:
    """(B, H, W): L2 norm in 'pretrain' mode, robust (L1 + eps)^q otherwise."""
    if mode == "pretrain":
        return torch.sqrt(((target - pred) ** 2).sum(-1))
    return ((target - pred).abs().sum(-1) + eps) ** q


@torch.no_grad()
def _real_epe(finest, flow_gt, mode, q, eps, sparse, reduce) -> torch.Tensor:
    m = _epe_map(resize_bilinear(finest, flow_gt.shape[1:3]), flow_gt, mode, q, eps)
    if sparse:
        valid = (~_invalid(flow_gt)).float()
        return (m * valid).sum() / reduce(valid.sum()).clamp(min=1)
    return _mean(m, tuple(range(m.ndim)), reduce)


def _mask_weights(mask: torch.Tensor, hw, kernel_size: int, sigma: float) -> torch.Tensor:
    """The keypoint mask (B, H, W, 1) downsampled bilinearly and smeared ->
    (B, h, w)."""
    return smear_mask(resize_bilinear(mask.float(), hw), kernel_size, sigma)[..., 0]


def _levels(flow_preds, weights):
    if len(weights) != len(flow_preds):
        raise ValueError(f"{len(weights)} weights for {len(flow_preds)} levels")
    return zip(flow_preds, weights)


def _metrics(flow_preds, flow_gt, loss, mode, q, eps, sparse, reduce) -> dict:
    return {"epe": _real_epe(flow_preds[0], flow_gt, mode, q, eps, sparse, reduce),
            "loss": loss.detach()}


def multiscale_epe_loss(flow_preds: Sequence[torch.Tensor], flow_gt, valid=None, mask=None,
                        *, weights: Sequence[float], mode: str = "pretrain", q: float = 0.4,
                        eps: float = 0.01, sparse: bool = False, reduce=_identity):
    """flow_preds: the levels, finest first, (B, h, w, 2) each; flow_gt
    (B, H, W, 2) -> (loss, metrics). `valid` and `mask` are not read."""
    loss = flow_preds[0].new_zeros(())
    b = _global_count(flow_gt.shape[0], loss, reduce)
    for pred, wgt in _levels(flow_preds, weights):
        _, h, w, _ = pred.shape
        target = _target(flow_gt, (h, w), sparse)
        m = _epe_map(pred, target, mode, q, eps)
        if sparse:
            m = m * (~_invalid(target))
        loss = loss + wgt * m.sum() / b
    return loss, _metrics(flow_preds, flow_gt, loss, mode, q, eps, sparse, reduce)


def multiscale_cpcl_loss(flow_preds, flow_gt, valid=None, mask=None, *, weights,
                         mode="pretrain", q=0.4, eps=0.01, kernel_size=5, sigma=1.7,
                         sparse: bool = False, reduce=_identity):
    """Each level's error map weighted by the smeared keypoint mask
    (B, H, W, 1), over the mask's mass, times h * w."""
    loss = flow_preds[0].new_zeros(())
    for pred, wgt in _levels(flow_preds, weights):
        _, h, w, _ = pred.shape
        target = _target(flow_gt, (h, w), sparse)
        mk = _mask_weights(mask, (h, w), kernel_size, sigma)
        weighted = _epe_map(pred, target, mode, q, eps) * mk
        if sparse:
            weighted = weighted * (~_invalid(target))
        loss = loss + wgt * weighted.sum() / reduce(mk.sum()).clamp(min=1e-12) * (h * w)
    return loss, _metrics(flow_preds, flow_gt, loss, mode, q, eps, sparse, reduce)


def multiscale_mix_loss(flow_preds, flow_gt, valid=None, mask=None, *, weights,
                        mode="pretrain", q=0.4, eps=0.01, kernel_size=5, sigma=1.7,
                        lamda=0.8, sparse: bool = False, reduce=_identity):
    """Per level: the error map's sum + lamda x the CPCL term (zero for an
    empty mask). The sum keeps the invalid pixels of a sparse target, as
    the reference does."""
    loss = flow_preds[0].new_zeros(())
    for pred, wgt in _levels(flow_preds, weights):
        _, h, w, _ = pred.shape
        target = _target(flow_gt, (h, w), sparse)
        m = _epe_map(pred, target, mode, q, eps)
        mk = _mask_weights(mask, (h, w), kernel_size, sigma)
        weighted = m * mk
        if sparse:
            weighted = weighted * (~_invalid(target))
        mass = reduce(mk.sum())
        term = torch.where(mass > 0, weighted.sum() / mass.clamp(min=1e-12) * (h * w),
                           torch.zeros_like(mass))
        loss = loss + wgt * (m.sum() + lamda * term)
    return loss, _metrics(flow_preds, flow_gt, loss, mode, q, eps, sparse, reduce)


def build_multiscale_loss(loss_type: str, *, weights, mode="pretrain", q=0.4, eps=0.01,
                          kernel_size=5, sigma=1.7, lamda=0.8, sparse: bool = False,
                          reduce=_identity):
    """'EPELoss', 'CPCL' or 'MixLoss' with its settings -> loss function
    (flow_preds, flow_gt, valid, mask) -> (loss, metrics); `reduce` takes
    its denominators (the module docstring)."""
    common = dict(weights=list(weights), mode=mode, q=q, eps=eps, sparse=sparse, reduce=reduce)
    if loss_type == "EPELoss":
        return functools.partial(multiscale_epe_loss, **common)
    if loss_type == "CPCL":
        return functools.partial(multiscale_cpcl_loss, kernel_size=kernel_size, sigma=sigma,
                                 **common)
    if loss_type == "MixLoss":
        return functools.partial(multiscale_mix_loss, kernel_size=kernel_size, sigma=sigma,
                                 lamda=lamda, **common)
    raise ValueError(f'"loss_type":"{loss_type}" is not supported.')
