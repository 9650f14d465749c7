"""The sequence losses of FF-RAFT (and FF-FlowFormer): EPE, CPCL and Mix.

Each takes the stacked flows of every refinement step, (N, B, H, W, 2),
and weighs step i by gamma^(N - i - 1). Pixels count where `valid` >= 0.5
and |flow_gt| < max_flow.

- EPE: the mean of the valid L1 error over pixels and both components;
- CPCL (Conditional Point Control Loss): the valid L1 error weighted by the
  binarised keypoint mask smeared with a Gaussian (`smear_mask`), over the
  smeared mask's mass;
- Mix: EPE + lamda * CPCL.

Each returns (loss, metrics). The metrics are of the last step's flow over
the valid pixels: `epe`, `1px`, `3px`, `5px` (the share of pixels whose
end-point error is below 1, 3, 5 px), `loss`, and for CPCL and Mix the
keypoint EPE `kpt_epe` (valid pixels where the raw mask is > 0).

`reduce` (default the identity) takes every denominator: the mask's mass,
the valid count and the element count of the EPE's mean, each a sum over
a count. Under data parallelism it is `train/mesh.py::Mesh.global_sum`, so
a rank's loss and metrics are its shares of the global batch's, which add
up over the ranks; one card runs the same sums through the identity.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..models.mask_modal import gaussian_kernel


def _valid_mask(flow_gt: torch.Tensor, valid: torch.Tensor, max_flow: float) -> torch.Tensor:
    """(B, H, W) bool: valid pixels with |flow_gt| below max_flow."""
    mag = torch.sqrt((flow_gt ** 2).sum(-1))
    return (valid >= 0.5) & (mag < max_flow)


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def _seq_weights(n: int, gamma: float, device) -> torch.Tensor:
    return torch.tensor([gamma ** (n - i - 1) for i in range(n)], dtype=torch.float32,
                        device=device)


def smear_mask(mask: torch.Tensor, kernel_size: int, sigma: float) -> torch.Tensor:
    """The keypoint mask (B, H, W, 1), raw 0/255, binarised and convolved
    with the normalised Gaussian, zero padding -> (B, H, W, 1) f32."""
    m = (mask > 0).float().permute(0, 3, 1, 2)
    k = torch.as_tensor(gaussian_kernel(kernel_size, sigma), device=mask.device)
    out = F.conv2d(m, k[None, None], padding=kernel_size // 2)
    return out.permute(0, 2, 3, 1)


@torch.no_grad()
def _metrics(flow_preds, flow_gt, v, loss, mask=None, reduce=_identity) -> dict:
    epe = torch.sqrt(((flow_preds[-1] - flow_gt) ** 2).sum(-1))
    vf = v.float()
    n = reduce(vf.sum()).clamp(min=1)
    out = {"epe": (epe * vf).sum() / n, "loss": loss.detach()}
    for px in (1, 3, 5):
        out[f"{px}px"] = ((epe < px).float() * vf).sum() / n
    if mask is not None:
        sel = vf * (mask[..., 0] > 0).float()
        out["kpt_epe"] = (epe * sel).sum() / reduce(sel.sum()).clamp(min=1)
    return out


def _global_count(n: int, like: torch.Tensor, reduce):
    """The count `n` (a 0-d tensor like `like`) summed over the ranks by
    `reduce`."""
    return reduce(like.new_full((), float(n)))


def _mean(x: torch.Tensor, dims, reduce) -> torch.Tensor:
    """x's sum over `dims` over the global element count."""
    return x.sum(dim=dims) / _global_count(math.prod(x.shape[d] for d in dims), x, reduce)


def epe_loss(flow_preds, flow_gt, valid, mask=None, *, gamma=0.8, max_flow=400.0,
             reduce=_identity):
    """flow_preds (N, B, H, W, 2), flow_gt (B, H, W, 2), valid (B, H, W)
    -> (loss, metrics)."""
    v = _valid_mask(flow_gt, valid, max_flow)
    w = _seq_weights(flow_preds.shape[0], gamma, flow_preds.device)
    diff = (flow_preds - flow_gt[None]).abs()
    per_pred = _mean(v[None, ..., None] * diff, (1, 2, 3, 4), reduce)
    loss = (w * per_pred).sum()
    return loss, _metrics(flow_preds, flow_gt, v, loss, reduce=reduce)


def cpcl_loss(flow_preds, flow_gt, valid, mask, *, gamma=0.8, max_flow=400.0,
              kernel_size=5, sigma=1.7, reduce=_identity):
    """As `epe_loss`, the error weighted by the smeared keypoint `mask`
    (B, H, W, 1) over its mass."""
    v = _valid_mask(flow_gt, valid, max_flow)
    w = _seq_weights(flow_preds.shape[0], gamma, flow_preds.device)
    m = smear_mask(mask, kernel_size, sigma)
    diff = (flow_preds - flow_gt[None]).abs()
    weighted = v[None, ..., None] * m[None] * diff
    per_pred = weighted.sum(dim=(1, 2, 3, 4)) / reduce(m.sum()).clamp(min=1e-12)
    loss = (w * per_pred).sum()
    return loss, _metrics(flow_preds, flow_gt, v, loss, mask, reduce)


def mix_loss(flow_preds, flow_gt, valid, mask, *, gamma=0.8, max_flow=400.0,
             kernel_size=5, sigma=1.7, lamda=0.8, reduce=_identity):
    """EPE + lamda * CPCL."""
    v = _valid_mask(flow_gt, valid, max_flow)
    w = _seq_weights(flow_preds.shape[0], gamma, flow_preds.device)
    m = smear_mask(mask, kernel_size, sigma)
    vdiff = v[None, ..., None] * (flow_preds - flow_gt[None]).abs()
    cpcl_per = (m[None] * vdiff).sum(dim=(1, 2, 3, 4)) / reduce(m.sum()).clamp(min=1e-12)
    epe_per = _mean(vdiff, (1, 2, 3, 4), reduce)
    loss = (w * (lamda * cpcl_per + epe_per)).sum()
    return loss, _metrics(flow_preds, flow_gt, v, loss, mask, reduce)


def build_sequence_loss(loss_type: str, *, gamma=0.8, max_flow=400.0,
                        kernel_size=5, sigma=1.7, lamda=0.8, reduce=_identity):
    """'EPELoss', 'CPCL' or 'MixLoss' with its settings -> loss function
    (flow_preds, flow_gt, valid, mask) -> (loss, metrics); `reduce` takes
    its denominators (the module docstring)."""
    if loss_type == "EPELoss":
        return functools.partial(epe_loss, gamma=gamma, max_flow=max_flow, reduce=reduce)
    if loss_type == "CPCL":
        return functools.partial(cpcl_loss, gamma=gamma, max_flow=max_flow,
                                 kernel_size=kernel_size, sigma=sigma, reduce=reduce)
    if loss_type == "MixLoss":
        return functools.partial(mix_loss, gamma=gamma, max_flow=max_flow,
                                 kernel_size=kernel_size, sigma=sigma, lamda=lamda,
                                 reduce=reduce)
    raise ValueError(f'"loss_type":"{loss_type}" is not supported.')
