"""The validation protocol: FlyingChairs, Sintel and KITTI (AEPE,
keypoint EPE, KITTI F1).

The reference's protocol: chairs at 12 refinements with no padding
(384x512 is a multiple of 8); Sintel clean and final at 32 with the
centred 'sintel' pad to a multiple of 8; KITTI at 32 with the 'kitti' pad
(bottom rows, centred columns) at each frame's own size. The keypoint EPE
is taken over `mask1 > 0.5`; F1 is the share of pixels with EPE > 3 px and
EPE / |flow_gt| > 0.05. The `valid` map enters the metrics only for sparse
(KITTI) data: chairs and Sintel pool every pixel.

A plain loop: each pair runs one test-mode forward (`predict.eval_forward`,
so an f32 model is full f32), and its metrics are reduced on the device to
six numbers, which stay there until one transfer at the end of the
dataset. Frame means stay per-frame numbers; pixel-pooled quantities stay
(sum, count) pairs.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..ops.padding import InputPadder
from ..predict import eval_forward

_INPUTS = ("image1", "image2", "mask1", "mask2")


def model_device(model: nn.Module) -> torch.device:
    """Where the model's parameters live (the CPU for one without any)."""
    p = next(model.parameters(), None)
    return torch.device("cpu") if p is None else p.device


def frame_metrics(flow: torch.Tensor, flow_gt: torch.Tensor, valid: torch.Tensor,
                  mask1: torch.Tensor, sparse: bool) -> torch.Tensor:
    """One frame's (H, W, 2) flow against its ground truth, on the device
    -> (epe_sum, pixel count, keypoint EPE mean (NaN without keypoints),
    frame EPE mean, outlier count, pixel count), f32. Without `sparse`
    every pixel counts."""
    epe = torch.sqrt(((flow - flow_gt) ** 2).sum(-1))
    mag = torch.sqrt((flow_gt ** 2).sum(-1))
    val = valid >= 0.5 if sparse else torch.ones_like(epe, dtype=torch.bool)
    sel = (mask1[..., 0] > 0.5) & val
    n_sel = sel.sum()
    mepe = torch.where(n_sel > 0, torch.where(sel, epe, 0.0).sum() / n_sel.clamp(min=1),
                       torch.full_like(epe[0, 0], float("nan")))
    epe_sum = torch.where(val, epe, 0.0).sum()
    n_val = val.sum().float()
    out = (epe > 3.0) & ((epe / mag.clamp(min=1e-12)) > 0.05) & val
    return torch.stack([epe_sum, n_val, mepe, epe_sum / n_val, out.sum().float(), n_val])


def collect(model: nn.Module, dataset, iters: int, pad_mode: Optional[str],
            sparse: bool = False, progress: Optional[Callable] = None,
            device=None) -> np.ndarray:
    """`frame_metrics` of every sample -> (N, 6) float64. `pad_mode` None
    runs the frames as they are, else pads with `InputPadder(mode=...)`
    per frame size."""
    device = torch.device(device) if device is not None else model_device(model)
    rows = []
    for i in range(len(dataset)):
        s = dataset[i]
        ims = [torch.as_tensor(np.asarray(s[k], np.float32), device=device)[None]
               for k in _INPUTS]
        flow_gt = torch.as_tensor(np.asarray(s["flow"], np.float32), device=device)
        valid = s.get("valid")
        valid = (torch.ones(flow_gt.shape[:2], device=device) if valid is None
                 else torch.as_tensor(np.asarray(valid, np.float32), device=device))
        if pad_mode is None:
            flow, _ = eval_forward(model, *ims, iters=iters)
        else:
            padder = InputPadder(ims[0].shape, mode=pad_mode)
            flow, _ = eval_forward(model, *padder.pad(*ims), iters=iters)
            flow = padder.unpad(flow)
        rows.append(frame_metrics(flow[0].float(), flow_gt, valid, ims[2][0], sparse))
        if progress:
            progress(i, len(dataset))
    # one transfer for the whole dataset
    return torch.stack(rows).double().cpu().numpy()


def validate_chairs(model: nn.Module, dataset, mask_type: str = "orb", iters: int = 12,
                    progress: Optional[Callable] = None, device=None) -> Dict:
    m = collect(model, dataset, iters, None, progress=progress, device=device)
    return {
        "chairs": float(m[:, 0].sum() / m[:, 1].sum()),
        f"chairs-{mask_type}": float(np.nanmean(m[:, 2])),
    }


def validate_sintel(model: nn.Module, datasets: Dict[str, object], mask_type: str = "orb",
                    iters: int = 32, progress: Optional[Callable] = None,
                    device=None) -> Dict:
    """datasets: {'clean': MpiSintel(...), 'final': MpiSintel(...)} val splits."""
    results = {}
    for dstype, dataset in datasets.items():
        m = collect(model, dataset, iters, "sintel", progress=progress, device=device)
        results[f"sintel-{dstype}"] = float(m[:, 0].sum() / m[:, 1].sum())
        results[f"sintel-{dstype}-{mask_type}"] = float(np.nanmean(m[:, 2]))
    return results


def validate_kitti(model: nn.Module, dataset, mask_type: str = "orb", iters: int = 32,
                   progress: Optional[Callable] = None, device=None) -> Dict:
    """Each frame padded at its own size ('kitti' mode), as the reference
    does; `valid` selects the pixels of every metric."""
    m = collect(model, dataset, iters, "kitti", sparse=True, progress=progress,
                device=device)
    return {
        "kitti-epe": float(np.mean(m[:, 3])),  # the mean of per-frame means
        "kitti-f1": float(100 * m[:, 4].sum() / m[:, 5].sum()),
        f"kitti-{mask_type}": float(np.nanmean(m[:, 2])),
    }
