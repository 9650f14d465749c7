"""Benchmark submission writers: Sintel (`.flo`) and KITTI (uint16 PNG).

They read a dataset's test split (images, masks and `extra_info`) and pad
as the matching validation does. Sintel can warm-start each frame pair from
the previous pair's flow within a scene (`ops.coords.forward_interpolate`).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch
from torch import nn

from ..data.io import write_flo, write_flow_kitti
from ..ops.coords import forward_interpolate
from ..ops.padding import InputPadder
from ..predict import eval_forward
from .evaluate import model_device

_INPUTS = ("image1", "image2", "mask1", "mask2")


def _padded_inputs(sample, mode: str, device):
    ims = [torch.as_tensor(np.asarray(sample[k], np.float32), device=device)[None]
           for k in _INPUTS]
    padder = InputPadder(ims[0].shape, mode=mode)
    return padder, padder.pad(*ims)


def create_sintel_submission(model: nn.Module, datasets: Dict[str, object], output_path: str,
                             iters: int = 32, warm_start: bool = False, device=None) -> None:
    """datasets: {'clean': MpiSintel(split='testing', dstype='clean'), ...};
    writes `<output_path>/<pass>/<scene>/frameNNNN.flo`."""
    device = torch.device(device) if device is not None else model_device(model)
    for dstype, dataset in datasets.items():
        flow_prev, scene_prev = None, None
        for i in range(len(dataset)):
            s = dataset[i]
            scene, frame_id = s["extra_info"]
            if scene != scene_prev:
                flow_prev = None
            padder, args = _padded_inputs(s, "sintel", device)
            init = None if flow_prev is None else torch.from_numpy(flow_prev[None]).to(device)
            flow_up, flow_lr = eval_forward(model, *args, iters=iters, flow_init=init)
            flow = padder.unpad(flow_up)[0].cpu().numpy()
            if warm_start:
                flow_prev = forward_interpolate(flow_lr[0].cpu().numpy())
            scene_prev = scene

            out_dir = os.path.join(output_path, dstype, scene)
            os.makedirs(out_dir, exist_ok=True)
            write_flo(os.path.join(out_dir, f"frame{frame_id + 1:04d}.flo"), flow)


def create_kitti_submission(model: nn.Module, dataset, output_path: str, iters: int = 24,
                            device=None) -> None:
    """dataset: KITTI(split='testing'); writes one flow PNG per pair, named
    as its first frame."""
    device = torch.device(device) if device is not None else model_device(model)
    os.makedirs(output_path, exist_ok=True)
    for i in range(len(dataset)):
        s = dataset[i]
        (frame_id,) = s["extra_info"]
        padder, args = _padded_inputs(s, "kitti", device)
        flow_up, _ = eval_forward(model, *args, iters=iters)
        write_flow_kitti(os.path.join(output_path, frame_id),
                         padder.unpad(flow_up)[0].cpu().numpy())
