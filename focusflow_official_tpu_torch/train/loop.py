"""One training step of any of the three families, and the optimizer it
steps.

The step (`train_step`): noise on the frames (one std a step from
U[0, 5), Gaussian noise, clamped to [0, 255], drawn from the
caller's `torch.Generator` on the device), the train-mode forward (with
the refinement count where the family has one), the loss (sequence or
multiscale), the backward, a global-norm clip of every gradient, one AdamW
step and one step of the schedule. It returns the loss's metrics and
`grad_norm`, the norm before the clip, as 0-d tensors on the device.

Precision: the model holds f32 parameters, gradients, optimizer state and
running statistics. A bf16 step casts the convolutions' weights at use
(`compute_params`, inside the autograd graph, so each gradient lands in f32
on its f32 parameter), as flax's `param_dtype=f32, dtype=bf16` does; the
norms cast their f32 parameters at use themselves. An f32 step runs its
forward and backward in full f32: TF32 off in matmuls and convolutions
(`predict.py::_no_tf32`), whatever the caller's flags.

The clip is optax's `clip_by_global_norm`: the norm over every gradient,
frozen ones included, and the gradients scaled by clip / norm where the
norm is at least `clip` (no epsilon), as the JAX trainer clips.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Mapping, Optional

import torch
from torch import nn

from ..predict import CAST_MODULES, _no_tf32

# the labels of `train/surgery.py`
LABELS = ("trainable", "encoder", "frozen")
NOISE_MAX_STD = 5.0  # the noise augmentation's std is drawn from U[0, 5)


def compute_params(model: nn.Module, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The parameters of `model`'s `CAST_MODULES` (convolutions, dense
    layers: what the predictor casts once) cast to `dtype` differentiably,
    by name, for `torch.func.functional_call`; empty for f32."""
    if dtype == torch.float32:
        return {}
    return {f"{mname}.{pname}" if mname else pname: p.to(dtype)
            for mname, m in model.named_modules() if isinstance(m, CAST_MODULES)
            for pname, p in m.named_parameters(recurse=False)}


def build_optimizer(model: nn.Module, lr: float, *, weight_decay: float = 1e-5,
                    epsilon: float = 1e-8, labels: Optional[Mapping[str, str]] = None,
                    encoder_lr_factor: float = 0.1) -> torch.optim.AdamW:
    """AdamW (betas 0.9, 0.999) over one parameter group a label of
    `labels` (name -> 'trainable', 'encoder' or 'frozen'; default all
    'trainable'): 'trainable' at `lr`, 'encoder' at lr x
    `encoder_lr_factor` (TRAIN.SEPARATE_LR's 0.1, or FF-FlowFormer's
    TRAINER.twins_lr_factor), and 'frozen' at lr 0 with no weight decay, so
    its parameters never move (optax's `set_to_zero`) while their gradients
    still count in the clip's norm."""
    factor = {"trainable": 1.0, "encoder": encoder_lr_factor, "frozen": 0.0}
    groups = {g: [] for g in LABELS}
    for name, p in model.named_parameters():
        label = "trainable" if labels is None else labels[name]
        if label not in groups:
            raise ValueError(f"{name}: label {label!r} is not one of {LABELS}")
        groups[label].append(p)
    return torch.optim.AdamW(
        [dict(params=ps, lr=lr * factor[g],
              weight_decay=0.0 if g == "frozen" else weight_decay, label=g)
         for g, ps in groups.items() if ps],
        lr=lr, betas=(0.9, 0.999), eps=epsilon, weight_decay=weight_decay)


def clip_by_global_norm(grads, clip: float) -> torch.Tensor:
    """Scale `grads` in place by clip / norm where their global norm is at
    least `clip` -> the norm before the clip (f32, on the device)."""
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


def add_noise(image: torch.Tensor, std: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """image + std * N(0, 1), clamped to [0, 255]."""
    noise = torch.randn(image.shape, generator=gen, device=image.device, dtype=image.dtype)
    return (image + std * noise).clamp(0.0, 255.0)


def forward_loss(model: nn.Module, loss_fn: Callable, batch: Mapping[str, torch.Tensor], *,
                 iters: Optional[int], dtype: torch.dtype = torch.float32,
                 noise: Optional[torch.Generator] = None):
    """The noise augmentation (with a generator), the forward in the
    compute type (given `iters` refinements; a model without a refinement
    loop, FF-PWCNet, takes None and is called without it) and the loss
    -> (loss, metrics)."""
    img1, img2 = batch["image1"], batch["image2"]
    if noise is not None:
        std = torch.rand((), generator=noise, device=img1.device) * NOISE_MAX_STD
        img1, img2 = add_noise(img1, std, noise), add_noise(img2, std, noise)
    flows = torch.func.functional_call(
        model, compute_params(model, dtype),
        (img1, img2, batch["mask1"], batch["mask2"]), {} if iters is None else {"iters": iters})
    return loss_fn(flows, batch["flow"], batch["valid"], batch["mask1"])


def forward_backward(model: nn.Module, loss_fn: Callable, batch: Mapping[str, torch.Tensor], *,
                     iters: Optional[int], dtype: torch.dtype = torch.float32,
                     noise: Optional[torch.Generator] = None):
    """`forward_loss` and the loss's backward (the gradients add into each
    parameter's `.grad`) -> (loss, metrics). In f32 both run with TF32 off
    in matmuls and convolutions, and the caller's flags are put back."""
    with _no_tf32() if dtype == torch.float32 else contextlib.nullcontext():
        loss, metrics = forward_loss(model, loss_fn, batch, iters=iters, dtype=dtype,
                                     noise=noise)
        loss.backward()
    return loss, metrics


def train_step(model: nn.Module, optimizer: torch.optim.Optimizer, scheduler,
               loss_fn: Callable, batch: Mapping[str, torch.Tensor], *, iters: Optional[int],
               dtype: torch.dtype = torch.float32, clip: float = 1.0,
               noise: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """One step on `batch` (NHWC f32 tensors on the model's device:
    image1, image2, mask1, mask2, flow, valid). `noise`: the generator of
    the noise augmentation, None for none. `model` is in train mode
    (frozen batch norms in eval mode)."""
    optimizer.zero_grad(set_to_none=True)
    _, metrics = forward_backward(model, loss_fn, batch, iters=iters, dtype=dtype, noise=noise)
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for p in params:  # a parameter the loss does not reach takes a zero gradient
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    metrics["grad_norm"] = clip_by_global_norm([p.grad for p in params], clip)
    optimizer.step()
    scheduler.step()
    return metrics
