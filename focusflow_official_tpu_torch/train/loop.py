"""One training step of any of the three families, and the optimizer it
steps.

The step (`train_step`): the on-card augmentation of a raw batch where
given (`data/device_aug.py`, from its own generator), noise on the frames
(one std a step from U[0, 5), Gaussian noise, clamped to [0, 255], drawn
from the caller's `torch.Generator` on the device), the keep masks of the
encoders' channel dropout where the model has a rate above 0 (FF-RAFT's
MODEL.DROPOUT; `nn/dropout.py`, from a generator of their own), the
train-mode forward (with the refinement count where the family has one),
the loss (sequence or multiscale), the backward, a global-norm clip of
every gradient, one AdamW step and one step of the schedule. It returns
the loss's metrics and `grad_norm`, the norm before the clip, as 0-d
tensors on the device.

Under data parallelism (a `train/mesh.py::Mesh`) the step is the global
batch's: the augmentation, the noise and the dropout draw the global
batch's random quantities on every rank and keep the rank's rows; a
parameter the loss does not reach takes a zero gradient, then the
gradients are summed over the ranks (the loss, built with
`reduce=mesh.global_sum`, is the rank's share), then clipped by their
global norm; the metrics are summed over the ranks, so every rank returns
the global batch's.

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

from ..nn import dropout as channel_dropout
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


def add_noise(image: torch.Tensor, std: torch.Tensor, gen: torch.Generator, *,
              world: int = 1, rank: int = 0) -> torch.Tensor:
    """image + std * N(0, 1), clamped to [0, 255]. With `world` > 1 the
    noise is drawn for the global batch (world x image's batch) and the
    rank's rows (rank, rank + world, ...: the loader's stride) are kept."""
    shape = (image.shape[0] * world, *image.shape[1:])
    noise = torch.randn(shape, generator=gen, device=image.device, dtype=image.dtype)
    return (image + std * noise[rank::world]).clamp(0.0, 255.0)


def _shard(mesh) -> dict:
    return dict(world=1, rank=0) if mesh is None else dict(world=mesh.world, rank=mesh.rank)


def draw_dropout(model: nn.Module, gen: torch.Generator, batch: int, *, world: int = 1,
                 rank: int = 0) -> Dict[str, torch.Tensor]:
    """The keep masks of `model`'s train-mode channel dropout for a batch
    of `batch` samples (the global batch's, the rank's rows kept, under
    `world` > 1) -> {site: (frames x batch, channels) bool}; empty, and
    nothing drawn, for a model in eval mode or without dropout."""
    sites = model.dropout_sites() if hasattr(model, "dropout_sites") else {}
    if not model.training or not sites:
        return {}
    return {name: channel_dropout.draw(gen, model.cfg.dropout, frames, batch, channels,
                                       world=world, rank=rank)
            for name, (frames, channels) in sites.items()}


def forward_loss(model: nn.Module, loss_fn: Callable, batch: Mapping[str, torch.Tensor], *,
                 iters: Optional[int], dtype: torch.dtype = torch.float32,
                 noise: Optional[torch.Generator] = None, mesh=None,
                 dropout: Optional[torch.Generator] = None):
    """The noise augmentation (with a generator; the global batch's under
    `mesh`), the dropout masks (`draw_dropout` from the generator
    `dropout`), the forward in the compute type (given `iters` refinements;
    a model without a refinement loop, FF-PWCNet, takes None and is called
    without it) and the loss -> (loss, metrics)."""
    img1, img2 = batch["image1"], batch["image2"]
    if noise is not None:
        std = torch.rand((), generator=noise, device=img1.device) * NOISE_MAX_STD
        img1 = add_noise(img1, std, noise, **_shard(mesh))
        img2 = add_noise(img2, std, noise, **_shard(mesh))
    kwargs = {} if iters is None else {"iters": iters}
    if dropout is not None:
        masks = draw_dropout(model, dropout, img1.shape[0], **_shard(mesh))
        if masks:
            kwargs["dropout"] = masks
    flows = torch.func.functional_call(
        model, compute_params(model, dtype), (img1, img2, batch["mask1"], batch["mask2"]),
        kwargs)
    return loss_fn(flows, batch["flow"], batch["valid"], batch["mask1"])


def forward_backward(model: nn.Module, loss_fn: Callable, batch: Mapping[str, torch.Tensor], *,
                     iters: Optional[int], dtype: torch.dtype = torch.float32,
                     noise: Optional[torch.Generator] = None, mesh=None,
                     dropout: Optional[torch.Generator] = None):
    """`forward_loss` and the loss's backward (the gradients add into each
    parameter's `.grad`) -> (loss, metrics). In f32 both run with TF32 off
    in matmuls and convolutions, and the caller's flags are put back."""
    with _no_tf32() if dtype == torch.float32 else contextlib.nullcontext():
        loss, metrics = forward_loss(model, loss_fn, batch, iters=iters, dtype=dtype,
                                     noise=noise, mesh=mesh, dropout=dropout)
        loss.backward()
    return loss, metrics


def train_step(model: nn.Module, optimizer: torch.optim.Optimizer, scheduler,
               loss_fn: Callable, batch: Mapping[str, torch.Tensor], *, iters: Optional[int],
               dtype: torch.dtype = torch.float32, clip: float = 1.0,
               noise: Optional[torch.Generator] = None, augment: Optional[Callable] = None,
               aug_gen: Optional[torch.Generator] = None, mesh=None,
               dropout: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """One step on `batch` (NHWC f32 tensors on the model's device:
    image1, image2, mask1, mask2, flow, valid; raw frames with optional
    valid, sizes and recipe where `augment` is given). `noise`: the
    generator of the noise augmentation, None for none. `augment`: a
    `DeviceFlowAugmentor`, drawing from `aug_gen`. `dropout`: the generator
    of the dropout masks (needed where the model has a rate above 0).
    `mesh`: this rank's `train/mesh.py::Mesh` under data parallelism, else
    None. `model` is in train mode (frozen batch norms in eval mode)."""
    optimizer.zero_grad(set_to_none=True)
    if augment is not None:  # a profiler range of its own: its share of the step
        with torch.profiler.record_function("device_aug"):
            batch = augment(aug_gen, batch, **_shard(mesh))
    _, metrics = forward_backward(model, loss_fn, batch, iters=iters, dtype=dtype, noise=noise,
                                  mesh=mesh, dropout=dropout)
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for p in params:  # a parameter the loss does not reach takes a zero gradient
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if mesh is not None:
        mesh.all_reduce_grads([p.grad for p in params])
        names = sorted(metrics)
        metrics = dict(zip(names, mesh.global_sum(torch.stack([metrics[k] for k in names]))))
    metrics["grad_norm"] = clip_by_global_norm([p.grad for p in params], clip)
    optimizer.step()
    scheduler.step()
    return metrics
