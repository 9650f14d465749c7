"""The reference training step, in plain PyTorch and f32 with TF32 off: the
chairs recipe's on-card augmentation (`frozen/device_aug.py`), the noise
augmentation (one std a step from U[0, 5), Gaussian noise clamped to
[0, 255]), the train-mode forward, the sequence loss
(`frozen/sequence_loss.py`), the backward, a zero gradient for a
parameter the loss does not reach, the clip by global norm (optax's: no
epsilon), AdamW and the OneCycle schedule (`frozen/schedule.py`), as the
reference YAML sets them. The random draws take the generators the caller
hands in, in the order the program draws them, so the two see the same
numbers.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .frozen.device_aug import DeviceFlowAugmentor, dense_recipe
from .frozen.schedule import one_cycle
from .frozen.sequence_loss import build_sequence_loss

NOISE_MAX_STD = 5.0


def optimizer_settings(yaml: Dict[str, Any]) -> Dict[str, float]:
    """lr, weight decay, eps and clip of the YAML (FF-FlowFormer: TRAINER)."""
    t = yaml.get("TRAINER")
    if t is not None:
        return dict(lr=float(t["canonical_lr"]),
                    weight_decay=float(t.get("adamw_decay", t.get("adam_decay", 1e-4))),
                    eps=float(t.get("epsilon", 1e-8)), clip=float(t.get("clip", 1.0)))
    return dict(lr=float(yaml["SCHEDULER"]["LR"]),
                weight_decay=float(yaml["OPTIMIZER"]["WEIGHT_DECAY"]),
                eps=float(yaml["OPTIMIZER"]["EPSILON"]),
                clip=float(yaml["TRAIN"].get("CLIP", 1.0)))


def loss_function(yaml: Dict[str, Any]):
    t = yaml["TRAIN"]
    return build_sequence_loss(t.get("LOSS_TYPE", "EPELoss"),
                               gamma=float(t.get("LOSS_GAMMA", 0.8)),
                               max_flow=float(t.get("MAX_FLOW", 400)),
                               kernel_size=int(t.get("LOSS_KERNEL_SIZE", 5)),
                               sigma=float(t.get("LOSS_SIGMA", 1.7)),
                               lamda=float(t.get("LOSS_LAMDA", 0.8)))


class Trainer:
    """The model, its optimizer, schedule, loss and augmentor, stepped by
    `step`."""

    def __init__(self, model: torch.nn.Module, yaml: Dict[str, Any], recipe: Tuple[float, float]):
        s = optimizer_settings(yaml)
        self.model, self.clip = model, s["clip"]
        self.optimizer = torch.optim.AdamW(model.parameters(), lr=s["lr"], betas=(0.9, 0.999),
                                           eps=s["eps"], weight_decay=s["weight_decay"])
        self.scheduler = one_cycle(self.optimizer, int(yaml["TRAIN"]["NUM_STEPS"]) + 100)
        self.loss_fn = loss_function(yaml)
        self.augment = DeviceFlowAugmentor(tuple(yaml["TRAIN"]["IMAGE_SIZE"]),
                                           recipes=[dense_recipe(*recipe)])
        self.add_noise = bool(yaml["TRAIN"].get("ADD_NOISE", False))

    def step(self, raw: Dict[str, torch.Tensor], aug_gen: torch.Generator,
             noise_gen: torch.Generator, iters: int):
        """One step on the raw batch -> (the augmented batch, the loss)."""
        model, opt = self.model, self.optimizer
        opt.zero_grad(set_to_none=True)
        batch = self.augment(aug_gen, raw)
        img1, img2 = batch["image1"], batch["image2"]
        if self.add_noise:
            std = torch.rand((), generator=noise_gen, device=img1.device) * NOISE_MAX_STD
            noisy = lambda im: (im + std * torch.randn(im.shape, generator=noise_gen,
                                                       device=im.device, dtype=im.dtype)
                                ).clamp(0.0, 255.0)
            img1, img2 = noisy(img1), noisy(img2)
        flows = model(img1, img2, batch["mask1"], batch["mask2"], iters=iters)
        loss, _ = self.loss_fn(flows, batch["flow"], batch["valid"], batch["mask1"])
        loss.backward()
        params = list(model.parameters())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(p.grad) for p in params]))
        scale = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
        for p in params:
            p.grad.mul_(scale)
        opt.step()
        self.scheduler.step()
        return batch, loss.item()
