"""Channel dropout of the FF-RAFT family's encoders (MODEL.DROPOUT): the
reference's `nn.Dropout2d`, the JAX package's `nn.Dropout(p,
broadcast_dims=(1, 2))` in train mode, which drops whole channels of each
sample.

It is split as `data/device_aug.py` is: `draw` takes the keep masks from
a `torch.Generator` (the trainer's, never the global RNG), and `apply` is
deterministic, so a test can apply masks it chose. A mask is (N, C) bool;
`apply` multiplies each kept channel by 1 / (1 - p) and zeroes the others.
Under data parallelism the masks are drawn for the global batch and each
rank keeps its rows (rank, rank + world, ...: the loader's stride, as
`train/loop.py::add_noise` keeps its noise).
"""

from __future__ import annotations

import torch


def draw(gen: torch.Generator, p: float, frames: int, rows: int, channels: int, *,
         world: int = 1, rank: int = 0) -> torch.Tensor:
    """Keep masks for an encoder run over `frames` frames of `rows` samples
    (the fnet's 2: both frames, batched frame after frame) -> (frames *
    rows, channels) bool on the generator's device, each channel kept with
    probability 1 - p. With `world` > 1 the draw is the global batch's
    (rows x world a frame) and the rank's rows are kept."""
    keep = torch.rand((frames, rows * world, channels), generator=gen,
                      device=gen.device) >= p
    return keep[:, rank::world].reshape(frames * rows, channels)


def apply(x: torch.Tensor, keep: torch.Tensor, p: float) -> torch.Tensor:
    """x (N, C, H, W) with the (N, C) masks `keep`: kept channels times
    1 / (1 - p) (that factor in f32, then in x's type), the rest 0."""
    scale = keep.to(torch.float32) * (1.0 / (1.0 - p))
    return x * scale.to(x.dtype)[:, :, None, None]


def maybe_apply(module: torch.nn.Module, x: torch.Tensor, keep) -> torch.Tensor:
    """An encoder's dropout: `apply` with the module's rate `dropout` in
    train mode where it is above 0; x itself otherwise. A train-mode
    forward with a rate above 0 needs its masks (`train/loop.py` draws
    them)."""
    p = module.dropout
    if not (module.training and p > 0):
        return x
    if keep is None:
        raise ValueError(f"train-mode dropout (p = {p}) needs keep masks: train/loop.py "
                         "draws them from its dropout generator")
    return apply(x, keep, p)
