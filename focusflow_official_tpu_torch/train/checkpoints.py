"""Checkpoints of a training run, and the final weights export.

`CheckpointManager` writes one `torch.save` file a step,
`<dir>/<step>.pt`: the step, the model's state (parameters and running
statistics), the optimizer's and the schedule's states and the states of
the noise generator, of the on-card augmentation's generator and of the
dropout masks' generator, so a resumed run takes the same next step, the
same augmentation and the same dropout. It keeps
the newest five. Files are read back with `weights_only=True`. Under data
parallelism only rank 0 writes them.

`save_params_only` writes the trained weights as the flat `.npz` of flax
variables (`params/...`, `batch_stats/...`) that the fixtures use, so the
port's `--checkpoint`, `FlowPredictor` and the JAX package all load them.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..compat.weights import params_to_jax

_NAME = re.compile(r"^(\d+)\.pt$")


class CheckpointManager:
    MAX_TO_KEEP = 5

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> list:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, model: nn.Module, optimizer, scheduler,
             generator: Optional[torch.Generator] = None,
             aug_generator: Optional[torch.Generator] = None,
             dropout_generator: Optional[torch.Generator] = None) -> str:
        path = os.path.join(self.directory, f"{step}.pt")
        state = lambda g: None if g is None else g.get_state()
        torch.save(dict(step=step, model=model.state_dict(), optimizer=optimizer.state_dict(),
                        scheduler=scheduler.state_dict(), generator=state(generator),
                        aug_generator=state(aug_generator),
                        dropout_generator=state(dropout_generator)),
                   path + ".tmp")
        os.replace(path + ".tmp", path)
        for old in self.steps()[:-self.MAX_TO_KEEP]:
            os.remove(os.path.join(self.directory, f"{old}.pt"))
        return path

    def restore(self, model: nn.Module, optimizer, scheduler,
                generator: Optional[torch.Generator] = None,
                aug_generator: Optional[torch.Generator] = None,
                dropout_generator: Optional[torch.Generator] = None) -> int:
        """Load the latest checkpoint into the objects -> its step; 0 where
        there is none."""
        step = self.latest_step()
        if step is None:
            return 0
        ckpt = torch.load(os.path.join(self.directory, f"{step}.pt"), map_location="cpu",
                          weights_only=True)
        model.load_state_dict(ckpt["model"], strict=True)
        optimizer.load_state_dict(ckpt["optimizer"])
        scheduler.load_state_dict(ckpt["scheduler"])
        for gen, key in ((generator, "generator"), (aug_generator, "aug_generator"),
                         (dropout_generator, "dropout_generator")):
            if gen is not None and ckpt.get(key) is not None:
                gen.set_state(ckpt[key])
        return int(ckpt["step"])


def save_params_only(path: str, model: nn.Module) -> str:
    """The model's weights and running statistics as a flat `.npz` of flax
    variables (f32) -> the file's path (`.npz` appended if missing)."""
    if not path.endswith(".npz"):
        path += ".npz"
    np.savez(path, **params_to_jax(model.state_dict()))
    return path
