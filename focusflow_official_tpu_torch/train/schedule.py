"""The learning-rate schedule: the reference's OneCycle.

torch's own `OneCycleLR`, configured as the reference trainer configures
it: linear annealing, 5% warm-up from max_lr / 25 to max_lr, then down to
max_lr / (25 * 1e4), over NUM_STEPS + 100 steps, no momentum cycling.
Each parameter group cycles to its own max_lr: its lr when the optimizer
was built (`train/loop.py::build_optimizer`).
"""

from __future__ import annotations

import torch


def one_cycle(optimizer: torch.optim.Optimizer, total_steps: int,
              pct_start: float = 0.05) -> torch.optim.lr_scheduler.OneCycleLR:
    """OneCycle over `total_steps` to each group's current lr."""
    return torch.optim.lr_scheduler.OneCycleLR(
        optimizer, max_lr=[g["lr"] for g in optimizer.param_groups],
        total_steps=total_steps, pct_start=pct_start, anneal_strategy="linear",
        cycle_momentum=False)
