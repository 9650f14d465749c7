"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch twin.

A wrapper launches its kernel for CUDA tensors and takes the plain version
only for CPU tensors; it adds one to `launch_counts[name]` per launch, so a
run can show which kernels carried it.
"""

from __future__ import annotations

launch_counts: dict[str, int] = {
    "lookup": 0, "fold": 0, "lookup_fold": 0, "in_stats": 0, "in_normalize": 0,
    "local_corr": 0, "attention": 0, "window_attention": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
