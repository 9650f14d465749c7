"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch twin.

A wrapper launches its kernel for CUDA tensors and takes the plain version
only for CPU tensors; it calls `count_launch` once per launch, so a run can
show which kernels carried it (`launch_counts[name]`) and at which shapes
(`launch_shapes[(name, *shape)]`). LayerNorm's, the chunk pyramid's and
the chunk levels' wrappers count their launches in `launch_counts` alone
(`layer_norm.py`, `pyramid.py`, `corr_levels.py`).
"""

from __future__ import annotations

import functools

import torch

launch_counts: dict[str, int] = {
    "lookup": 0, "fold": 0, "lookup_fold": 0, "in_stats": 0, "in_normalize": 0,
    "local_corr": 0, "attention": 0, "window_attention": 0, "layer_norm": 0,
    "pyramid": 0, "corr_levels": 0}
# (name, *shape) -> launches; `shape` is what the wrapper passes: the sizes
# that tell one call site's tensors from another's, and the element type
launch_shapes: dict[tuple, int] = {}


def count_launch(name: str, *shape) -> None:
    """One launch of kernel `name` on tensors of `shape`."""
    launch_counts[name] += 1
    launch_shapes[(name, *shape)] = launch_shapes.get((name, *shape), 0) + 1


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
    launch_shapes.clear()


@functools.cache
def sm_count(device: torch.device) -> int:
    """The SM count of CUDA `device`, which sizes the persistent grids."""
    return torch.cuda.get_device_properties(device).multi_processor_count
