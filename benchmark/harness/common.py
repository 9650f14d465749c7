"""What every run shares: the environment a run sets before importing the
program, the device checks, the check that no JAX module was loaded, the
comparison of each checked number with its limit, and the result line."""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

# top-level module names a run may not load: JAX, its libraries, and the
# JAX package (compared whole: the port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "focusflow_official_tpu")


def set_environment(root: Path) -> None:
    """Caches at fixed paths inside the checkout (the port's CUDA builds go
    to `build/kernels/` by themselves), and nothing that would load JAX."""
    build = root / "build"
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def forbidden_modules(names=None) -> List[str]:
    """The forbidden top-level names among `names` (default: `sys.modules`)."""
    tops = {n.split(".")[0] for n in (sys.modules if names is None else names)}
    return sorted(tops & set(FORBIDDEN))


class NoDevice(RuntimeError):
    pass


def require_cards(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device: the benchmark measures the card and never the CPU")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell needs {chips} cards, {torch.cuda.device_count()} visible")


@dataclasses.dataclass
class Outcome:
    """What a driver hands back to `run.py`."""

    attempted: int
    failed: int
    end_to_end: Dict[str, float]      # name -> value, for a --trace 0 line
    layer_ctx: Any                    # what the per-layer readers read (--trace 1)
    checks: Dict[str, float]          # number compared -> value
    memory_peak_bytes: int
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[Dict[str, list]] = None


def judge(checks: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {value, limit}}): every number at or under its limit;
    a number with no limit, or not finite, fails."""
    table, ok = {}, True
    for name, value in checks.items():
        limit = limits.get(name)
        table[name] = {"value": value, "limit": limit}
        if limit is None or not math.isfinite(value) or value > limit:
            ok = False
    return ok and bool(checks), table


def emit(result: Dict[str, Any], table: Dict[str, Dict]) -> None:
    """The numbers compared as the last lines of standard error, and the
    result as the last line of standard output (the checks its last key)."""
    for name, row in table.items():
        print(f"check {name} = {row['value']!r} (limit {row['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({**result, "checks": table}), flush=True)
