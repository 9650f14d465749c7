"""FF-RAFT's plain reference: the frozen model (`frozen/raft.py`) built
from a configuration file's YAML tree."""

from __future__ import annotations

from typing import Any, Dict

from .frozen.config import raft_config
from .frozen.raft import FFRaft


def build(yaml: Dict[str, Any], compute_dtype: str = "float32") -> FFRaft:
    """The model (f32 parameters) -> its refinement count is `cfg.iters`."""
    return FFRaft(raft_config(yaml, compute_dtype))
