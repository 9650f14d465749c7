"""FF-RAFT with ALT_CORR's plain reference: the frozen model with RAFT's
alternate correlation (`frozen/alt_corr.py`), its queries walked in chunks,
built from a configuration file's YAML tree."""

from __future__ import annotations

from typing import Any, Dict

from .frozen.alt_corr import FFRaftAlt
from .frozen.config import raft_config


def build(yaml: Dict[str, Any], compute_dtype: str = "float32") -> FFRaftAlt:
    """The model (f32 parameters) -> its refinement count is `cfg.iters`."""
    return FFRaftAlt(raft_config(yaml, compute_dtype))
