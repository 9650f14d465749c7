"""FF-FlowFormer's plain reference: the frozen model
(`frozen/flowformer.py`) built from a configuration file's YAML tree."""

from __future__ import annotations

from typing import Any, Dict

from .frozen.config import flowformer_config
from .frozen.flowformer import FFFlowFormer


def build(yaml: Dict[str, Any], compute_dtype: str = "float32") -> FFFlowFormer:
    """The model (f32 parameters); its refinements are `cfg.decoder_depth`."""
    return FFFlowFormer(flowformer_config(yaml, compute_dtype))
