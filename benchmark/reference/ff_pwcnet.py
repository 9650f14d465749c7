"""FF-PWCNet's plain reference: the f32 model written from the published
PWC-Net and FocusFlow (`frozen/pwc.py`, whose docstring lists each
departure) built from a configuration file's YAML tree."""

from __future__ import annotations

from typing import Any, Dict

from .frozen.pwc import FFPWCNet, pwc_config


def build(yaml: Dict[str, Any], compute_dtype: str = "float32") -> FFPWCNet:
    """The model (f32 parameters; it computes in f32 whatever the compute
    type); its forward returns (the five flows, the flow)."""
    return FFPWCNet(pwc_config(yaml))
