"""Model configurations: the fields of the reference YAML schema that the
inference paths read.

- `FFRaftConfig`: the MODEL and TRAIN mask sections of FF-RAFT;
- `FFPWCNetConfig`: what FF-PWCNet reads of the same two sections;
- `FlowFormerConfig`: the fields of FF-FlowFormer's `latentcostformer`
  block (`config/ff_chairs.yaml:41-76` in the reference) that the ported
  variant leaves free, with the JAX package's defaults, which equal that
  file.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class FFRaftConfig:
    # MODEL section
    fusion: Optional[str] = "parallel"  # 'parallel' (CCE) | None (plain RAFT)
    fusion_type: str = "1x1conv"  # '1x1conv' | '1x1conv-unidirection'
    small: bool = False
    fuse_cnet: bool = False
    iters: int = 12

    # TRAIN section (mask handling)
    mask_modal: str = "point"  # 'point'|'neighborE'|'neighborG'|'context'|'frame'
    mask_channel: int = 3
    mask_dilate: int = 31
    kernel_size: int = 31
    kernel_sigma: float = 5.0

    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'


@dataclasses.dataclass(frozen=True)
class FFPWCNetConfig:
    """FF-PWCNet (`fusion='parallel'`) or the vanilla PWC-Net (`fusion=None`,
    which reads only `compute_dtype`)."""

    fusion: Optional[str] = "parallel"
    fusion_type: str = "1x1conv"  # '1x1conv' | '1x1conv-unidirection'

    mask_modal: str = "point"
    mask_channel: int = 3
    mask_dilate: int = 31
    kernel_size: int = 31
    kernel_sigma: float = 5.0

    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'


@dataclasses.dataclass(frozen=True)
class FlowFormerConfig:
    """The fields with more than one value in use. The ported variant is
    fixed: CCE Twins towers (`fusion='parallel'`), GMA, pe 'linear', one
    cost head, patch size 8, attention latent layers, vertical local and
    global attention, the encoder residual and the flow token in the
    decoder query. An unknown field raises TypeError."""

    # mask handling (TRAIN-level in the reference FF yaml)
    mask_modal: str = "point"
    mask_channel: int = 3
    mask_dilate: int = 31
    kernel_size: int = 31
    kernel_sigma: float = 5.0

    encoder_latent_dim: int = 256
    query_latent_dim: int = 64
    cost_latent_input_dim: int = 64
    cost_latent_token_num: int = 8
    cost_latent_dim: int = 128
    encoder_depth: int = 3
    decoder_depth: int = 12  # refinement iterations (parameters are shared)
    vert_c_dim: int = 64

    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'
