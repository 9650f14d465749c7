"""Model configurations: the fields of the reference YAML schema that the
inference and training paths read.

- `FFRaftConfig`: the MODEL and TRAIN mask sections of FF-RAFT, of plain
  RAFT (`fusion=None`), of the attention and conv front ends and of the
  small model, with ALT_CORR and dropout;
- `FFPWCNetConfig`: what FF-PWCNet reads of the same two sections;
- `FlowFormerConfig`: the fields of the `latentcostformer` block of
  FF-FlowFormer and vanilla FlowFormer (`config/ff_chairs.yaml:41-76` in
  the reference) that select a variant the JAX package runs, with its
  defaults, which equal that file.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class FFRaftConfig:
    # MODEL section
    # 'parallel' (CCE) | None (plain RAFT) | 'attention' | 'conv' (the front
    # ends of `models/frontends.py`, before a plain RAFT)
    fusion: Optional[str] = "parallel"
    # '1x1conv' | '1x1conv-unidirection' | 'concat' | 'SA' | 'CA'
    fusion_type: str = "1x1conv"
    # the front ends' output channels (the plain RAFT's input channels)
    fusion_channel: int = 256
    # RAFT-S: hdim 96, cdim 64, radius 3, `SmallEncoder`s, no convex upsample
    small: bool = False
    # the fnet is `ChannelProject` (a resize and a 1x1 conv)
    abandon_fnet: bool = False
    # the cnet is the CCE too (with fusion='parallel'); else a BasicEncoder
    fuse_cnet: bool = False
    iters: int = 12
    # training: keep the RAFT core's batch norms on their running statistics
    # (every stage but chairs, as the reference's `model.freeze_bn()`)
    freeze_bn: bool = False
    # MODEL.DROPOUT: train-mode channel dropout of the encoders' outputs
    # (`nn/dropout.py`)
    dropout: float = 0.0

    # TRAIN section (mask handling)
    mask_modal: str = "point"  # 'point'|'neighborE'|'neighborG'|'context'|'frame'
    mask_channel: int = 3
    mask_dilate: int = 31
    kernel_size: int = 31
    kernel_sigma: float = 5.0

    # MODEL.ALT_CORR: the lookup without the all-pairs volume, its queries
    # in chunks of `alt_corr_chunk` (`ops/corr.py::AltCorr`)
    alt_corr: bool = False
    alt_corr_chunk: int = 2048

    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'


@dataclasses.dataclass(frozen=True)
class FFPWCNetConfig:
    """FF-PWCNet (`fusion='parallel'`) or the vanilla PWC-Net (`fusion=None`,
    which reads only `compute_dtype`)."""

    fusion: Optional[str] = "parallel"
    # '1x1conv' | '1x1conv-unidirection' | 'concat' | 'SA' | 'CA'
    fusion_type: str = "1x1conv"

    mask_modal: str = "point"
    mask_channel: int = 3
    mask_dilate: int = 31
    kernel_size: int = 31
    kernel_sigma: float = 5.0

    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'


@dataclasses.dataclass(frozen=True)
class FlowFormerConfig:
    """FF-FlowFormer with the CCE Twins towers (`fusion='parallel'`) or
    vanilla FlowFormer with plain ones (`fusion=None`, which reads no mask
    field), with every variant of the `latentcostformer` block that the
    JAX package runs, at JAX's defaults (JAX `ff_flowformer.py:57-93`).
    One value is fixed where neither package runs another: pe 'linear',
    one cost head, no feature cross-attention, no dropout; these have no
    field. An unknown field raises TypeError."""

    fusion: Optional[str] = "parallel"  # 'parallel' | None (vanilla)

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
    patch_size: int = 8  # the cost maps' patch embed: 8 (three convs) or 4 (two)
    gma: bool = True  # the GMA update block; else `FFBasicUpdateBlock`
    vert_c_dim: int = 64
    cost_encoder_res: bool = True  # the perceiver's output adds its input layer's
    use_mlp: bool = False  # MLP-Mixer latent layers in place of self-attention
    vertical_conv: bool = False  # ConvNext vertical layers in place of attention
    only_global: bool = False  # the motion encoder reads the global cost alone
    add_flow_token: bool = True  # the decoder's query adds the flow token

    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'
