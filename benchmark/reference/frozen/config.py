"""The two model configurations the frozen models read, frozen from the
port's `models/config.py`, and their reading from the reference YAML
schema (the port's `config.py`): `FFRaftConfig` (FF-RAFT's MODEL and TRAIN
mask sections) and `FlowFormerConfig` (FF-FlowFormer's `latentcostformer`
block). A key this benchmark's files do not set keeps the YAML reader's
default.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch


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
    gma: bool = True  # the GMA update block
    vert_c_dim: int = 64
    cost_encoder_res: bool = True  # the perceiver's output adds its input layer's
    use_mlp: bool = False  # MLP-Mixer latent layers in place of self-attention
    vertical_conv: bool = False  # ConvNext vertical layers in place of attention
    only_global: bool = False  # the motion encoder reads the global cost alone
    add_flow_token: bool = True  # the decoder's query adds the flow token

    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg) -> torch.dtype:
    return DTYPES[cfg.compute_dtype]


def _mask_fields(train: Dict[str, Any], model: Optional[Dict[str, Any]] = None) -> Dict:
    model = model or {}
    pick = lambda key, default: model.get(key, train.get(key, default))
    return dict(mask_modal=pick("MASK_MODAL", "point"),
                mask_channel=int(pick("MASK_CHANNEL", 3)),
                mask_dilate=int(pick("MASK_DILATE", 31)),
                kernel_size=int(train.get("KERNEL_SIZE", 31)),
                kernel_sigma=float(train.get("KERNEL_SIGMA", 5)))


def raft_config(yaml: Dict[str, Any], compute_dtype: str = "float32") -> FFRaftConfig:
    """FF-RAFT's fields from a reference YAML tree (nested dicts)."""
    m, t = yaml["MODEL"], yaml["TRAIN"]
    return FFRaftConfig(fusion=m.get("FUSION", "parallel"),
                        fusion_type=m.get("FUSION_TYPE", "1x1conv"),
                        fusion_channel=int(m.get("FUSION_CHANNEL", 256)),
                        small=bool(m.get("SMALL", False)),
                        abandon_fnet=bool(m.get("ABANDON_FNET", False)),
                        fuse_cnet=bool(m.get("FUSE_CNET", False)),
                        iters=int(m.get("ITERS", 12)),
                        freeze_bn=t.get("STAGE", "chairs") != "chairs",
                        alt_corr=bool(m.get("ALT_CORR", False)),
                        dropout=float(m.get("DROPOUT", 0.0)),
                        compute_dtype=compute_dtype, **_mask_fields(t))


def flowformer_config(yaml: Dict[str, Any], compute_dtype: str = "float32") -> FlowFormerConfig:
    """FF-FlowFormer's fields from a reference YAML tree (nested dicts)."""
    m = yaml["MODEL"]
    return FlowFormerConfig(
        fusion=m.get("FUSION", "parallel"),
        patch_size=int(m.get("patch_size", 8)),
        gma=bool(m.get("gma", True)),
        use_mlp=bool(m.get("use_mlp", False)),
        vertical_conv=bool(m.get("vertical_conv", False)),
        only_global=bool(m.get("only_global", False)),
        cost_encoder_res=bool(m.get("cost_encoder_res", True)),
        add_flow_token=bool(m.get("add_flow_token", True)),
        encoder_latent_dim=int(m.get("encoder_latent_dim", 256)),
        query_latent_dim=int(m.get("query_latent_dim", 64)),
        cost_latent_input_dim=int(m.get("cost_latent_input_dim", 64)),
        cost_latent_token_num=int(m.get("cost_latent_token_num", 8)),
        cost_latent_dim=int(m.get("cost_latent_dim", 128)),
        encoder_depth=int(m.get("encoder_depth", 3)),
        decoder_depth=int(m.get("decoder_depth", 12)),
        vert_c_dim=int(m.get("vert_c_dim", 64)),
        compute_dtype=compute_dtype, **_mask_fields(yaml["TRAIN"], m))
