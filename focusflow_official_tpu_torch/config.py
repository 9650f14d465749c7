"""YAML experiment configs: the reference schema, read into the port's
model configs.

The reference's flat YAML (sections GLOBAL / TRAIN / MODEL / CRITERION /
OPTIMIZER / SCHEDULER, or TRAINER for FF-FlowFormer) loads into a
dot-accessible `ConfigNode`. `config_from_yaml` picks the family from the
file's shape and builds `FFRaftConfig`, `FFPWCNetConfig` or
`FlowFormerConfig`; `model_from_config` builds the model (plain RAFT,
vanilla PWC-Net and vanilla FlowFormer where `FUSION` is null) and says
how many refinements it runs.

The port's configs hold only the fields the port has. A field that selects
a variant the port lacks is read only to refuse it: any value other than
the ported ones raises `NotImplementedError` with the reason (the
`ROADMAP.md` item that brings it, or why no item does: the JAX package
cannot run it either), so a file is never run as a different model; so
does a dropout other than 0. The TPU layout knobs of the JAX package
(`corr_impl`, the `FF_*` variables) are not read. PyYAML is imported when
a file is read, not with this module.
"""

from __future__ import annotations

import types
from typing import Any, Dict, Optional

from .models import FFFlowFormer, FFPWCNet, FFRaft, FlowFormer, PWCNet
from .models.config import FFPWCNetConfig, FFRaftConfig, FlowFormerConfig
from .models.ff_raft import compute_dtype
from .nn.fusion_units import FUSION_TYPES

# why a value is refused: no variant of that name exists in either package,
# or ROADMAP.md queues it
_UNKNOWN = "the JAX package has no such variant either"
_DROPOUT_ITEM = "ROADMAP.md queue 1, 'Dropout', brings it"


class ConfigNode(types.SimpleNamespace):
    """A YAML section: its keys as attributes, `get` with a default."""

    def get(self, name: str, default: Any = None) -> Any:
        return getattr(self, name, default)


def _to_node(obj: Any) -> Any:
    if isinstance(obj, dict):
        return ConfigNode(**{k: _to_node(v) for k, v in obj.items()})
    return obj


def load_yaml_config(path: str) -> ConfigNode:
    import yaml

    with open(path) as f:
        return _to_node(yaml.safe_load(f))


def detect_family(cfg: ConfigNode) -> str:
    """'raft', 'pwcnet' or 'flowformer' from the file's shape: an explicit
    MODEL.FAMILY wins; a TRAINER section or the latent-cost keys mean
    FlowFormer; TRAIN.LOSS_WEIGHTS (the multiscale loss) means PWC-Net;
    anything else is RAFT."""
    fam = cfg.MODEL.get("FAMILY")
    if fam:
        return str(fam).lower()
    if cfg.get("TRAINER") is not None or cfg.MODEL.get("cost_latent_dim") is not None:
        return "flowformer"
    if cfg.TRAIN.get("LOSS_WEIGHTS") is not None:
        return "pwcnet"
    return "raft"


def _refuse(section: ConfigNode, key: str, ported: Any, default: Any = None,
            reason: str = _UNKNOWN) -> Any:
    """Raise unless `section.key` (absent: `default`) is the ported value
    or one of a tuple of them, read as the ported value's type where that
    is bool, int or float (as the reference reads it: `gma: GMA` is true);
    -> the value. The message ends with `reason`."""
    value = section.get(key, default)
    allowed = ported if isinstance(ported, tuple) else (ported,)
    if isinstance(allowed[0], (bool, int, float)) and value is not None:
        value = type(allowed[0])(value)
    if value not in allowed:
        raise NotImplementedError(
            f"{key}: {value!r} selects a variant this port lacks (it has "
            f"{' or '.join(map(repr, allowed))}); {reason}")
    return value


def _mask_fields(train: ConfigNode, model: Optional[ConfigNode] = None) -> Dict:
    """The TRAIN section's mask handling (FF-FlowFormer may set it in MODEL)."""
    model = model or ConfigNode()
    pick = lambda key, default: model.get(key, train.get(key, default))
    return dict(mask_modal=pick("MASK_MODAL", "point"),
                mask_channel=int(pick("MASK_CHANNEL", 3)),
                mask_dilate=int(pick("MASK_DILATE", 31)),
                kernel_size=int(train.get("KERNEL_SIZE", 31)),
                kernel_sigma=float(train.get("KERNEL_SIGMA", 5)))


def model_config_from_yaml(cfg: ConfigNode, *,
                           compute_dtype: str = "float32") -> FFRaftConfig:
    """FF-RAFT (`FUSION: parallel`), plain RAFT (`FUSION: null`) or the
    attention or conv front end before a plain RAFT (`FUSION: attention |
    conv`, `FUSION_CHANNEL` wide), at full width or small (`SMALL`), with
    any CCE fusion type, the context encoder fused or not (`FUSE_CNET`),
    the fnet as it is or `ChannelProject` (`ABANDON_FNET`) and the
    materialized volume or ALT_CORR; dropout is refused."""
    model = cfg.MODEL
    _refuse(model, "DROPOUT", 0.0, 0.0, _DROPOUT_ITEM)
    return FFRaftConfig(fusion=_refuse(model, "FUSION", ("parallel", None, "attention", "conv")),
                        fusion_type=_refuse(model, "FUSION_TYPE", FUSION_TYPES, "1x1conv"),
                        fusion_channel=int(model.get("FUSION_CHANNEL", 256)),
                        small=bool(model.get("SMALL", False)),
                        abandon_fnet=bool(model.get("ABANDON_FNET", False)),
                        fuse_cnet=bool(model.get("FUSE_CNET", False)),
                        iters=int(model.get("ITERS", 12)),
                        freeze_bn=cfg.TRAIN.get("STAGE", "chairs") != "chairs",
                        alt_corr=bool(model.get("ALT_CORR", False)),
                        compute_dtype=compute_dtype, **_mask_fields(cfg.TRAIN))


def pwcnet_config_from_yaml(cfg: ConfigNode, *,
                            compute_dtype: str = "float32") -> FFPWCNetConfig:
    """FF-PWCNet (`FUSION: parallel`) with any CCE fusion type, or the
    vanilla PWC-Net (`FUSION: null`); dropout is refused."""
    model = cfg.MODEL
    _refuse(model, "DROPOUT", 0.0, 0.0, _DROPOUT_ITEM)
    return FFPWCNetConfig(fusion=_refuse(model, "FUSION", ("parallel", None)),
                          fusion_type=_refuse(model, "FUSION_TYPE", FUSION_TYPES, "1x1conv"),
                          compute_dtype=compute_dtype, **_mask_fields(cfg.TRAIN))


# FlowFormer's `latentcostformer` keys with one value in both packages: the
# value, the reference default where a file leaves the key out, and why no
# other value runs
_FF_FIXED = (
    ("pe", "linear", "linear", "the JAX package reads the field and never uses "
     "it: the linear sine encoding is the only one either package has"),
    ("cost_heads_num", 1, 1, "the JAX package cannot run it either (its "
     "CostPerceiverEncoder reshapes the cost maps as one head, "
     "models/ff_flowformer.py:159)"),
    ("feat_cross_attn", False, False, "the JAX package raises on it too: the "
     "reference's layer stack is never constructed (encoder.py:372-380)"))


def flowformer_config_from_yaml(cfg: ConfigNode, *,
                                compute_dtype: str = "float32") -> FlowFormerConfig:
    """FF-FlowFormer with the CCE Twins towers (`FUSION: parallel`) or
    vanilla FlowFormer (`FUSION: null`), with every variant of the
    `latentcostformer` block that the JAX package runs (`gma`, `use_mlp`,
    `vertical_conv`, `only_global`, `patch_size` 4 or 8,
    `cost_encoder_res`, `add_flow_token`), read as JAX reads them; `pe`
    other than 'linear', more than one cost head, `feat_cross_attn` and
    dropout are refused."""
    m = cfg.MODEL
    for key, ported, default, reason in _FF_FIXED:
        _refuse(m, key, ported, default, reason)
    _refuse(m, "dropout", 0.0, 0.0, _DROPOUT_ITEM)
    return FlowFormerConfig(
        fusion=_refuse(m, "FUSION", ("parallel", None)),
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
        compute_dtype=compute_dtype, **_mask_fields(cfg.TRAIN, m))


def config_from_yaml(cfg: ConfigNode, *, compute_dtype: str = "float32"):
    """The port's model config for this file's family."""
    read = {"raft": model_config_from_yaml, "pwcnet": pwcnet_config_from_yaml,
            "flowformer": flowformer_config_from_yaml}
    family = detect_family(cfg)
    if family not in read:
        raise ValueError(f"unknown model family {family!r}")
    return read[family](cfg, compute_dtype=compute_dtype)


def loss_kwargs_from_yaml(cfg: ConfigNode) -> Dict:
    """The sequence loss of TRAIN: its type and settings, for
    `losses.build_sequence_loss` (`loss_type` first)."""
    t = cfg.TRAIN
    return dict(
        loss_type=t.get("LOSS_TYPE", "EPELoss"),
        gamma=float(t.get("LOSS_GAMMA", 0.8)),
        max_flow=float(t.get("MAX_FLOW", 400)),
        kernel_size=int(t.get("LOSS_KERNEL_SIZE", 5)),
        sigma=float(t.get("LOSS_SIGMA", 1.7)),
        lamda=float(t.get("LOSS_LAMDA", 0.8)),
    )


def multiscale_loss_kwargs_from_yaml(cfg: ConfigNode, sparse: bool = False) -> Dict:
    """FF-PWCNet's multiscale loss of TRAIN: its type and settings, for
    `losses.build_multiscale_loss` (`loss_type` first); `LOSS_Q: null` and
    `LOSS_EPSILON: null` read as 0.4 and 0.01. `sparse`: KITTI targets."""
    t = cfg.TRAIN
    return dict(
        loss_type=t.get("LOSS_TYPE", "EPELoss"),
        weights=[float(x) for x in t.LOSS_WEIGHTS],
        mode=t.get("LOSS_MODE", "pretrain"),
        q=float(t.get("LOSS_Q") or 0.4),
        eps=float(t.get("LOSS_EPSILON") or 0.01),
        kernel_size=int(t.get("LOSS_KERNEL_SIZE", 5)),
        sigma=float(t.get("LOSS_SIGMA", 1.7)),
        lamda=float(t.get("LOSS_LAMDA", 0.8)),
        sparse=sparse,
    )


def optimizer_kwargs_from_yaml(cfg: ConfigNode) -> Dict:
    """lr, weight decay, eps and the clip from OPTIMIZER + SCHEDULER
    (FF-RAFT, FF-PWCNet) or FF-FlowFormer's TRAINER block."""
    if cfg.get("TRAINER") is not None:
        t = cfg.TRAINER
        return dict(
            lr=float(t.canonical_lr),
            weight_decay=float(t.get("adamw_decay", t.get("adam_decay", 1e-4))),
            epsilon=float(t.get("epsilon", 1e-8)),
            clip=float(t.get("clip", 1.0)),
        )
    return dict(
        lr=float(cfg.SCHEDULER.LR),
        weight_decay=float(cfg.OPTIMIZER.WEIGHT_DECAY),
        epsilon=float(cfg.OPTIMIZER.EPSILON),
        clip=float(cfg.TRAIN.get("CLIP", 1.0)),
    )


def model_from_config(model_cfg):
    """The model a port config describes, with its refinement count: FF-RAFT
    `iters`, FF-FlowFormer `decoder_depth`, FF-PWCNet None (it has no
    refinement loop). `fusion=None` picks the vanilla model: `FFRaft`
    builds plain RAFT itself, FlowFormer and PWC-Net are classes of their
    own."""
    if isinstance(model_cfg, FFRaftConfig):
        return FFRaft(model_cfg), model_cfg.iters
    if isinstance(model_cfg, FlowFormerConfig):
        model = FlowFormer if model_cfg.fusion is None else FFFlowFormer
        return model(model_cfg), model_cfg.decoder_depth
    if isinstance(model_cfg, FFPWCNetConfig):
        if model_cfg.fusion is None:
            return PWCNet(compute_dtype(model_cfg)), None
        return FFPWCNet(model_cfg), None
    raise TypeError("expected FFRaftConfig, FlowFormerConfig or FFPWCNetConfig, "
                    f"got {model_cfg!r}")
