"""Parameter surgery for transfer learning, over the port's parameter
names (`flow_net.fnet.layer1_0.conv1.weight`, the flax module names):

- `copy_to_branch`: start the CCE mask branch from the image branch
  (MODEL.LOAD_MODULE_TO_BRANCH);
- `freeze_mask_for_parallel`: MODEL.FREEZE_MODULE's labels, 'frozen' for
  the image branches of fnet and cnet and for the update block's encoder
  and GRU, 'trainable' for the rest;
- `flow_net_lr_labels`: TRAIN.SEPARATE_LR's labels, 'encoder' (lr / 10)
  under `flow_net`, 'trainable' elsewhere;
- `encoder_lr_labels`: FF-FlowFormer's TRAINER.twins_lr_factor labels,
  'encoder' on the pretrained Twins towers (a name component containing
  `feat_encoder` or `context_encoder`), 'trainable' elsewhere.

The rules are the JAX package's (`train/surgery.py`), applied to the
components of each name. `drop_first_convs` is in
`compat/torch_import.py`.
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch

_BRANCH_COPY_PREFIXES = [
    ("mask_conv1", "conv1"),
    ("mask_layer1_0", "layer1_0"), ("mask_layer1_1", "layer1_1"),
    ("mask_layer2_0", "layer2_0"), ("mask_layer2_1", "layer2_1"),
    ("mask_layer3_0", "layer3_0"), ("mask_layer3_1", "layer3_1"),
    ("mask_conv2", "conv2"),
]


def copy_to_branch(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A copy of `state_dict` in which every mask-branch tensor of a CCE
    encoder holds its image-branch twin's values."""
    out = dict(state_dict)
    for key in state_dict:
        path = key.split(".")
        for dst, src in _BRANCH_COPY_PREFIXES:
            if dst in path:
                i = path.index(dst)
                src_key = ".".join(path[:i] + [src] + path[i + 1:])
                if src_key in state_dict:
                    out[key] = state_dict[src_key].clone()
    return out


def _is_image_branch_cce(path) -> bool:
    return any(comp in ("conv1", "norm1", "conv2") or comp.startswith("layer")
               for comp in path)


def freeze_mask_for_parallel(names: Iterable[str]) -> Dict[str, str]:
    """name -> 'frozen' or 'trainable' (FREEZE_MODULE: true)."""
    labels = {}
    for name in names:
        path = name.split(".")
        frozen = False
        if "fnet" in path or "cnet" in path:
            i = path.index("fnet" if "fnet" in path else "cnet")
            frozen = _is_image_branch_cce(path[i + 1:])
        if "update_block" in path:
            i = path.index("update_block")
            frozen = path[i + 1] in ("encoder", "gru")
        labels[name] = "frozen" if frozen else "trainable"
    return labels


def flow_net_lr_labels(names: Iterable[str]) -> Dict[str, str]:
    """name -> 'encoder' under `flow_net` (lr / 10), else 'trainable'."""
    return {name: "encoder" if "flow_net" in name.split(".") else "trainable"
            for name in names}


def encoder_lr_labels(names: Iterable[str]) -> Dict[str, str]:
    """name -> 'encoder' where a component of the dotted name contains
    `feat_encoder` or `context_encoder` (the Twins towers, at lr x
    twins_lr_factor), else 'trainable'."""
    return {name: "encoder" if any("feat_encoder" in c or "context_encoder" in c
                                   for c in name.split(".")) else "trainable"
            for name in names}
