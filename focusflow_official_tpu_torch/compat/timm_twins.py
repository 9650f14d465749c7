"""timm `twins_svt_large` weights into the port's Twins towers
(`nn/twins.py::TwinsSVT2Stage`, vanilla FlowFormer's, and
`TwinsSVT2StageCCE`).

The reference starts its FlowFormer encoders from timm's ImageNet-trained
Twins-SVT-Large, cut to its first two stages. This maps such a state dict
(torch tensors or numpy arrays, with or without DDP's `module.` prefix)
onto the port's names, where both sides are PyTorch and no tensor is
transposed:

    patch_embeds.{s}.proj|norm.*          ->  patch_embeds_{s}.proj|norm.*
    blocks.{s}.{j}.norm1|norm2|mlp.*.*    ->  blocks_{s}_{j}.norm1|norm2|mlp.*.*
    blocks.{s}.{j}.attn.qkv (LSA, even j) ->  blocks_{s}_{j}.attn.qkv
    blocks.{s}.{j}.attn.q|kv|sr|norm|proj ->  blocks_{s}_{j}.attn.q|kv|sr|norm|proj
    pos_block.{s}.proj.0.*                ->  pos_block_{s}.proj_0.*

With `mask_branch`, the same weights also fill the CCE mask pyramid
(`mask_*`; the reference leaves that branch un-pretrained). timm and its
weights are not part of the port: nothing here downloads them.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import torch

_RULES = (
    (re.compile(r"^patch_embeds\.(\d)\.(.+)$"), r"patch_embeds_\1.\2"),
    (re.compile(r"^blocks\.(\d)\.(\d+)\.(.+)$"), r"blocks_\1_\2.\3"),
    (re.compile(r"^pos_block\.(\d)\.proj\.0\.(.+)$"), r"pos_block_\1.proj_0.\2"),
)


def port_key(timm_key: str) -> str | None:
    """The port's name for a timm Twins key, or None for keys the
    two-stage tower has no place for (stages 3 and 4, the head)."""
    for pattern, repl in _RULES:
        if pattern.match(timm_key):
            return pattern.sub(repl, timm_key)
    return None


def timm_twins_to_state_dict(state_dict: Mapping, template: Mapping[str, torch.Tensor],
                             mask_branch: bool = False) -> Dict[str, torch.Tensor]:
    """A copy of `template` (a `TwinsSVT2Stage` or `TwinsSVT2StageCCE`
    state dict) with every
    tensor that the timm `state_dict` holds for its first two stages in
    place, in the template's type; a shape that differs raises
    ValueError."""
    out = dict(template)
    prefixes = ("", "mask_") if mask_branch else ("",)
    for key, value in state_dict.items():
        name = port_key(key.split("module.")[-1])
        if name is None:
            continue
        for prefix in prefixes:
            target = prefix + name
            if target not in template:
                continue
            t = torch.as_tensor(value)
            if tuple(t.shape) != tuple(template[target].shape):
                raise ValueError(f"{key} -> {target}: timm {tuple(t.shape)}, port "
                                 f"{tuple(template[target].shape)}")
            out[target] = t.detach().to("cpu", template[target].dtype).clone()
    return out
