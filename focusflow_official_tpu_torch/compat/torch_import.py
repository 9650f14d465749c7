"""Reference PyTorch checkpoints (`.pth`) into the port's models.

The reference names its parameters by its torch module tree
(`flow_net.fnet.layer1.0.conv1.weight`); the port's modules carry the flax
names of the JAX package (`flow_net.fnet.layer1_0.conv1.weight`, see
`compat/weights.py`). `torch_key_for_path` maps a flax variable path to the
reference key:

    flow_net/fnet/layer1_0/conv1/kernel     ->  flow_net.fnet.layer1.0.conv1.weight
    .../update_step/update_block/gru/convz1 ->  .../update_block.gru.convz1
    .../mask_0/kernel (nn.Sequential)       ->  .../mask.0.weight

`state_dict_from_reference` walks the port model's own keys, asks for each
one's reference key and takes the tensor as it is: both sides are PyTorch,
so no kernel is transposed. The reference's shared downsample norm
(`downsample.1` is the same module as `norm3` / `norm4`) is read under
either name, and DDP's `module.` prefix is stripped. Every model the port
builds maps this way: FF-RAFT and plain RAFT (`fnet.layer1.0.conv1`,
`channel_pjt.conv1`, the fusion units' `conv_v.0`, `c_map.0`, `s_map.0`),
RAFT-S (the bottlenecks' `conv3`, `norm4` read as `downsample.1` too, the
`ConvGRU`'s `convz`), the attention and conv front ends
(`fusion_layer.down_path_1.0.image_event_transformer.norm1_image.body`,
`.attn.temperature`, `.ffn.fc1`, `up_path_1.0.up`,
`encoder.block1.0.downsample.0`),
FF-PWCNet and PWC-Net, FF-FlowFormer and vanilla FlowFormer
(`context_encoder.svt.*`, `memory_encoder.feat_encoder.svt.*`).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import torch

# flax module names that correspond to torch nn.Sequential children: any
# trailing _<digits> maps to torch's '.<digits>' (layer1_0 -> layer1.0,
# mask_0 -> mask.0, netOne_2 -> netOne.2, netMain_12 -> netMain.12, ...)
_SEQ_RE = re.compile(r"^(.+)_(\d+)$")

# ...except torch attribute names that genuinely contain a trailing _<digit>
# (the reference's UNet fusion front end): recursion stops at these
_LITERAL_NAMES = {"conv_1", "conv_2", "conv_01", "down_path_1", "up_path_1",
                  "skip_conv_1", "relu_1", "relu_2"}

# the port's leaf names -> (flax collection, flax leaf); any other leaf is a
# free parameter of the same name in 'params'
_LEAVES = {"weight": ("params", "kernel"), "bias": ("params", "bias"),
           "running_mean": ("batch_stats", "mean"),
           "running_var": ("batch_stats", "var")}


def _seq_expand(comp: str) -> str:
    """Expand trailing _<digits> into '.<digits>', recursively (blocks_0_1 ->
    blocks.0.1, layer1_0 -> layer1.0) but never past a literal torch
    attribute name (down_path_1_1 -> down_path_1.1)."""
    if comp in _LITERAL_NAMES:
        return comp
    m = _SEQ_RE.match(comp)
    if not m:
        return comp
    return f"{_seq_expand(m.group(1))}.{m.group(2)}"


def torch_key_for_path(path: tuple, collection: str) -> str:
    """Map a flax variable path (without collection) to the reference key."""
    comps = []
    i = 0
    while i < len(path) - 1:
        comp = path[i]
        if comp in ("update_step", "ctx"):
            # update_step: the scan scope (torch has update_block directly);
            # ctx: a context-projection wrapper (torch keeps context_proj on
            # the attention module itself)
            i += 1
            continue
        if comp == "downsample_conv":
            comps.append("downsample.0")
            i += 1
            continue
        if comp.endswith("_body"):  # ChannelLayerNorm: norm1_image_body -> norm1_image.body
            comps.append(comp[: -len("_body")] + ".body")
            i += 1
            continue
        if comp.endswith("_svt"):
            # FlowFormer Twins wrappers: the flat `context_encoder_svt` scope
            # spans torch's {context_encoder}.{svt | mask_svt | fusion_blks}.
            # The next component decides the branch: mask_* -> mask_svt
            # (prefix stripped), fusion_blks* -> the wrapper itself, else svt.
            base = comp[: -len("_svt")]
            comps.append(base)
            nxt = path[i + 1] if i + 1 < len(path) - 1 else path[-1]
            if isinstance(nxt, str) and nxt.startswith("fusion_blks"):
                pass  # fusion units live on the wrapper module
            elif isinstance(nxt, str) and nxt.startswith("mask_"):
                comps.append("mask_svt")
                comps.append(_seq_expand(nxt[len("mask_"):]))
                i += 2
                continue
            else:
                comps.append("svt")
            i += 1
            continue
        if comp.startswith("decoder_layer_cross_attend_"):
            # the memory decoder layer's cross attention
            comps.append("decoder_layer.cross_attend."
                         + _seq_expand(comp[len("decoder_layer_cross_attend_"):]))
            i += 1
            continue
        if comp in _LITERAL_NAMES:
            comps.append(comp)
            i += 1
            continue
        comps.append(_seq_expand(comp))
        i += 1

    leaf = path[-1]
    if collection == "batch_stats":
        leaf_name = {"mean": "running_mean", "var": "running_var"}[leaf]
    elif leaf in ("pos_emb_rel_height", "pos_emb_rel_width"):
        # GMA relative position embedding tables
        leaf_name = f"pos_emb.{leaf[len('pos_emb_'):]}.weight"
    else:
        leaf_name = {"kernel": "weight", "scale": "weight", "bias": "bias"}.get(leaf, leaf)
    return ".".join(comps + [leaf_name])


def _shared_norm_key(key: str) -> str | None:
    """The reference's other name for a shared downsample norm key:
    `<block>.norm3.<leaf>` (or norm4) -> `<block>.downsample.1.<leaf>`; None
    for any other key."""
    m = re.match(r"^(.*)\.norm[34]\.(\w+)$", key)
    return f"{m.group(1)}.downsample.1.{m.group(2)}" if m else None


def state_dict_from_reference(sd: Mapping[str, torch.Tensor], model: torch.nn.Module,
                              prefix: str = "", strict: bool = True) -> Dict[str, torch.Tensor]:
    """A reference-format state dict -> one that `model.load_state_dict(...,
    strict=True)` takes.

    For every key of the port model's state dict, the flax path is rebuilt
    from its '.'-joined components (its leaf renamed as in `_LEAVES`) and
    its reference key `torch_key_for_path(path)` is looked up in `sd` (keys
    with a `module.` prefix stripped). With `prefix` (LOAD_MODULE's
    'flow_net.'), the file holds only the port's subtree under it: a key
    under `prefix` is looked up without it (the port's
    `flow_net.fnet.conv1.weight` is the file's `fnet.conv1.weight`), and
    the keys outside it are not in the file. A missing key raises KeyError
    when `strict`, else the model's own tensor is kept; a shape mismatch
    raises ValueError. Tensors are taken as they are, in f32."""
    ref = {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}
    out = {}
    for key, own in model.state_dict().items():
        *comps, leaf = key.split(".")
        collection, flax_leaf = _LEAVES.get(leaf, ("params", leaf))
        tkey = torch_key_for_path(tuple(comps) + (flax_leaf,), collection)
        tkey = tkey[len(prefix):] if tkey.startswith(prefix) else None
        if tkey not in ref:
            alias = None if tkey is None else _shared_norm_key(tkey)
            if alias in ref:
                tkey = alias
            elif strict:
                raise KeyError(f"reference key {tkey!r} (for the port's {key!r}) not "
                               f"found; a sample of the file's keys: {list(ref)[:5]}")
            else:
                out[key] = own
                continue
        t = torch.as_tensor(ref[tkey])
        if tuple(t.shape) != tuple(own.shape):
            raise ValueError(f"shape mismatch for {tkey}: file {tuple(t.shape)}, "
                             f"port {tuple(own.shape)}")
        out[key] = t.detach().to(device="cpu", dtype=own.dtype).clone()
    return out


def drop_first_convs(state_dict: Dict) -> Dict:
    """The reference's 'backend' load mode: drop the fnet and cnet conv1
    weights, so a model with other input channels keeps its own."""
    drop = {
        "fnet.conv1.weight", "fnet.conv1.bias",
        "cnet.conv1.weight", "cnet.conv1.bias",
    }
    return {k: v for k, v in state_dict.items()
            if k.split("module.")[-1] not in drop}


def load_torch_pretrained(path: str, model: torch.nn.Module, *, prefix: str = "",
                          backend: bool = False,
                          strict: bool = True) -> Dict[str, torch.Tensor]:
    """A reference `.pth` / `.pth.tar` / `.pt` -> the port model's state dict.
    A checkpoint that wraps its weights in a `"model"` entry is unwrapped;
    `prefix` names the port's subtree the file holds (MODEL.LOAD_MODULE:
    'flow_net.', a bare RAFT checkpoint; see `state_dict_from_reference`);
    `backend` drops the first convs (`drop_first_convs`), and then their
    keys must be absent, so it implies `strict=False`. The file is read
    with `weights_only=True`: tensors and plain containers, no code."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd:
        sd = sd["model"]
    if backend:
        sd = drop_first_convs(sd)
        strict = False
    return state_dict_from_reference(sd, model, prefix=prefix, strict=strict)
