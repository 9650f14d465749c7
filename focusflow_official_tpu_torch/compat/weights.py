"""Flax variables (flattened as in the `.npz` fixtures) -> the port's
`state_dict`.

Keys are '/'-joined flax paths such as
`params/flow_net/fnet/conv1/kernel` or
`batch_stats/flow_net/cnet/norm1/mean`. The port's modules carry the flax
module names, so a path maps to a key by:

- dropping the collection and the `update_step` scan scope;
- renaming the leaf: `kernel` -> `weight`, a conv's (kh, kw, I, O) (a
  depthwise conv's (kh, kw, 1, C)) transposed to (O, I, kh, kw), a dense
  layer's (I, O) to (O, I); norm `scale` -> `weight`; batch-stat `mean` /
  `var` -> `running_mean` / `running_var`; free parameters
  (`latent_tokens`, `gamma`, `pos_emb_rel_*`, the channel attention's
  `temperature`) keep their names.

A transposed conv (the front ends' `ConvTranspose2x`, flax
`transpose_kernel=True`) holds its kernel as (kh, kw, O, I), and flax
flips it spatially inside the call: the same transpose gives torch's
`ConvTranspose2d` weight (I, O, kh, kw) with no flip of its own
(`tests/test_torch_frontends.py` holds the outputs equal).

An unknown leaf raises `KeyError`. `params_to_jax` is the inverse: the
port's `state_dict` back to flat flax variables (the scan scope put back
where the JAX modules have one), so weights the port trains load into the
JAX package and into the port's `.npz` readers.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias",
                 **{n: n for n in ("latent_tokens", "gamma", "pos_emb_rel_height",
                                   "pos_emb_rel_width", "temperature", "row_embed",
                                   "col_embed")}}
_KERNEL_PERMUTE = {4: (3, 2, 0, 1), 2: (1, 0)}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def params_from_jax(flat: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Map flat flax variables onto the port's parameter names (f32)."""
    sd = {}
    for key, arr in flat.items():
        coll, *path = key.split("/")
        path = [p for p in path if p != "update_step"]
        leaf = path.pop()
        names = {"params": _PARAM_LEAVES, "batch_stats": _STAT_LEAVES}.get(coll, {})
        if leaf not in names:
            raise KeyError(f"unmapped flax variable {key!r}")
        t = torch.from_numpy(np.array(arr, np.float32))
        if leaf == "kernel":
            if t.dim() not in _KERNEL_PERMUTE:
                raise KeyError(f"{t.dim()}-D kernel {key!r}: expected a conv "
                               "(4-D) or a dense layer (2-D)")
            t = t.permute(_KERNEL_PERMUTE[t.dim()])
        sd[".".join(path + [names[leaf]])] = t.contiguous()
    return sd


# the JAX modules whose refinement loop is a flax scan ('update_step'), and
# the children that live inside that scope
_SCAN_SCOPES = {
    "flow_net": frozenset({"update_block"}),
    "memory_decoder": frozenset({
        "update_block", "flow_token_encoder_0", "flow_token_encoder_2",
        "decoder_layer_cross_attend_q", "decoder_layer_cross_attend_proj",
        "decoder_layer_cross_attend_norm1", "decoder_layer_cross_attend_norm2",
        "decoder_layer_cross_attend_ffn_0", "decoder_layer_cross_attend_ffn_3"}),
}
_STAT_NAMES = {v: k for k, v in _STAT_LEAVES.items()}
_FREE = frozenset(n for n, v in _PARAM_LEAVES.items() if n == v and n != "bias")
_KERNEL_UNPERMUTE = {4: (2, 3, 1, 0), 2: (1, 0)}


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The port's state dict -> flat flax variables (f32 numpy), the
    inverse of `params_from_jax`: `weight` of a conv or dense layer ->
    `kernel` in flax's layout, of a norm -> `scale`; running stats ->
    `batch_stats/.../mean|var`; the scan scope `update_step` put back."""
    flat = {}
    for key, t in state_dict.items():
        *path, leaf = key.split(".")
        for i, comp in enumerate(path[:-1]):
            if path[i + 1] in _SCAN_SCOPES.get(comp, ()):
                path.insert(i + 1, "update_step")
                break
        a = t.detach().to("cpu", torch.float32)
        if leaf in _STAT_NAMES:
            coll, leaf = "batch_stats", _STAT_NAMES[leaf]
        elif leaf == "weight":
            coll = "params"
            if a.dim() in _KERNEL_UNPERMUTE:
                leaf, a = "kernel", a.permute(_KERNEL_UNPERMUTE[a.dim()])
            elif a.dim() == 1:
                leaf = "scale"
            else:
                raise KeyError(f"{a.dim()}-D weight {key!r}")
        elif leaf == "bias" or leaf in _FREE:
            coll = "params"
        else:
            raise KeyError(f"unmapped parameter {key!r}")
        flat["/".join([coll, *path, leaf])] = np.ascontiguousarray(a.numpy())
    return flat


def load_npz(path: str) -> dict[str, torch.Tensor]:
    """`params_from_jax` over an `.npz` of flat flax variables."""
    with np.load(path) as raw:
        return params_from_jax({k: raw[k] for k in raw.files})
