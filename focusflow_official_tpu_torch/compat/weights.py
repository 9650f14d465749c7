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
  (`latent_tokens`, `gamma`, `pos_emb_rel_*`) keep their names.

An unknown leaf raises `KeyError`.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias",
                 **{n: n for n in ("latent_tokens", "gamma", "pos_emb_rel_height",
                                   "pos_emb_rel_width")}}
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


def load_npz(path: str) -> dict[str, torch.Tensor]:
    """`params_from_jax` over an `.npz` of flat flax variables."""
    with np.load(path) as raw:
        return params_from_jax({k: raw[k] for k in raw.files})
