"""Seeded weights, made on the device in one draw: every floating tensor of
two or more dimensions of a model's state is N(0, GAIN^2 / fan_in) (fan_in
its elements over its first axis), every bias 0, and the rest (norms'
scales, running statistics) as the model's constructor sets them. The
program and the reference load the same state.

GAIN is 0.5. At 1, both models are chaotic on random weights: their flows
run to 20-90 px on pairs that move 4-12 px, and any rounding grows through
the refinements until bf16 and fp8 part from f32 alike (FF-FlowFormer's
served flow 6-24% and 25-42% from the f32 reference), so no comparison
could tell a precision step. At 0.5 the refinements settle, the flows stay
within a few pixels, and fp8 parts from f32 some 20 times farther than
bf16 does."""

from __future__ import annotations

from typing import Dict

import torch

GAIN = 0.5


def seeded_state(state: Dict[str, torch.Tensor], seed: int, device) -> Dict[str, torch.Tensor]:
    """A state dict of `state`'s keys and shapes, f32 on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    drawn = [k for k, v in state.items() if v.is_floating_point() and v.dim() >= 2]
    flat = torch.randn(sum(state[k].numel() for k in drawn), generator=gen, device=device)
    out = {k: v.detach().to(device).clone() for k, v in state.items()}
    off = 0
    for k in drawn:
        v = state[k]
        n = v.numel()
        out[k] = flat[off:off + n].view(v.shape) * (GAIN * (n // v.shape[0]) ** -0.5)
        off += n
    for k, v in out.items():
        if k.endswith("bias") and v.is_floating_point():
            v.zero_()
    return out
