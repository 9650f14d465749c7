"""The control: the reference computed in fp8 (e4m3), the precision below
the configurations' bf16. Inside `fp8()` every input of a convolution, a
dense layer and a matrix product (`F.conv2d`, `F.linear`, `matmul`,
`bmm`, `mm`, `einsum`, `@`) is rounded to e4m3 with one scale a tensor
(its largest magnitude to 448) and back to f32; the product itself and
its accumulation stay f32. Gradients pass the rounding unchanged
(straight through), so a training step computes its backward from the
rounded forward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0
_OPS = {F.conv2d, F.linear, torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
        torch.Tensor.__rmatmul__, torch.bmm, torch.Tensor.bmm, torch.mm, torch.Tensor.mm,
        torch.einsum}


def round_e4m3(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 under one per-tensor scale, in x's type; the
    gradient passes through."""
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / E4M3_MAX
    q = (x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q.to(x.dtype) - x).detach()


def _round(a):
    if torch.is_tensor(a) and a.is_floating_point():
        return round_e4m3(a)
    if isinstance(a, (list, tuple)):
        return type(a)(_round(t) for t in a)
    return a


class fp8(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _OPS:
            args = tuple(_round(a) for a in args)
        return func(*args, **kwargs)
