"""Normalisation layers with the reference semantics.

Modules inside the model take NCHW-indexed tensors; on the card these are
kept `channels_last`, so `x.permute(0, 2, 3, 1)` is the NHWC tensor the
instance-norm kernels read without a copy.

- 'group'    : GroupNorm, affine, eps 1e-5
- 'batch'    : BatchNorm, affine, eps 1e-5: in eval mode over the running
               stats; in train mode over the batch's f32 stats (biased
               variance), updating the running averages in f32 with
               momentum 0.1 and the unbiased variance, as torch does. A
               frozen BN (the reference's `freeze_bn()`) is a batch Norm
               in eval mode inside a training model. Under data
               parallelism (`train/mesh.py::sync_batch_norms`) `reduce`
               sums the statistics' parts over the ranks, so they are the
               global batch's; on one card it is the identity, and the
               arithmetic is the same sums over the same count.
- 'instance' : InstanceNorm, no affine, no running stats, eps 1e-5;
               on a CUDA tensor kernel C1 (stats) then kernel C2 (normalize)
- 'none'     : identity

Statistics are taken in f32 (in f64 for an f64 x); the normalisation
itself runs in x's type.
Given a residual (ResidualBlock's shortcut), `forward` returns
relu(residual + norm(x)): for 'instance' that is C2's residual form, one
launch, which takes the residual `channels_last` on the card, as it takes
x; the other kinds add and ReLU in PyTorch.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.instance_norm import instance_norm

MOMENTUM = 0.1  # torch's: running = (1 - m) * running + m * batch


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


class Norm(nn.Module):
    def __init__(self, kind: str, features: int, num_groups: int = 8,
                 eps: float = 1e-5):
        super().__init__()
        if kind not in ("group", "batch", "instance", "none"):
            raise ValueError(f"Unknown norm kind: {kind}")
        self.kind, self.num_groups, self.eps = kind, num_groups, eps
        self.reduce = _identity  # the batch statistics' sum over the ranks
        if kind in ("group", "batch"):
            self.weight = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))
        if kind == "batch":
            self.register_buffer("running_mean", torch.zeros(features))
            self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, relu: bool = False,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        if self.kind == "instance":
            r = None if residual is None else residual.permute(0, 2, 3, 1)
            y = instance_norm(x.permute(0, 2, 3, 1).contiguous(), self.eps, relu, r)
            return y.permute(0, 3, 1, 2)
        y = self._norm(x, relu)
        return y if residual is None else torch.relu(residual + y)

    def _norm(self, x: torch.Tensor, relu: bool) -> torch.Tensor:
        kind, d = self.kind, x.dtype
        if kind == "none":
            return torch.relu(x) if relu else x
        col = lambda t: t.to(d)[None, :, None, None]
        if kind == "batch":
            mean, var = self.running_mean, self.running_var.float()
            if self.training:
                mean, var = self._batch_stats(x)
            inv = torch.rsqrt(var + self.eps)
            y = ((x - col(mean)) * col(inv) * col(self.weight)
                 + col(self.bias))
        else:  # group
            b, c, h, w = x.shape
            g = self.num_groups
            xg = x.reshape(b, g, c // g, h, w)
            xf = xg.float()
            mean = xf.mean(dim=(2, 3, 4), keepdim=True)
            var = torch.clamp((xf * xf).mean(dim=(2, 3, 4), keepdim=True)
                              - mean * mean, min=0.0)
            inv = torch.rsqrt(var + self.eps)
            y = ((xg - mean.to(d)) * inv.to(d)).reshape(b, c, h, w)
            y = y * col(self.weight) + col(self.bias)
        return torch.relu(y) if relu else y

    def _batch_stats(self, x: torch.Tensor):
        """The batch's (mean, biased variance) over (B, H, W), in f32 (an
        f64 x: in f64); the running averages take them with momentum 0.1
        (the variance unbiased). The sum and the count, then the centred
        second moment, each passed through `reduce`: the identity on one
        card, the sum over the ranks under data parallelism, so the
        statistics are the global batch's."""
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        n = xf.numel() // xf.shape[1]
        sums = self.reduce(torch.cat([xf.sum(dim=(0, 2, 3)), xf.new_full((1,), float(n))]))
        n = sums[-1]
        mean = sums[:-1] / n
        var = self.reduce(((xf - mean[None, :, None, None]) ** 2).sum(dim=(0, 2, 3))) / n
        unbiased = n / torch.clamp(n - 1, min=1)
        with torch.no_grad():
            for run, new in ((self.running_mean, mean), (self.running_var, var * unbiased)):
                run.copy_((1 - MOMENTUM) * run + MOMENTUM * new)
        return mean, var
