"""Kernel B: convc1 over the looked-up windows (`csrc/fold.cu`).

out = a @ w.T + bias with f32 accumulation, emitted in a's type; `w` is
the (O, I) convc1 weight as PyTorch stores it, rows of `a` in the
reference window order, so no permutation is needed.

`fold` is differentiable (a `torch.autograd.Function`); its backward is
`fold_vjp`, the JAX package's `kernels/fold.py::_fold_bwd` in plain
PyTorch on every device: f32 products, da and dw in their inputs' types.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, count_launch

_c = ctypes.c_void_p
_i = ctypes.c_int
MMA_MAX_K = 896  # the most K whose 64-row bf16 tiles fit an SM's shared memory


@functools.cache
def _lib():
    lib = _build.load("fold")
    lib.ff_fold.argtypes = [_c, _c, _c, _c, _i, _i, _i, _i, _c]
    lib.ff_fold.restype = _i
    lib.ff_fold_entry.argtypes = [_i]
    lib.ff_fold_entry.restype = _i
    return lib


def design(a: torch.Tensor) -> str:
    """Which entry of the kernel a call on this CUDA `a` runs, as the library
    itself decides it: "mma" (tensor cores: bf16) or "fma" (f32 tiles)."""
    entry = _lib().ff_fold_entry(int(a.dtype == torch.bfloat16))
    return "mma" if entry == 1 else "fma"


def fold_plain(a: torch.Tensor, w: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (M, K) @ (N, K).T + bias in f32, cast to a's type."""
    return (a.float() @ w.float().t() + bias.float()).to(a.dtype)


def fold_vjp(a: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
    """The fold's VJP: g (M, N), the gradient of its output -> (da in a's
    type, dw in w's type, dbias f32), every product summed in f32."""
    gf = g.float()
    return ((gf @ w.float()).to(a.dtype), (gf.t() @ a.float()).to(w.dtype),
            gf.sum(0))


class _Fold(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, w, bias):
        ctx.save_for_backward(a, w)
        return _launch(a, w, bias)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        return fold_vjp(a, w, g)


def fold(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """a: (M, K), w: (N, K), bias: (N,) of one type (bf16 or f32) -> (M, N).
    Differentiable in all three (`fold_vjp`)."""
    return _Fold.apply(a, w, bias)


def _launch(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The forward: kernel B on CUDA tensors, `fold_plain` on the CPU."""
    if a.device.type == "cpu":
        return fold_plain(a, w, bias)
    if a.device.type != "cuda":
        raise ValueError(f"fold: unsupported device {a.device}")
    m, k = a.shape
    n = w.shape[0]
    if a.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fold: a must be bf16 or f32, got {a.dtype}")
    for t, shape in ((a, (m, k)), (w, (n, k)), (bias, (n,))):
        if (t.device != a.device or t.dtype != a.dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"fold: expected contiguous {shape} {a.dtype} on {a.device}, "
                f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    if a.dtype == torch.bfloat16:
        # the tensor-core entry stages whole tiles: all of K in shared memory,
        # read as aligned spans
        if not 1 <= k <= MMA_MAX_K:
            raise ValueError(f"fold: bf16 takes 1 <= K <= {MMA_MAX_K}, got {k}")
        if a.data_ptr() % 16 or w.data_ptr() % 16:
            raise ValueError("fold: bf16 a and w must be 16-byte aligned")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    err = _lib().ff_fold(a.data_ptr(), w.data_ptr(), bias.data_ptr(),
                         out.data_ptr(), m, n, k, int(a.dtype == torch.bfloat16),
                         torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "ff_fold")
    count_launch("fold", m, k, n, str(a.dtype))
    return out
