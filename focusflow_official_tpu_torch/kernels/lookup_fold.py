"""The window lookup and convc1 in one launch (`csrc/lookup_fold.cu`).

out[b, y, x] = convc1(window(b, y, x)): the L*(2r+1)^2 bilinear window of
kernel A (taps summed in f32, then rounded to the compute type), times the
(O, L*(2r+1)^2) convc1 weight with f32 accumulation, plus the bias in f32,
emitted in the compute type. The window stays in shared memory.

bf16 runs on the tensor cores with the weight resident in shared memory:
one block an SM of 16 gather warps, which write the windows of 16 queries
a pass into shared memory, and 8 tensor-core warps, which multiply 32 rows
at a time; `plan` lays the launch out from the library's `layout`. f32 runs
FMA tiles and equals kernel A then kernel B to the bit.

`lookup_fold` is differentiable (a `torch.autograd.Function`). The JAX
package's fused kernel has no VJP (its trainer runs the lookup and the fold
apart), so the backward is the fold's VJP and then the lookup's, composed
(`lookup_fold_vjp`): the kernel never writes the window, so the backward
rebuilds it with kernel A (`kernels/lookup.py`; the plain version on the
CPU), then dW = gᵀ·window and dbias = sum g in f32, dwindow = g·W in the
window's type, and the levels' gradient in the lookup's tent form.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from . import _build, count_launch, sm_count
from .fold import fold_plain, fold_vjp
from .lookup import RADII, lookup_plain, lookup_vjp
from .lookup import _launch as _lookup_launch

_c = ctypes.c_void_p
_i = ctypes.c_int


@functools.cache
def _lib():
    lib = _build.load("lookup_fold")
    lib.ff_lookup_fold.argtypes = [_c, _c, _c, _c] + [_i] * 9 + [
        _c, _c, _c, _c, ctypes.c_longlong, _i, _i, _i, _i, _i, _c]
    lib.ff_lookup_fold.restype = _i
    lib.ff_lookup_fold_smem.argtypes = [_i, _i]
    lib.ff_lookup_fold_smem.restype = _i
    lib.ff_lookup_fold_rows.restype = _i
    lib.ff_lookup_fold_cols.restype = _i
    return lib


def layout() -> dict:
    """The bf16 entry as built: query rows a gather pass (one a gather
    warp) and output columns a block owns."""
    lib = _lib()
    return dict(rows=lib.ff_lookup_fold_rows(), cols=lib.ff_lookup_fold_cols())


def smem(k: int, n: int) -> int:
    """Shared memory (bytes) a bf16 launch takes at K = k and N = n, as built."""
    return _lib().ff_lookup_fold_smem(k, n)


def plan(q: int, n: int, radius: int, dtype: torch.dtype, sms: int,
         rows: int, cols: int) -> dict:
    """The launch of a call over `q` queries and n output columns on a card
    of `sms` SMs, for the bf16 entry's `layout()` (`rows`, `cols`).

    f32: the FMA entry, which lays itself out (one block each 32 queries).
    bf16: the tensor-core entry, a persistent grid: ceil(n / cols) column
    slices, each with `sms // slices` blocks (fewer where there are not
    `rows` queries a block), each staging its slice of the weight once and
    walking a contiguous run of at most `per_block` queries in passes of
    `rows`. Raises ValueError where no plan exists: a radius the gather is
    not built for."""
    if radius not in RADII:
        raise ValueError(f"lookup_fold: radius {RADII}, got {radius}")
    if dtype == torch.float32:
        return dict(entry="fma", grid=None, slices=None)
    slices = -(-n // cols)
    per_slice = max(1, min(sms // slices, -(-q // rows)))
    return dict(entry="mma", grid=slices * per_slice, slices=slices,
                per_block=-(-q // per_slice))


def lookup_fold_plain(levels: Sequence[torch.Tensor], coords: torch.Tensor,
                      radius: int, weight: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: `fold_plain(lookup_plain(...))`, the window
    cast to the weight's type between the two."""
    b, h, w, _ = coords.shape
    window = lookup_plain(levels, coords, radius)
    out = fold_plain(window.reshape(b * h * w, -1).to(weight.dtype), weight, bias)
    return out.reshape(b, h, w, -1)


def lookup_fold_vjp(levels: Sequence[torch.Tensor], coords: torch.Tensor, radius: int,
                    weight: torch.Tensor, g: torch.Tensor, coords_grad: bool = False):
    """The VJP of `lookup_fold`: g (B, H, W, O) -> (the levels' gradients,
    the coordinates' gradient or None, dweight, dbias). The window is looked
    up again (kernel A on the card) and cast to the weight's type, as the
    forward casts it."""
    b, h, w, _ = coords.shape
    m = b * h * w
    window = _lookup_launch(levels, coords, radius).reshape(m, -1).to(weight.dtype)
    dwindow, dweight, dbias = fold_vjp(window, weight, g.reshape(m, -1))
    dlevels, dcoords = lookup_vjp(levels, coords, radius, dwindow.reshape(b, h, w, -1),
                                  coords_grad)
    return dlevels, dcoords, dweight, dbias


class _LookupFold(torch.autograd.Function):
    @staticmethod
    def forward(ctx, radius, coords, weight, bias, *levels):
        ctx.radius = radius
        ctx.save_for_backward(coords, weight, *levels)
        return _launch(levels, coords, radius, weight, bias)

    @staticmethod
    def backward(ctx, g):
        coords, weight, *levels = ctx.saved_tensors
        dlevels, dcoords, dweight, dbias = lookup_fold_vjp(
            levels, coords, ctx.radius, weight, g, ctx.needs_input_grad[1])
        if not any(ctx.needs_input_grad[4:]):
            dlevels = [None] * len(levels)
        return (None, dcoords, dweight, dbias, *dlevels)


def lookup_fold(levels: Sequence[torch.Tensor], coords: torch.Tensor, radius: int,
                weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """levels: up to 4 (B, H*W, H_l, W_l) volumes; coords: (B, H, W, 2) f32
    level-0 (x, y); weight: (O, L*(2r+1)^2); bias: (O,). Levels, weight and
    bias share one type (bf16 or f32) -> (B, H, W, O) in that type.
    Differentiable in the levels, coords, weight and bias
    (`lookup_fold_vjp`)."""
    return _LookupFold.apply(radius, coords, weight, bias, *levels)


def _launch(levels: Sequence[torch.Tensor], coords: torch.Tensor, radius: int,
            weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The forward: the fused kernel on CUDA tensors, `lookup_fold_plain` on
    the CPU."""
    if coords.device.type == "cpu":
        return lookup_fold_plain(levels, coords, radius, weight, bias)
    if coords.device.type != "cuda":
        raise ValueError(f"lookup_fold: unsupported device {coords.device}")
    b, h1, w1, two = coords.shape
    q = h1 * w1
    nl = len(levels)
    if (two != 2 or coords.dtype != torch.float32 or not coords.is_contiguous()
            or coords.data_ptr() % 8):
        raise ValueError("lookup_fold: coords must be contiguous f32 (B, H, W, 2), "
                         "8-byte aligned")
    if not 1 <= nl <= 4:
        raise ValueError(f"lookup_fold: 1 to 4 levels, got {nl}")
    dt = weight.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"lookup_fold: bf16 or f32, got {dt}")
    dims = []
    for lv in levels:
        if (lv.device != coords.device or lv.dtype != dt or lv.dim() != 4
                or lv.shape[:2] != (b, q) or not lv.is_contiguous()):
            raise ValueError(
                f"lookup_fold: level {tuple(lv.shape)} {lv.dtype} {lv.device} "
                f"does not fit coords {tuple(coords.shape)} and {dt} weights "
                "(contiguous (B, Q, H, W))")
        dims += [lv.shape[2], lv.shape[3]]
    k = nl * (2 * radius + 1) ** 2
    n = weight.shape[0]
    for t, shape in ((weight, (n, k)), (bias, (n,))):
        if (t.device != coords.device or t.dtype != dt
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"lookup_fold: expected contiguous {shape} {dt} on "
                f"{coords.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    if dt == torch.bfloat16 and weight.data_ptr() % 16:
        raise ValueError("lookup_fold: a bf16 weight must be 16-byte aligned")
    p = plan(b * q, n, radius, dt, sm_count(coords.device), **layout())
    out = torch.empty((b, h1, w1, n), dtype=dt, device=coords.device)
    ptrs = [lv.data_ptr() for lv in levels] + [0] * (4 - nl)
    dims += [0] * (8 - len(dims))
    err = _lib().ff_lookup_fold(
        *ptrs, *dims, nl, coords.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        out.data_ptr(), b * q, radius, n, int(dt == torch.bfloat16), p["grid"] or 0,
        p["slices"] or 0, torch.cuda.current_stream(coords.device).cuda_stream)
    _build.check(err, "ff_lookup_fold")
    count_launch("lookup_fold", b, q, *dims[:2 * nl], radius, n, str(dt), p["entry"],
                 p["grid"], p["slices"])
    return out
