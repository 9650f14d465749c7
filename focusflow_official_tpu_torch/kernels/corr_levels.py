"""ALT_CORR's chunk levels in one launch (`csrc/corr_levels.cu`).

`corr_levels(f1, f2, s, n, h, w, num_levels)` is the walk's chunk: the
volume's rows of queries s..s+n-1 (B, n, H, W), f1 (B, Q, C) against the
key map f2 (B, H*W, C), both bf16, products on the tensor cores with f32
sums, and its `num_levels` levels (B, n, H >> l, W >> l) in bf16: level 0
the sums rounded, levels 1..L-1 the 2x2 means with floor semantics, each
taken in f32 from the f32 means one level finer and rounded once. That is
`ops/corr.py::corr_pyramid` of the f32 product, which the plain version
(`ops/corr.py::chunk_levels` on the CPU) computes. It replaces no TPU
kernel: the port's form before it, cuBLAS's product then the pyramid
kernel (`pyramid.py`), wrote level 0 and read it back to pool it.

The plan is Python: `plan(batch, n, h, w, sms)` cuts the work into units of
(map, patch of 8 x 32 keys, group of 64-query tiles), walked by a
persistent grid of one block an SM; `unit(p, u, batch)` is a unit's place,
as the kernel decodes it. With three levels or more the launch runs a
second, short kernel: the main one stores a patch's levels 2 and 3 whole
into records of a scratch buffer (the wrapper's `torch.empty`), and the
second moves them into place (`csrc/corr_levels.cu` says why).

CUDA bf16 tensors only, and no autograd: the walk runs it inside its own
Function, forward and backward's recompute alike. A launch is counted in
`launch_counts["corr_levels"]` and not in `launch_shapes`, whose keys the
benchmark's roofline (`benchmark/harness/roofline.py::work`) prices one by
one.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, launch_counts, sm_count

TILE_Q, PATCH_Y, PATCH_X = 64, 8, 32  # queries a tile; key rows, columns a patch
MAX_C = 256                           # four 64-channel slices of keys stay resident
MAX_LEVELS = 4                        # what kernel G looks up

_c = ctypes.c_void_p
_i = ctypes.c_int


@functools.cache
def _lib():
    lib = _build.load("corr_levels")
    lib.ff_corr_levels_launch.argtypes = [_c] * 7 + [ctypes.c_longlong] + [_i] * 10 + [_c]
    lib.ff_corr_levels_launch.restype = _i
    return lib


def plan(batch: int, n: int, h: int, w: int, sms: int) -> dict:
    """The launch of a chunk of n queries against B maps of h x w keys on
    `sms` SMs: patches of 8 x 32 keys (rows, columns of them a map), tiles
    of 64 queries, cut into groups of `per` tiles where the patches alone
    leave SMs idle (each group loads its patch's keys once more), and a
    grid of at most one block an SM. A 4K chunk: 34 x 15 patches, 32
    tiles, one group, 510 units on 132 blocks."""
    py, px = -(-h // PATCH_Y), -(-w // PATCH_X)
    tiles = -(-n // TILE_Q)
    patches = batch * py * px
    per = -(-tiles // min(tiles, max(1, sms // patches)))
    groups = -(-tiles // per)
    units = groups * patches
    return dict(py=py, px=px, tiles=tiles, per=per, groups=groups, units=units,
                grid=min(units, sms))


def unit(p: dict, u: int, batch: int) -> tuple[int, int, int, range]:
    """Unit u of plan p -> (map, patch row, patch column, its query tiles),
    as the kernel's `unit_of` walks them: patch columns fastest, then
    rows, maps, groups."""
    u, px = divmod(u, p["px"])
    u, py = divmod(u, p["py"])
    g, b = divmod(u, batch)
    return b, py, px, range(g * p["per"], min((g + 1) * p["per"], p["tiles"]))


def _check(f1: torch.Tensor, f2: torch.Tensor, s: int, n: int, h: int, w: int,
           num_levels: int) -> None:
    if f1.dtype != torch.bfloat16 or f2.dtype != torch.bfloat16:
        raise ValueError(f"corr_levels: bf16 operands, got {f1.dtype} and {f2.dtype}")
    if f1.dim() != 3 or f2.dim() != 3 or f1.shape[0] != f2.shape[0] or f1.shape[2] != f2.shape[2]:
        raise ValueError(f"corr_levels: f1 (B, Q, C) and f2 (B, H*W, C), got "
                         f"{tuple(f1.shape)} and {tuple(f2.shape)}")
    c = f1.shape[2]
    if c % 8 or not 8 <= c <= MAX_C:
        raise ValueError(f"corr_levels: C a multiple of 8 up to {MAX_C}, got {c}")
    if not (f1.is_contiguous() and f2.is_contiguous()) or f1.data_ptr() % 16 or f2.data_ptr() % 16:
        raise ValueError("corr_levels: f1 and f2 must be contiguous and 16-byte aligned")
    if f2.shape[1] != h * w:
        raise ValueError(f"corr_levels: f2 holds {f2.shape[1]} keys, not {h}x{w}")
    if n < 1 or s < 0 or s + n > f1.shape[1]:
        raise ValueError(f"corr_levels: queries {s}..{s + n} of {f1.shape[1]}")
    if not 1 <= num_levels <= MAX_LEVELS or min(h, w) >> (num_levels - 1) < 1:
        raise ValueError(f"corr_levels: 1 to {MAX_LEVELS} levels, each at least 1x1; "
                         f"{num_levels} levels of a {h}x{w} map")


def corr_levels(f1: torch.Tensor, f2: torch.Tensor, s: int, n: int, h: int, w: int,
                num_levels: int) -> list[torch.Tensor]:
    """The levels (B, n, h >> l, w >> l), l < num_levels, bf16, of queries
    s..s+n-1 of the CUDA operands f1 (B, Q, C) and f2 (B, h*w, C): one
    launch."""
    if f1.device.type != "cuda" or f2.device != f1.device:
        raise ValueError(f"corr_levels: unsupported devices {f1.device}, {f2.device}")
    _check(f1, f2, s, n, h, w, num_levels)
    b = f1.shape[0]
    levels = [torch.empty((b, n, h >> lv, w >> lv), dtype=torch.bfloat16, device=f1.device)
              for lv in range(num_levels)]
    p = plan(b, n, h, w, sm_count(f1.device))
    ptrs = [lv.data_ptr() for lv in levels] + [0] * (MAX_LEVELS - num_levels)
    # levels 2 and 3 by patch and query (24 cells), for the kernel's second
    # pass to put in place; the launcher refuses a buffer short of its plan
    coarse = torch.empty(b * p["py"] * p["px"] * n * 24 if num_levels > 2 else 0,
                         dtype=torch.bfloat16, device=f1.device)
    err = _lib().ff_corr_levels_launch(
        f1.data_ptr(), f2.data_ptr(), *ptrs, coarse.data_ptr() if num_levels > 2 else 0,
        coarse.numel(), b, f1.shape[1], s, n, h, w, f1.shape[2], num_levels, p["per"],
        p["grid"], torch.cuda.current_stream(f1.device).cuda_stream)
    _build.check(err, "ff_corr_levels")
    launch_counts["corr_levels"] += 1
    return levels
