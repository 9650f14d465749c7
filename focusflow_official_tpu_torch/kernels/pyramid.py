"""ALT_CORR's chunk pyramid in one launch (`csrc/pyramid.cu`).

`pyramid(rows, num_levels, dtype)` is `ops/corr.py::corr_pyramid`'s
function on a chunk's rows of the volume (..., H, W), bf16 or f32, with
`dtype` the rows' type (the walk's compute type): level 0 the rows
themselves, levels 1..L-1 the 2x2 means with floor semantics, each taken
in f32 from the f32 means one level finer and stored in `dtype`, equal to
`corr_pyramid`'s on the card to the bit. One launch reads the rows once
and writes levels 1..L-1 once; no f32 intermediate reaches device memory.
It replaces no TPU kernel: the port's form before it, an f32 copy of the
rows, three `avg_pool2x2` reductions and casts, moved about 5.5 times the
bytes.

The plan is Python: `regions(h, w, num_levels)` cuts a map into regions
of square patches, each a thread's (`csrc/pyramid.cu`), and
`design(rows, num_levels)` names the entry a CUDA call takes: "vector"
(aligned loads and stores: W a multiple of 2^(L-1), the rows 16-byte
aligned) or "scalar".

CUDA tensors only, and no autograd: the walk runs it inside its own
Function (`ops/corr.py::chunk_pyramid` takes `corr_pyramid` on the CPU). A
launch is counted in `launch_counts["pyramid"]` and not in `launch_shapes`,
whose keys the benchmark's roofline (`benchmark/harness/roofline.py::work`)
prices one by one.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, launch_counts, sm_count

MAX_LEVELS = 4  # what kernel G looks up

_c = ctypes.c_void_p
_i = ctypes.c_int


@functools.cache
def _lib():
    lib = _build.load("pyramid")
    lib.ff_pyramid.argtypes = [_c, _c, _c, _c, ctypes.c_longlong, _i, _i, _i, _c, _i, _i, _i,
                               _i, _c]
    lib.ff_pyramid.restype = _i
    return lib


def _bands(n: int, k: int) -> list[tuple[int, int, int]]:
    """An axis of n level-0 cells as bands of whole patches -> [(start,
    cells, j)]: the 2^k-cell patches that fit, then one band of 2^j cells
    for each set bit j >= 1 of n mod 2^k, largest first. The cells left
    over (the odd last one) lie in no level-1 cell."""
    main = n >> k << k
    out = [(0, main, k)] if main else []
    start = main
    for j in range(k - 1, 0, -1):
        if n >> j & 1:
            out.append((start, 1 << j, j))
            start += 1 << j
    return out


def regions(h: int, w: int, num_levels: int) -> list[tuple[int, int, int, int, int]]:
    """An (h, w) map cut for the kernel -> [(y0, x0, patch rows, patch
    columns, k)], the main region first: each pair of a row band and a
    column band (`_bands`, k = num_levels - 1) tiled by patches of
    2^j x 2^j level-0 cells, j the smaller band's. A patch yields its
    cells of levels 1..j, so every cell of levels 1..L-1 lies in one
    patch: at 270x480 and four levels 33 x 60 patches of 8, 1 x 120 of 4
    (level-1 rows 132-133, level-2 row 66) and 1 x 240 of 2 (level-1 row
    134)."""
    k = num_levels - 1
    out = []
    for y0, hr, kr in _bands(h, k):
        for x0, wc, kc in _bands(w, k):
            j = min(kr, kc)
            out.append((y0, x0, hr >> j, wc >> j, j))
    return out


def design(rows: torch.Tensor, num_levels: int) -> str:
    """The entry a contiguous CUDA call on `rows` (..., H, W) takes:
    "vector" where W is a multiple of 2^(L-1) and the rows start on a
    16-byte boundary (the levels, freshly allocated, always do), else
    "scalar"."""
    ok = rows.shape[-1] % (1 << (num_levels - 1)) == 0 and rows.data_ptr() % 16 == 0
    return "vector" if ok else "scalar"


def _check(rows: torch.Tensor, num_levels: int, dtype: torch.dtype) -> None:
    if rows.dtype not in (torch.bfloat16, torch.float32) or dtype != rows.dtype:
        raise ValueError(f"pyramid: bf16 or f32 rows and levels in the rows' type, got "
                         f"{rows.dtype} rows and {dtype} levels")
    if rows.dim() < 2 or not rows.is_contiguous():
        raise ValueError(f"pyramid: rows must be a contiguous (..., H, W) tensor, got "
                         f"{tuple(rows.shape)} with strides {rows.stride()}")
    h, w = rows.shape[-2:]
    if not 1 <= num_levels <= MAX_LEVELS or min(h, w) >> (num_levels - 1) < 1:
        raise ValueError(f"pyramid: 1 to {MAX_LEVELS} levels, each at least 1x1; "
                         f"{num_levels} levels of a {h}x{w} map")


def pyramid(rows: torch.Tensor, num_levels: int, dtype: torch.dtype) -> list[torch.Tensor]:
    """The levels (..., H >> l, W >> l), l < num_levels, of a CUDA chunk's
    rows (..., H, W) in their type `dtype`, as `corr_pyramid(rows,
    num_levels, dtype)` gives them: level 0 is `rows`, levels 1..L-1 come
    from one launch."""
    if rows.device.type != "cuda":
        raise ValueError(f"pyramid: unsupported device {rows.device}")
    _check(rows, num_levels, dtype)
    h, w = rows.shape[-2:]
    lead = rows.shape[:-2]
    levels = [rows] + [
        torch.empty((*lead, h >> lv, w >> lv), dtype=dtype, device=rows.device)
        for lv in range(1, num_levels)]
    maps = rows.numel() // (h * w)
    if num_levels == 1 or maps == 0:
        return levels
    cut = regions(h, w, num_levels)
    table = (ctypes.c_int * (5 * len(cut)))(*[v for reg in cut for v in reg])
    ptrs = [lv.data_ptr() for lv in levels[1:]] + [0] * (MAX_LEVELS - num_levels)
    err = _lib().ff_pyramid(
        rows.data_ptr(), *ptrs, maps, h, w, num_levels, ctypes.addressof(table), len(cut),
        int(dtype == torch.bfloat16), int(design(rows, num_levels) == "vector"),
        sm_count(rows.device), torch.cuda.current_stream(rows.device).cuda_stream)
    _build.check(err, "ff_pyramid")
    launch_counts["pyramid"] += 1
    return levels
