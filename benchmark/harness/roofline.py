"""The chip's published peaks and each port kernel's least time.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 989 TFLOP/s on the tensor cores in bf16, 67 TFLOP/s in f32
outside them (the kernels' f32 entries use FMA), 3.35 TB/s of HBM.

A launch's least time is the larger of its operations over the peak of
its type and its bytes over the bandwidth. Bytes count each input byte the
launch needs once and each output byte once: for the windowed lookups (A,
and G's lookup) the window's bilinear taps a query needs, (2r+2)^2 at
most a level and at most the level; for the rest the whole tensors. The
launch keys are the port's `kernels/__init__.py::launch_shapes` keys
(what each wrapper passes to `count_launch`). Kernel A's key carries no
radius: it is taken as 4, the radius of every model the cells run (RAFT
at full width, FlowFormer's decoder). Window attention's key carries no
window size: it is taken as 7, Twins' published window; its bound is the
bytes' in any case (about 25 operations a byte at 128 channels).
"""

from __future__ import annotations

from typing import Dict, Tuple

BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES = 3.35e12
LOOKUP_RADIUS = 4
WINDOW = 7


def _size(dt: str) -> int:
    return 2 if "bfloat16" in dt or "float16" in dt else 4


def _peak(dt: str) -> float:
    return BF16_FLOPS if _size(dt) == 2 else F32_FLOPS


def _taps(b: int, q: int, dims, radius: int, es: int) -> float:
    """The window taps a lookup needs over the levels (h, w, h, w, ...)."""
    return sum(b * q * min((2 * radius + 2) ** 2, h * w) * es
               for h, w in zip(dims[0::2], dims[1::2]))


def work(key: Tuple) -> Tuple[float, float, float]:
    """(operations, bytes, peak operations a second) of one launch."""
    name = key[0]
    if name == "fold":
        _, m, k, n, dt = key
        es = _size(dt)
        return 2.0 * m * k * n, (m * k + n * k + m * n) * es + n * 4, _peak(dt)
    if name == "lookup":
        b, q, dims, dt = key[1], key[2], key[3:-1], key[-1]
        es, r = _size(dt), LOOKUP_RADIUS
        out = b * q * (len(dims) // 2) * (2 * r + 1) ** 2 * es
        return 0.0, b * q * 8 + _taps(b, q, dims, r, es) + out, _peak(dt)
    if name == "lookup_fold":
        b, q, dims = key[1], key[2], key[3:-6]
        r, n, dt = key[-6], key[-5], key[-4]
        es = _size(dt)
        k = (len(dims) // 2) * (2 * r + 1) ** 2
        byt = b * q * 8 + _taps(b, q, dims, r, es) + n * k * es + n * 4 + b * q * n * es
        return 2.0 * b * q * k * n, byt, _peak(dt)
    if name == "in_stats":
        _, b, h, w, c, dt = key[:6]
        return 0.0, b * h * w * c * _size(dt) + 2 * b * c * 4, _peak(dt)
    if name == "in_normalize":
        _, b, h, w, c, dt, _entry, form = key
        tensors = 3 if form == "residual" else 2
        return 0.0, tensors * b * h * w * c * _size(dt) + 2 * b * c * 4, _peak(dt)
    if name == "attention":
        _, b, n, m, c, cv, _heads, dt = key[:8]
        es = _size(dt)
        return 2.0 * b * n * m * (c + cv), (b * n * c + b * m * (c + cv) + b * n * cv) * es, _peak(dt)
    if name == "window_attention":
        _, b, hp, wp, c, _heads, dt = key[:7]
        return 4.0 * b * hp * wp * WINDOW ** 2 * c, 4 * b * hp * wp * c * _size(dt), _peak(dt)
    if name == "local_corr":
        _, b, h, w, c, r, dt = key[:7]
        es, k2 = _size(dt), (2 * key[5] + 1) ** 2
        return 2.0 * b * h * w * c * k2, (2 * b * h * w * c + b * h * w * k2) * es, _peak(dt)
    raise KeyError(f"no operation count for kernel {name!r}")


def least_seconds(key: Tuple) -> float:
    ops, byt, peak = work(key)
    return max(ops / peak, byt / HBM_BYTES)


def least_total(launch_shapes: Dict[Tuple, int]) -> float:
    """The least time of every counted launch, summed (seconds)."""
    return sum(n * least_seconds(k) for k, n in launch_shapes.items())


def count_flops(fn) -> float:
    """The model FLOPs `fn()` runs, by `torch.utils.flop_counter`
    (matrix products, convolutions, attention; a multiply-add is 2)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())
