"""Reading a `torch.profiler` trace: the device kernels from the profiler's
raw records, the busy time as the union of kernel intervals, kernels by
category, the device spans of `record_function` ranges, and the idle gaps
named by what the host was doing (copied from the program's
`chip_smoke.py::_kernel_events`, `_device_breakdown` and `_category`)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

# substrings of the port's kernel names, the longest matching first
PORT_KERNELS = {"lookup_fold_mma": "lookup_fold", "lookup_fold_fma": "lookup_fold",
                "lookup_kernel": "lookup", "fold_kernel": "fold", "fold_mma": "fold",
                "in_stats<": "in_stats", "normalize<": "in_normalize",
                "local_corr_kernel": "local_corr", "local_corr_mma": "local_corr",
                "attn_mma": "attention", "attn_tiled": "attention", "attn_staged": "attention",
                "attn_direct": "attention", "window_mma": "window_attention",
                "window_attn": "window_attention"}
PORT = "port kernels"
COPIES = "host<->device copies"
CONVS = "convolutions (cuDNN)"
MATMULS = "matmuls (cuBLAS, cuDNN gemm)"
LAYER_NORM = "layer norm"
CASTS = "copies and casts (contiguous, dtype, cat)"
ELEMENTWISE = "elementwise, softmax, reductions"


def port_kernel(name: str):
    """The port's kernel a device kernel's name belongs to (`launch_counts`'
    key), or None."""
    for k in sorted(PORT_KERNELS, key=len, reverse=True):
        if k in name:
            return PORT_KERNELS[k]
    return None


def category(name: str) -> str:
    if port_kernel(name):
        return PORT
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return COPIES
    if "fprop" in name or "conv" in name.lower():
        return CONVS
    if "gemm" in name or "cutlass" in name or "nvjet" in name:
        return MATMULS
    if "layer_norm" in name:
        return LAYER_NORM
    if "copy" in name.lower():
        return CASTS
    return ELEMENTWISE


@dataclasses.dataclass
class Trace:
    """A profiled slice: device kernels and annotations, host events, all as
    (name, start us, end us) on the profiler's one clock, and the slice's
    host-clock window."""

    kernels: List[Tuple[str, float, float]]
    annotations: List[Tuple[str, float, float]]   # device spans of record_function ranges
    host: List[Tuple[str, float, float]]           # host ops and ranges
    window_s: float                                 # the slice's host-clock length


def read_profile(prof, window_s: float) -> Trace:
    """The raw records of a finished `torch.profiler.profile`."""
    from torch.autograd import DeviceType

    kernels, ann, host = [], [], []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("Activity Buffer") or getattr(e, "is_hidden_event", lambda: False)():
            continue
        row = (e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
        if e.device_type() == DeviceType.CUDA:
            (ann if e.is_user_annotation() else kernels).append(row)
        else:
            host.append(row)
    return Trace(kernels, ann, host, window_s)


def union_us(spans: Sequence[Tuple[float, float]]) -> float:
    """The length of the union of intervals."""
    busy, end = 0.0, -float("inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def busy_s(trace: Trace) -> float:
    return union_us([(s, e) for _, s, e in trace.kernels]) / 1e6


def idle_share(trace: Trace) -> float:
    return 1.0 - busy_s(trace) / trace.window_s


def by_category(trace: Trace) -> Dict[str, float]:
    """Device seconds of each category (kernel durations summed)."""
    out: Dict[str, float] = {}
    for name, s, e in trace.kernels:
        out[category(name)] = out.get(category(name), 0.0) + (e - s) / 1e6
    return out


def kernel_seconds_in(trace: Trace, annotation: str) -> float:
    """Device seconds of the kernels that lie inside the device spans of
    the `record_function` range `annotation` (the span runs from its first
    kernel to its last, gaps included; only kernel time counts)."""
    spans = [(s, e) for n, s, e in trace.annotations if n == annotation]
    return sum((ke - ks) / 1e6 for _, ks, ke in trace.kernels
               if any(s <= ks and ke <= e for s, e in spans))


def top_kernels(trace: Trace, n: int = 10) -> List[List]:
    """The `n` device operations that took most time: [name, seconds]."""
    by: Dict[str, float] = {}
    for name, s, e in trace.kernels:
        by[name] = by.get(name, 0.0) + (e - s) / 1e6
    return [[k[:160], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(trace: Trace, n: int = 10, longest: int = 400) -> List[List]:
    """The device's idle gaps inside the slice, named by the innermost host
    op or range running at each gap's middle, summed by that name: the `n`
    names with the most idle seconds, [name, seconds]. Only the `longest`
    gaps are named (the rest are launch spacing)."""
    import numpy as np

    spans = sorted((s, e) for _, s, e in trace.kernels)
    gaps, end = [], None
    for s, e in spans:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:longest]
    if not gaps or not trace.host:
        return []
    names = [h[0] for h in trace.host]
    starts = np.array([h[1] for h in trace.host])
    ends = np.array([h[2] for h in trace.host])
    out: Dict[str, float] = {}
    for gs, ge in gaps:
        mid = (gs + ge) / 2
        cover = np.nonzero((starts <= mid) & (ends >= mid))[0]
        label = names[cover[np.argmin(ends[cover] - starts[cover])]] if len(cover) else "(no host op)"
        out[label] = out.get(label, 0.0) + (ge - gs) / 1e6
    return [[k[:160], v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:n]]
