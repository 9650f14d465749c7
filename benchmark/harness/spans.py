"""The device intervals of the program's own profiler ranges
(`focusflow_official_tpu_torch/trace.py`) in a traced slice.

The profiler gives a range a device span from the first to the last kernel
whose innermost range it is, so a range that holds another range (the
optimizer's holds AdamW's own `Optimizer.step#AdamW.step`, the forward
holds the model's stages) has a device span that leaves their kernels out.
`extents` puts them back: each device span is paired with a host range of
its name, and counts for every range that holds that host range on the
host's clock. Where a name has as many device spans as host ranges, the
k-th span is the k-th range's. Pairing by time (the range that opened last
before the span's first kernel) is the fallback: where the card waits on
the host, a range's first kernel starts within microseconds of the range's
opening, and the profiler's alignment of the card's clock to the host's
(redone in each profiling session) can put the kernel before it.

The backward's kernels run from autograd's own thread, which holds none of
the main thread's ranges; the backward is read as the interval between the
forward's device interval and the optimizer's.

A phase is read as the kernel time inside its interval, not the interval's
length: under the profiler the host runs slower, and the card waits on it
inside every phase, so a length would read the host's pace.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from .trace import Trace, union_us

Interval = Tuple[float, float]


def _pairs(host: List[Interval], device: List[Interval]):
    """(host range, device span) pairs of one name: by order where the
    counts agree, else each span with the range that opened last before it."""
    if len(host) == len(device):
        return list(zip(host, device))
    opened_at = [s for s, _ in host]
    pairs = []
    for ds, de in device:
        k = bisect.bisect_right(opened_at, ds) - 1
        if k >= 0:
            pairs.append((host[k], (ds, de)))
    return pairs


def extents(trace: Trace, name: str) -> List[Optional[Interval]]:
    """For each host instance of the range `name`, by start: the device
    interval (us) from the first kernel to the last of it and of the ranges
    it holds, or None where none of them launched a kernel."""
    host: Dict[str, List[Interval]] = {}
    for n, s, e in trace.host:
        host.setdefault(n, []).append((s, e))
    outer = sorted(host.get(name, []))
    if not outer:
        return []
    device: Dict[str, List[Interval]] = {}
    for n, s, e in trace.annotations:
        device.setdefault(n, []).append((s, e))
    starts = [s for s, _ in outer]
    found: List[Optional[Interval]] = [None] * len(outer)
    for n, spans in device.items():
        for (hs, he), (ds, de) in _pairs(sorted(host.get(n, [])), sorted(spans)):
            i = bisect.bisect_right(starts, hs) - 1
            # the outer instances do not overlap one another: only the last to open can hold it
            if i < 0 or he > outer[i][1]:
                continue
            cur = found[i]
            found[i] = (ds, de) if cur is None else (min(cur[0], ds), max(cur[1], de))
    return found


def step_phases(trace: Trace) -> List[Tuple[Interval, Interval]]:
    """The i-th `ff.step.forward`'s device interval with the i-th
    `ff.step.optimizer`'s, for each step where both launched kernels."""
    pairs = zip(extents(trace, "ff.step.forward"), extents(trace, "ff.step.optimizer"))
    return [(f, o) for f, o in pairs if f is not None and o is not None]


def busy_us(trace: Trace, start: float, end: float) -> float:
    """The length of [start, end] in which some kernel ran."""
    return union_us([(max(s, start), min(e, end)) for _, s, e in trace.kernels
                     if s < end and e > start])
