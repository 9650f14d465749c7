"""Kernel time inside the device spans of a range, by one sweep over sorted
intervals: for traces with thousands of spans of a name (ALT_CORR's walk
opens three a chunk, about 2,300 each in a 4K request), where checking
every kernel against every span (`trace.py::kernel_seconds_in`) takes
minutes.

A kernel lies inside some span when a span that starts at or before it
ends at or after it; with the spans sorted by start and the kernels by
start, the latest end among the spans started so far decides, so one pass
over both reads what `kernel_seconds_in` reads.
"""

from __future__ import annotations

from .trace import Trace


def kernel_seconds_within(trace: Trace, annotation: str) -> float:
    """Device seconds of the kernels that lie inside the device spans of the
    `record_function` range `annotation` (the same sum as
    `trace.py::kernel_seconds_in`)."""
    spans = sorted((s, e) for n, s, e in trace.annotations if n == annotation)
    if not spans:
        return 0.0
    total, i, reach = 0.0, 0, -float("inf")
    for ks, ke in sorted((s, e) for _, s, e in trace.kernels):
        while i < len(spans) and spans[i][0] <= ks:
            reach = max(reach, spans[i][1])
            i += 1
        if ke <= reach:
            total += ke - ks
    return total / 1e6
