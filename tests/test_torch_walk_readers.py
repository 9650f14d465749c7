"""The benchmark's readers of ALT_CORR's walk (`benchmark/metrics/
corr_{product,pyramid,lookup}_ms.serve.py` over `harness/sweep.py`) on a
synthetic trace shaped as a traced 4K request's: about 2,500 device spans
of the walk nested in the refinements' spans, kernels inside them, between
them and across their ends. Each reads what `harness/trace.py::
kernel_seconds_in` reads, the three together in under a second; a trace
without the spans (a program that lacks them) reads nothing.
"""

import random
import sys
import time
import types
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness.cells import metric_reader  # noqa: E402
from harness.sweep import kernel_seconds_within  # noqa: E402
from harness.trace import Trace, kernel_seconds_in  # noqa: E402

WALK = ("ff.corr.product", "ff.corr.pyramid", "ff.corr.lookup")
READERS = {f"corr_{name.split('.')[-1]}_ms.serve": name for name in WALK}
STEPS = 3


def _trace(chunks: int = 70, iters: int = 4, seed: int = 0) -> Trace:
    """`STEPS` requests, each one refinement span over `iters` x `chunks`
    chunks: a product, a pyramid and a lookup span a chunk, each holding
    1-4 kernels, with the refinement's own kernels between chunks and now
    and then a kernel that starts inside a span and ends past it."""
    rng = random.Random(seed)
    kernels, ann, t = [], [], 0.0
    for _ in range(STEPS):
        start = t
        for _ in range(iters):
            for _ in range(chunks):
                for name in WALK:
                    s = t
                    for _ in range(rng.randint(1, 4)):
                        d = rng.uniform(1.0, 40.0)
                        kernels.append(("k", t, t + d))
                        t += d + rng.uniform(0.0, 3.0)
                    ann.append((name, s, kernels[-1][2]))
                    if rng.random() < 0.05:  # across the span's end
                        kernels.append(("k", kernels[-1][2] - 0.5, t + 2.0))
                        t += 3.0
                kernels.append(("gru", t, t + 5.0))
                t += 6.0
        ann.append(("ff.model.refine", start, t))
        t += 100.0
    return Trace(kernels, ann, [], window_s=t / 1e6)


def test_the_sweep_reads_what_kernel_seconds_in_reads():
    tr = _trace()
    assert 2400 <= sum(n in WALK for n, _, _ in tr.annotations) <= 2600
    for name in WALK + ("ff.model.refine",):
        assert kernel_seconds_within(tr, name) == pytest.approx(kernel_seconds_in(tr, name),
                                                                rel=1e-12)
    # nested and overlapping spans of one name: a kernel counts where any holds it
    tr = Trace([("k", 0, 4), ("k", 5, 9), ("k", 8, 12), ("k", 13, 14)],
               [("a", 0, 10), ("a", 1, 4), ("a", 7, 12)], [], 1.0)
    assert kernel_seconds_within(tr, "a") == kernel_seconds_in(tr, "a") == 12e-6


def test_the_walk_readers_read_kernel_ms_a_request_in_under_a_second():
    tr = _trace(seed=1)
    ctx = types.SimpleNamespace(mode="serve", trace=tr, slice_steps=STEPS)
    t0 = time.perf_counter()
    got = {metric: metric_reader(metric)(ctx) for metric in READERS}
    assert time.perf_counter() - t0 < 1.0
    for metric, name in READERS.items():
        assert got[metric] == pytest.approx(1e3 * kernel_seconds_in(tr, name) / STEPS,
                                            rel=1e-12)
    assert sum(got.values()) < 1e3 * kernel_seconds_in(tr, "ff.model.refine") / STEPS


@pytest.mark.parametrize("metric", sorted(READERS))
def test_a_trace_without_the_walk_reads_nothing(metric):
    tr = _trace(chunks=4)
    bare = Trace(tr.kernels, [a for a in tr.annotations if a[0] not in WALK], [], tr.window_s)
    read = metric_reader(metric)
    assert read(types.SimpleNamespace(mode="serve", trace=bare, slice_steps=STEPS)) is None
    assert read(types.SimpleNamespace(mode="train", trace=tr, slice_steps=STEPS)) is None
