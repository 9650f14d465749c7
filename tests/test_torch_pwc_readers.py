"""The benchmark's readers of FF-PWCNet's decoders (`benchmark/metrics/
pwc_{warp,corr,dense,context}_ms.serve.py`) on a synthetic trace shaped as
a traced request's: each of `STEPS` requests an encode span, then a
refinement span holding four decoders below level 6 (a warp, a
correlation and a dense span each), the level-6 decoder (a correlation
and a dense span) and the refiner's span, kernels inside them and the
refinement's own kernels between them. Each reads kernel ms a request
inside its spans, what `harness/trace.py::kernel_seconds_in` reads, and
the four together read every kernel of the refinement but its own; a
trace without the spans (a program that lacks them) and a training trace
read nothing.
"""

import random
import sys
import types
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness.cells import metric_reader  # noqa: E402
from harness.trace import Trace, kernel_seconds_in  # noqa: E402

PARTS = ("warp", "corr", "dense", "context")
SPANS = {f"pwc_{p}_ms.serve": f"ff.pwc.{p}" for p in PARTS}
STEPS = 3


def _trace(seed: int = 0) -> Trace:
    rng = random.Random(seed)
    kernels, ann, t = [], [], 0.0

    def run(name, n):
        nonlocal t
        s = t
        for _ in range(n):
            d = rng.uniform(1.0, 30.0)
            kernels.append(("k", t, t + d))
            t += d + rng.uniform(0.0, 2.0)
        ann.append((name, s, kernels[-1][2]))

    for _ in range(STEPS):
        run("ff.model.encode", 20)
        start = t
        kernels.append(("own", t, t + 2.0))
        t += 3.0
        for level in (6, 5, 4, 3, 2):
            if level < 6:
                run("ff.pwc.warp", rng.randint(3, 8))
            run("ff.pwc.corr", 1)
            run("ff.pwc.dense", rng.randint(10, 16))
        run("ff.pwc.context", 13)
        kernels.append(("own", t, t + 4.0))
        t += 5.0
        ann.append(("ff.model.refine", start, t))
        t += 50.0
    return Trace(kernels, ann, [], window_s=t / 1e6)


def test_the_pwc_readers_read_kernel_ms_a_request_inside_their_spans():
    tr = _trace()
    assert [sum(n == name for n, _, _ in tr.annotations) for name in SPANS.values()] == [
        4 * STEPS, 5 * STEPS, 5 * STEPS, STEPS]
    ctx = types.SimpleNamespace(mode="serve", trace=tr, slice_steps=STEPS)
    got = {metric: metric_reader(metric)(ctx) for metric in SPANS}
    for metric, name in SPANS.items():
        assert got[metric] == pytest.approx(1e3 * kernel_seconds_in(tr, name) / STEPS,
                                            rel=1e-12)
        assert got[metric] > 0
    refine = 1e3 * kernel_seconds_in(tr, "ff.model.refine") / STEPS
    assert sum(got.values()) == pytest.approx(refine - 6e-3, rel=1e-12)  # its own 2 + 4 us


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_a_trace_without_the_pwc_spans_reads_nothing(metric):
    tr = _trace(seed=1)
    bare = Trace(tr.kernels, [a for a in tr.annotations if not a[0].startswith("ff.pwc.")],
                 [], tr.window_s)
    read = metric_reader(metric)
    assert read(types.SimpleNamespace(mode="serve", trace=bare, slice_steps=STEPS)) is None
    assert read(types.SimpleNamespace(mode="train", trace=tr, slice_steps=STEPS)) is None
