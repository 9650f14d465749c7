"""The readers of the program's own ranges (`harness/spans.py`, the
`forward_ms`, `backward_ms`, `optimizer_ms` training metrics and the
`encode_ms`, `cost_ms`, `refine_ms` serving ones) on made-up traces with
answers worked out by hand."""

import types

import pytest

from harness import spans
from harness.cells import metric_reader
from harness.trace import Trace

MS = 1e-3  # one us in ms
TRAIN = ("forward_ms.train", "backward_ms.train", "optimizer_ms.train")
SERVE = ("encode_ms.serve", "cost_ms.serve", "refine_ms.serve")


def _step(t0: float, backward_gap: float):
    """One step at `t0` (us) -> (kernels, device spans, host events). The
    host opens each range before the card runs its kernels. On the card:
    the upload and the augmentation, 40 us idle before the forward, the
    forward 120..210 (the noise and the loss its own kernels, the stages
    the model's ranges, 5 us idle between cnet and refinements and 5 inside
    the refinements), the
    backward 210..300 (no range; `backward_gap` us idle inside), the
    optimizer 300..330 (the clip its own, AdamW's inside its own range),
    then the metrics read back."""
    t = lambda *xs: tuple(x + t0 for x in xs)
    kernels = [("Memcpy HtoD (Pageable -> Device)", *t(50, 60)), ("aug_kernel", *t(60, 80)),
               ("noise_kernel", *t(120, 125)), ("encode_kernel", *t(125, 140)),
               ("cost_kernel", *t(140, 150)), ("cnet_kernel", *t(150, 160)),
               ("refine_kernel", *t(165, 180)), ("refine_kernel", *t(185, 200)),
               ("loss_kernel", *t(200, 210)),
               ("backward_kernel", *t(210, 250)),
               ("backward_kernel", *t(250 + backward_gap, 300)),
               ("clip_kernel", *t(300, 310)), ("multi_tensor_apply_kernel", *t(310, 330)),
               ("Memcpy DtoH (Device -> Pageable)", *t(400, 402))]
    ann = [("bench.step", *t(50, 402)), ("device_aug", *t(60, 80)),
           ("ff.step.forward", *t(120, 210)), ("ff.model.encode", *t(125, 140)),
           ("ff.model.cost", *t(140, 150)), ("ff.model.encode", *t(150, 160)),
           ("ff.model.refine", *t(165, 200)), ("ff.step.optimizer", *t(300, 310)),
           ("Optimizer.step#AdamW.step", *t(310, 330))]
    host = [("bench.step", *t(0, 990)), ("device_aug", *t(40, 60)),
            ("ff.step.forward", *t(100, 200)), ("ff.model.encode", *t(105, 120)),
            ("ff.model.cost", *t(120, 125)), ("ff.model.encode", *t(125, 135)),
            ("ff.model.refine", *t(135, 190)), ("ff.step.backward", *t(200, 240)),
            ("ff.step.optimizer", *t(240, 300)), ("Optimizer.step#AdamW.step", *t(260, 295)),
            ("aten::item", *t(300, 402))]
    return kernels, ann, host


def _trace(*steps) -> Trace:
    k, a, h = [], [], []
    for kernels, ann, host in steps:
        k += kernels
        a += ann
        h += host
    return Trace(k, a, h, window_s=2000e-6)


def _read(name, trace, mode, n=2):
    ctx = types.SimpleNamespace(mode=mode, trace=trace, slice_steps=n)
    return metric_reader(name)(ctx)


def _slowed(step, d: float):
    """The step with `d` us more idle before each of its kernels, as a host
    that issues the work slower leaves the card: the ranges stretch, the
    kernels stay as they were."""
    kernels, ann, host = step
    order = sorted(kernels, key=lambda k: k[1])
    start = {k[1]: k[1] + i * d for i, k in enumerate(order)}
    end = {k[2]: k[2] + i * d for i, k in enumerate(order)}
    moved = lambda rows: [(n, start[s], end[e]) for n, s, e in rows]
    return moved(kernels), moved(ann), host


def test_training_phases_over_two_steps():
    tr = _trace(_step(0.0, 10.0), _step(1000.0, 30.0))
    # kernel time: the 5 us between cnet and refinements and the 5 inside
    # the refinements left out
    assert _read("forward_ms.train", tr, "train") == pytest.approx(80 * MS)
    # 10 and 30 us idle inside the backward left out, and its kernels with them
    assert _read("backward_ms.train", tr, "train") == pytest.approx((80 + 60) / 2 * MS)
    # AdamW's kernels count: they lie in a range the optimizer's range holds
    assert _read("optimizer_ms.train", tr, "train") == pytest.approx(30 * MS)


def test_the_phases_sum_to_the_kernel_time_from_forward_to_optimizer():
    tr = _trace(_step(0.0, 10.0))
    parts = sum(_read(n, tr, "train", 1) for n in TRAIN)
    # the step's device interval 120..330 less 5 + 5 us in the forward and
    # 10 in the backward; the upload, the augmentation and the read-back,
    # and the 40 us before the forward, lie outside it
    assert parts == pytest.approx((330 - 120 - 20) * MS)
    (fwd, opt), = spans.step_phases(tr)
    assert (fwd, opt) == ((120, 210), (300, 330))


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_a_slower_host_leaves_the_readings_as_they_were(name):
    mode = "train" if name.endswith(".train") else "serve"
    steps = (_step(0.0, 10.0), _step(1000.0, 30.0))
    slowed = [_slowed(step, 7.0) for step in steps]
    assert _read(name, _trace(*slowed), mode) == pytest.approx(_read(name, _trace(*steps), mode))


@pytest.mark.parametrize("name", TRAIN)
def test_the_card_s_clock_a_little_ahead_of_the_host_s(name):
    # the profiler puts each kernel 30 us earlier against the host: every
    # range's first kernel now starts before the range opens on the host
    late = lambda step: (step[0], step[1], [(n, s + 30.0, e + 30.0) for n, s, e in step[2]])
    steps = (_step(0.0, 10.0), _step(1000.0, 30.0))
    assert _read(name, _trace(*map(late, steps)), "train") == pytest.approx(
        _read(name, _trace(*steps), "train"))


def test_a_forward_without_its_own_kernels_takes_its_stages():
    kernels, ann, host = _step(0.0, 10.0)
    ann = [a for a in ann if a[0] != "ff.step.forward"]
    tr = _trace((kernels, ann, host))
    # the kernels from the first stage's first kernel to the last stage's last
    assert _read("forward_ms.train", tr, "train", 1) == pytest.approx((200 - 125 - 10) * MS)


def test_serving_stages_sum_each_range_over_the_requests():
    tr = _trace(_step(0.0, 10.0), _step(1000.0, 30.0))
    assert _read("encode_ms.serve", tr, "serve") == pytest.approx((15 + 10) * MS)
    assert _read("cost_ms.serve", tr, "serve") == pytest.approx(10 * MS)
    # kernel time: the 5 us idle inside the refinements' span left out
    assert _read("refine_ms.serve", tr, "serve") == pytest.approx(30 * MS)


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_a_trace_without_the_spans_or_of_the_other_mode_reads_none(name):
    mode = "train" if name.endswith(".train") else "serve"
    other = "serve" if mode == "train" else "train"
    kernels, ann, host = _step(0.0, 10.0)
    bare = _trace(([k for k in kernels], [a for a in ann if a[0] == "bench.step"],
                   [h for h in host if not h[0].startswith("ff.")]))
    assert _read(name, bare, mode) is None
    assert _read(name, _trace(_step(0.0, 10.0)), other) is None
    assert _read(name, _trace(_step(0.0, 10.0)), mode) is not None
