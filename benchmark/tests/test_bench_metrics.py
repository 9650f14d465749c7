"""The metric arithmetic on made-up traces and windows, and the operation
and byte counts of the roofline and the FLOP counter on tiny shapes,
against counts worked out by hand."""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from harness import roofline, serve, trace
from harness.cells import metric_reader

US = 1e-6


def _trace():
    kernels = [("ampere_bf16_gemm", 0.0, 10.0), ("elementwise_kernel", 5.0, 15.0),
               ("lookup_fold_mma<4>", 20.0, 30.0), ("Memcpy HtoD (Pageable -> Device)", 40.0, 44.0),
               ("Memcpy DtoH (Device -> Pageable)", 46.0, 48.0), ("vectorized_layer_norm", 50.0, 52.0),
               ("reduce_kernel", 60.0, 61.0)]
    ann = [("device_aug", 4.0, 16.0)]
    host = [("bench.step", 0.0, 100.0), ("aten::item", 31.0, 39.0), ("cudaMemcpyAsync", 52.0, 59.0)]
    return trace.Trace(kernels, ann, host, window_s=100 * US)


def test_union_busy_and_idle_share():
    assert trace.union_us([(0, 10), (5, 15), (20, 30)]) == 25
    assert trace.union_us([(0, 10), (2, 3), (10, 12)]) == 12
    t = _trace()
    busy = 15 + 10 + 4 + 2 + 2 + 1
    assert trace.busy_s(t) == pytest.approx(busy * US)
    assert trace.idle_share(t) == pytest.approx(1 - busy / 100)


def test_categories_and_annotation_spans():
    t = _trace()
    cat = trace.by_category(t)
    assert cat[trace.MATMULS] == pytest.approx(10 * US)
    assert cat[trace.ELEMENTWISE] == pytest.approx(11 * US)
    assert cat[trace.PORT] == pytest.approx(10 * US)
    assert cat[trace.COPIES] == pytest.approx(6 * US)
    assert cat[trace.LAYER_NORM] == pytest.approx(2 * US)
    assert trace.port_kernel("lookup_fold_mma<4>") == "lookup_fold"
    assert trace.port_kernel("void fold_mma<64>") == "fold"
    # only the elementwise kernel lies inside the device_aug span
    assert trace.kernel_seconds_in(t, "device_aug") == pytest.approx(10 * US)


def test_idle_gaps_are_named_by_the_host():
    gaps = dict(trace.idle_gaps(_trace()))
    assert gaps["aten::item"] == pytest.approx(10 * US)       # 30..40
    assert gaps["cudaMemcpyAsync"] == pytest.approx(8 * US)   # 52..60
    assert gaps["bench.step"] == pytest.approx(9 * US)        # 15..20, 44..46, 48..50
    assert list(gaps) == ["aten::item", "bench.step", "cudaMemcpyAsync"]


def test_a_rate_over_a_window_with_a_stall_and_p95_over_all_requests(monkeypatch):
    clock = {"t": 0.0}
    monkeypatch.setattr(serve.time, "perf_counter", lambda: clock["t"])
    costs = iter([0.1] * 9 + [2.0] + [0.1] * 100)

    def predictor(*_):
        clock["t"] += next(costs)
        return None

    sample = serve.Sample(1, 2)
    lat, failed, window = serve.serve_window(predictor, [(0,)], 3.0, "cpu", sample)
    assert failed == 0 and sample.offered == 11 and len(sample.kept) == 2
    # 9 requests of 0.1 s, the stall of 2 s, one more request: 3 s have passed
    assert window == pytest.approx(3.0) and len(lat) == 11
    # the rate is over all the window's time, the stall's included: 11 requests in 3 s
    assert len(lat) / window == pytest.approx(11 / 3.0)
    # the 95th percentile of all 11 latencies lies between the tenth (0.1) and the stall
    assert float(np.percentile(np.asarray(lat), 95)) == pytest.approx(0.1 + 0.5 * 1.9)


def test_the_sample_is_uniform_over_every_answer_and_repeats_by_seed():
    counts = np.zeros(20)
    for seed in range(2000):
        sample = serve.Sample(seed, 3)
        for i in range(20):
            sample.offer(i)
        kept = sample.kept
        assert len(kept) == 3 and all(kept[i] == i for i in kept)
        counts[list(kept)] += 1
    assert counts.min() > 0.8 * 300 and counts.max() < 1.2 * 300  # 3/20 of 2000 each
    again = serve.Sample(7, 3)
    for i in range(20):
        again.offer(i)
    first = serve.Sample(7, 3)
    for i in range(20):
        first.offer(i)
    assert list(again.kept) == list(first.kept)


def _ctx(mode, **kw):
    base = dict(mode=mode, trace=_trace(), launch_shapes={}, slice_steps=2, window_s=2.0,
                window_steps=10, flops_per_step=989e12 * 0.01, host_s={})
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_readers():
    ctx = _ctx("serve", host_s={"enqueue": [0.01, 0.03]})
    assert metric_reader("enqueue_ms.serve")(ctx) == pytest.approx(20.0)
    assert metric_reader("copy_ms.serve")(ctx) == pytest.approx(6 * US / 2 * 1e3)
    assert metric_reader("elementwise_ms.serve")(ctx) == pytest.approx(11 * US / 2 * 1e3)
    assert metric_reader("mfu.serve")(ctx) == pytest.approx(100 * 0.01 * 10 / 2.0)
    # 34 us busy over 2 requests against 2 s over 10 requests in the window
    assert metric_reader("idle_share.serve")(ctx) == pytest.approx(100 * (1 - 17e-6 / 0.2))
    assert metric_reader("kernels_roofline.serve")(ctx) is None  # no launches counted
    tctx = _ctx("train", host_s={"loader_wait": [0.002, 0.004]})
    assert metric_reader("loader_wait_ms.train")(tctx) == pytest.approx(3.0)
    assert metric_reader("aug_ms.train")(tctx) == pytest.approx(10 * US / 2 * 1e3)
    for name in ("enqueue_ms.serve", "copy_ms.serve", "elementwise_ms.serve", "mfu.serve",
                 "idle_share.serve", "kernels_roofline.serve"):
        assert metric_reader(name)(tctx) is None
    for name in ("loader_wait_ms.train", "aug_ms.train", "elementwise_ms.train", "mfu.train",
                 "idle_share.train", "kernels_roofline.train"):
        assert metric_reader(name)(ctx) is None


def test_roofline_reader_against_a_hand_count():
    key = ("fold", 1000, 81, 64, "torch.bfloat16")
    ctx = _ctx("serve", launch_shapes={key: 1})
    least = (1000 * 81 + 64 * 81 + 1000 * 64) * 2 + 64 * 4
    # the port's kernel took 10 us in the trace
    assert metric_reader("kernels_roofline.serve")(ctx) == pytest.approx(
        100 * least / 3.35e12 / (10 * US))


def test_operation_and_byte_counts_by_hand():
    ops, byt, peak = roofline.work(("fold", 4, 8, 3, "torch.bfloat16"))
    assert (ops, byt, peak) == (2 * 4 * 8 * 3, (32 + 24 + 12) * 2 + 3 * 4, 989e12)
    # G at radius 1 over two levels of 3x4 and 1x2, 5 queries of one sample, 6 outputs, f32:
    # taps min(16, 12) + min(16, 2) a query; K = 2 levels x 9
    ops, byt, peak = roofline.work(("lookup_fold", 1, 5, 3, 4, 1, 2, 1, 6, "torch.float32",
                                    "fma", 1, 0))
    assert ops == 2 * 5 * 18 * 6 and peak == 67e12
    assert byt == 5 * 8 + 5 * (12 + 2) * 4 + 6 * 18 * 4 + 6 * 4 + 5 * 6 * 4
    ops, byt, _ = roofline.work(("attention", 2, 10, 7, 16, 8, 2, "torch.bfloat16", "mma"))
    assert ops == 2 * 2 * 10 * 7 * (16 + 8)
    assert byt == (2 * 10 * 16 + 2 * 7 * 24 + 2 * 10 * 8) * 2
    _, byt, _ = roofline.work(("in_normalize", 2, 3, 4, 8, "torch.bfloat16", "vector", "residual"))
    assert byt == 3 * 2 * 3 * 4 * 8 * 2 + 2 * 2 * 8 * 4
    assert roofline.least_seconds(("fold", 4, 8, 3, "torch.bfloat16")) == pytest.approx(
        148 / 3.35e12)


def test_flop_counter_by_hand():
    x, w = torch.randn(4, 8), torch.randn(3, 8)
    assert roofline.count_flops(lambda: F.linear(x, w)) == 2 * 4 * 8 * 3
    img, k = torch.randn(1, 2, 5, 5), torch.randn(3, 2, 3, 3)
    assert roofline.count_flops(lambda: F.conv2d(img, k)) == 2 * 3 * 3 * 3 * 2 * 9
