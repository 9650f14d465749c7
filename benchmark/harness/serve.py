"""The serving driver: `predict.py::FlowPredictor.__call__` on requests of
`batch` frame pairs, from one client in a closed loop (each request starts
when the last one's flow is in host memory), over a pool of distinct
requests made from the seed.

Set-up: the predictor built from the configuration in its serving type
with seeded weights, the pool made on the card and copied to host numpy
(NHWC f32 frames of 0..255 values and 0/255 keypoint masks, as a user's
decoded frames), and `warmup_requests` requests. The window: requests
until `seconds` have passed; every request's latency from the call to the
flow in host memory. With `--trace 1` the window is followed by
`trace_requests` requests called in `__call__`'s three steps (`prepare`,
`forward`, the copy to the host) and timed on the host clock without the
profiler, whose own host time on every launch would count in them, and
then by a slice of as many requests under the profiler for the device's
numbers.

`correct`: a sample of `check_requests` of the requests the window
finished, drawn from the seed as they finish (`Sample`: the window keeps
those flows alone, as a user frees each), is run again by the plain
reference in f32 (TF32 off) on the same inputs and weights once the
window has closed and the program is freed. `flow_gap` is the worst pair's mean end-point error
between the program's flow and the reference's, over one pixel plus the
reference's mean flow magnitude: relative for large flows, absolute for
flows under a pixel. Over the magnitude alone the gap swung with each
seed's flow (random weights give 0.3-1.4 px flows), the end-point error
staying put.
"""

from __future__ import annotations

import contextlib
import time
import types
from typing import Any, Dict, List, Optional
from unittest import mock

import numpy as np
import torch

from . import traffic as traffic_gen
from .common import Outcome
from .weights import seeded_state


def _node(tree):
    from focusflow_official_tpu_torch.config import ConfigNode

    if isinstance(tree, dict):
        return ConfigNode(**{k: _node(v) for k, v in tree.items()})
    return tree


def build_predictor(config: Dict[str, Any], seed: int, device):
    """The program's predictor on seeded weights -> (predictor, the state
    it loaded, on the host)."""
    from focusflow_official_tpu_torch import predict
    from focusflow_official_tpu_torch.config import config_from_yaml

    cfg = config_from_yaml(_node(config["yaml"]), compute_dtype=config["compute_dtype"])
    held = {}

    def weights(_path, model):
        held["state"] = seeded_state(model.state_dict(), seed, device)
        return held["state"]

    torch.manual_seed(seed)
    with mock.patch.object(predict, "load_weights", weights):
        p = predict.FlowPredictor(cfg, "seeded", device=device)
    return p, {k: v.cpu() for k, v in held["state"].items()}


def make_pool(tr: Dict[str, Any], seed: int, device) -> List[tuple]:
    """`pool_requests` requests of `batch` pairs -> [(image1, image2, mask1,
    mask2) NHWC f32 numpy]."""
    gen = torch.Generator(device=device).manual_seed(seed)
    b, n = tr["batch"], tr["pool_requests"]
    data = traffic_gen.pool(gen, b * n, tr["height"], tr["width"], device)
    host = {k: data[k].cpu().numpy() for k in ("image1", "image2", "mask1", "mask2")}
    return [tuple(np.ascontiguousarray(host[k][i * b:(i + 1) * b])
                  for k in ("image1", "image2", "mask1", "mask2")) for i in range(n)]


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Sample:
    """A uniform sample of `k` of the answers offered, drawn from the seed
    as they come (a reservoir): {request index: flow}."""

    def __init__(self, seed: int, k: int):
        self.rng, self.k, self.slots, self.offered = np.random.default_rng(seed), k, [], 0

    def offer(self, flow: np.ndarray) -> None:
        i = self.offered
        self.offered += 1
        if i < self.k:
            self.slots.append((i, flow))
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < self.k:
                self.slots[j] = (i, flow)

    @property
    def kept(self) -> Dict[int, np.ndarray]:
        return dict(sorted(self.slots, key=lambda kv: kv[0]))


def serve_window(p, pool, seconds: float, device, sample: Sample):
    """The closed loop: -> (latencies s, failed requests, window s); each
    answer is offered to `sample`."""
    lat, failed = [], 0
    _sync(device)
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        try:
            sample.offer(p(*pool[len(lat) % len(pool)]))
        except RuntimeError:  # a failed request counts, and the loop goes on
            failed += 1
        te = time.perf_counter()
        lat.append(te - ts)
        if te - t0 >= seconds:
            return lat, failed, te - t0


def enqueue_times(p, pool, n: int, device) -> List[float]:
    """`n` requests in `__call__`'s three steps, no profiler -> the host
    seconds of each from the call until `forward` returns its device
    tensor (`prepare`, then `forward`)."""
    enqueue = []
    _sync(device)
    for i in range(n):
        ts = time.perf_counter()
        out = p.forward(*p.prepare(*pool[i % len(pool)]))[0]
        enqueue.append(time.perf_counter() - ts)
        out.cpu().numpy()
    return enqueue


def traced_slice(p, pool, n: int, device):
    """`n` requests under the profiler, each in `__call__`'s three steps ->
    (the trace, the launch shapes)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from focusflow_official_tpu_torch import kernels

    from .trace import read_profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    _sync(device)
    kernels.reset_launch_counts()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            with record_function("bench.prepare"):
                inputs = p.prepare(*pool[i % len(pool)])
            with record_function("bench.forward"):
                out = p.forward(*inputs)[0]
            with record_function("bench.to_host"):
                out.cpu().numpy()
        _sync(device)
        window = time.perf_counter() - t0
    shapes = dict(kernels.launch_shapes)
    return read_profile(prof, window), shapes


def request_flops(config: Dict[str, Any], tr: Dict[str, Any]) -> float:
    """Model FLOPs of one request: the reference's test-mode forward at the
    padded size, counted on the meta device."""
    from reference.frozen.padding import InputPadder

    from .cells import reference_family
    from .roofline import count_flops

    fam = reference_family(config["family"])
    b = tr["batch"]
    h, w = InputPadder((b, tr["height"], tr["width"], 3)).pad(
        torch.empty(b, tr["height"], tr["width"], 3, device="meta")).shape[1:3]
    with torch.device("meta"):
        model = fam.build(config["yaml"]).eval()
        img, mask = torch.empty(b, h, w, 3), torch.empty(b, h, w, 1)

    def fwd():
        with torch.no_grad():
            model(img, img, mask, mask)

    return count_flops(fwd)


def reference_flows(config: Dict[str, Any], state, requests, device,
                    lower: bool = False) -> List[np.ndarray]:
    """The plain reference's flow (B, H, W, 2) for each request, f32 with
    TF32 off (with `lower`: the fp8 control, `reference/lowp.py`)."""
    from reference.frozen.padding import InputPadder
    from reference.frozen.precision import no_tf32
    from reference.lowp import fp8

    from .cells import reference_family

    model = reference_family(config["family"]).build(config["yaml"])
    model.load_state_dict(state)
    model.to(device).eval()
    out = []
    with torch.no_grad(), no_tf32(), (fp8() if lower else contextlib.nullcontext()):
        for req in requests:
            t = [torch.as_tensor(a, device=device) for a in req]
            padder = InputPadder(t[0].shape)
            flow = model(*padder.pad(*t))[1]
            out.append(padder.unpad(flow).cpu().numpy())
    del model
    return out


def flow_gap(program: np.ndarray, reference: np.ndarray) -> float:
    """The worst pair's mean end-point error against the reference, over
    1 px plus the reference's mean flow magnitude."""
    epe = np.linalg.norm(program.astype(np.float64) - reference, axis=-1).mean(axis=(1, 2))
    mag = np.linalg.norm(reference.astype(np.float64), axis=-1).mean(axis=(1, 2))
    return float((epe / (1.0 + mag)).max())


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        fault: Optional[str] = None) -> Outcome:
    tr, config = cell.traffic, cell.config
    p, state = build_predictor(config, seed, device)
    if fault is not None:
        _plant(p, fault)
    pool = make_pool(tr, seed, device)
    for i in range(tr["warmup_requests"]):
        p(*pool[i % len(pool)])
    _sync(device)
    setup_s = time.perf_counter() - t_start
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    sample = Sample(seed, tr["check_requests"])
    lat, failed, window_s = serve_window(p, pool, seconds, device, sample)
    peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0
    n, b = len(lat), tr["batch"]
    e2e = dict(serve_pairs_per_s=n * b / window_s,
               serve_p95_ms=float(np.percentile(np.asarray(lat) * 1e3, 95)),
               peak_mem_gib=peak / 2 ** 30, setup_s=setup_s)
    ctx = sl = None
    if trace:
        enqueue = enqueue_times(p, pool, tr["trace_requests"], device)
        tr_, shapes = traced_slice(p, pool, tr["trace_requests"], device)
        ctx = types.SimpleNamespace(
            mode="serve", trace=tr_, launch_shapes=shapes, slice_steps=tr["trace_requests"],
            window_s=window_s, window_steps=n, flops_per_step=None,
            host_s={"enqueue": enqueue})
        sl = tr_
    del p
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    kept = sample.kept
    ref = reference_flows(config, state, [pool[i % len(pool)] for i in kept], device)
    checks = {"flow_gap": max(flow_gap(f, r) for f, r in zip(kept.values(), ref))}
    out = Outcome(attempted=n, failed=failed, end_to_end=e2e, layer_ctx=ctx, checks=checks,
                  memory_peak_bytes=int(peak))
    if trace:
        from .trace import busy_s, idle_gaps, top_kernels

        ctx.flops_per_step = request_flops(config, tr)
        out.busy_s, out.window_s = busy_s(sl), sl.window_s
        out.breakdown = dict(device_ops=top_kernels(sl), idle_gaps=idle_gaps(sl))
    return out


def _plant(p, fault: str) -> None:
    """A fault in the timed path, for the test that `correct` catches it:
    'answer' moves the flow of the batch's first pair by one pixel on each
    axis where the predictor produces it."""
    if fault != "answer":
        raise ValueError(f"the serving path has no fault {fault!r}")
    forward = p.forward

    def shifted(*args, **kwargs):
        flow, low = forward(*args, **kwargs)
        flow = flow.clone()
        flow[0] += 1.0
        return flow, low

    p.forward = shifted
