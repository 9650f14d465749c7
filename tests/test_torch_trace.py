"""The port's profiler ranges (`focusflow_official_tpu_torch/trace.py`) on
the CPU.

- A train step of FF-RAFT and of FF-FlowFormer (the fixtures' weights, an
  on-card augmentor on raw 80x112 pairs cropped to 64x96, noise, 2
  refinements, f32) under `torch.profiler.profile` records exactly the
  ranges of `SPANS`, each as often as it opens (FF-RAFT's encoders three
  times: the masks, the fnet, the cnet after the volume; FF-FlowFormer's
  twice, once a tower), the model's inside `ff.step.forward`, and the
  step's phases in their order.
- `FlowPredictor` records the three model ranges inside its call.
- FF-PWCNet's predictor records one `ff.model.encode` and one
  `ff.model.refine` a call, and inside the refinement four `ff.pwc.warp`
  (one a decoder below level 6), five `ff.pwc.corr` and five
  `ff.pwc.dense` (one a level) and one `ff.pwc.context`, in the decoders'
  order; kernel D is called once a level, at five shapes (on the CPU its
  wrapper takes the plain version and counts no launch, so the calls are
  counted).
- ALT_CORR's forward walk records each of the two `ff.corr.*` ranges
  once a chunk walked (each chunk's `chunk_levels` call), inside
  `ff.model.refine`; the materialized volume records none of them and
  walks no chunk.
- With no profiler a span is the shared null context and never enters
  `record_function`.
- The loss, the parameters after the step and the served flows (FF-PWCNet's
  too) are bit-equal with and without the profiler.
"""

import copy
import os
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from focusflow_official_tpu_torch import trace
from focusflow_official_tpu_torch.compat.weights import load_npz
from focusflow_official_tpu_torch.data.device_aug import DeviceFlowAugmentor
from focusflow_official_tpu_torch.data.synthetic import chairs_layout
from focusflow_official_tpu_torch.losses import build_sequence_loss
from focusflow_official_tpu_torch.models import (FFFlowFormer, FFPWCNetConfig, FFRaft,
                                                  FFRaftConfig, FlowFormerConfig)
from focusflow_official_tpu_torch.nn import pwc as pwc_nn
from focusflow_official_tpu_torch.ops import corr as corr_ops
from focusflow_official_tpu_torch.ops.corr import chunk_levels
from focusflow_official_tpu_torch.ops.local_corr import local_corr
from focusflow_official_tpu_torch.predict import FlowPredictor
from focusflow_official_tpu_torch.train.loop import build_optimizer, train_step
from focusflow_official_tpu_torch.train.schedule import one_cycle

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
B, RAW, CROP, ITERS = 2, (80, 112), (64, 96), 2
KEYS = ("image1", "image2", "mask1", "mask2", "flow", "valid")
MODEL_SPANS = ("ff.model.encode", "ff.model.cost", "ff.model.refine")
WALK_SPANS = ("ff.corr.product", "ff.corr.lookup")
PWC_SPANS = ("ff.pwc.warp", "ff.pwc.corr", "ff.pwc.dense", "ff.pwc.context")
FAMILIES = {
    "ff_raft": (lambda: FFRaftConfig(fusion="parallel", fuse_cnet=True, iters=ITERS),
                FFRaft, "trained_smoke.npz", 3),
    "ff_flowformer": (lambda: FlowFormerConfig(encoder_depth=1, decoder_depth=ITERS),
                      FFFlowFormer, "trained_smoke_ff.npz", 2),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs its files in parallel worker
    processes, and torch's default of a thread a core in each of them
    oversubscribes the CPU many times over."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _model(family):
    cfg, cls, weights, _ = FAMILIES[family]
    model = cls(cfg())
    model.load_state_dict(load_npz(os.path.join(FIXTURES, weights)), strict=True)
    return model.train()


def _raw_batch():
    ds = chairs_layout(0, n=B, h=RAW[0], w=RAW[1])
    return {k: torch.from_numpy(np.stack([ds[i][k] for i in range(B)]).astype(np.float32))
            for k in KEYS}


def _step(model):
    """One step of `model` on the raw batch, its generators seeded -> the
    float metrics."""
    opt = build_optimizer(model, 4e-4)
    metrics = train_step(model, opt, one_cycle(opt, 100), build_sequence_loss("MixLoss"),
                         _raw_batch(), iters=ITERS, clip=1.0,
                         noise=torch.Generator().manual_seed(0),
                         augment=DeviceFlowAugmentor(CROP),
                         aug_gen=torch.Generator().manual_seed(1))
    return {k: float(v) for k, v in metrics.items()}


def _ranges(prof, keep):
    """The host events whose name `keep` takes: [(name, start ns, end ns)]
    by start."""
    return sorted(((e.name(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events() if keep(e.name())),
                  key=lambda r: r[1])


def _ours(name):
    return name in trace.SPANS or name.startswith("ff.")


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_a_train_step_records_each_span(family):
    model = _model(family)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _step(model)
    ours = _ranges(prof, _ours)
    counts = Counter(name for name, _, _ in ours)
    assert counts == Counter({"ff.step.forward": 1, "ff.step.backward": 1,
                              "ff.step.optimizer": 1, "device_aug": 1,
                              "ff.model.encode": FAMILIES[family][3], "ff.model.cost": 1,
                              "ff.model.refine": 1})
    # every range but ALT_CORR's walk, which the materialized volume never
    # opens, and PWC-Net's decoders', which FF-RAFT and FF-FlowFormer have not
    assert set(counts) == set(trace.SPANS) - set(WALK_SPANS) - set(PWC_SPANS)
    phases = {r[0]: r for r in ours if r[0] not in MODEL_SPANS}
    order = ["device_aug", "ff.step.forward", "ff.step.backward", "ff.step.optimizer"]
    assert all(phases[a][2] <= phases[b][1] for a, b in zip(order, order[1:]))
    stages = [r for r in ours if r[0] in MODEL_SPANS]
    assert all(_inside(r, phases["ff.step.forward"]) for r in stages)
    # the model's stages open in the forward's order: refinements last
    assert stages[-1][0] == "ff.model.refine"
    assert stages[0][0] == "ff.model.encode"


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_the_predictor_records_the_model_spans_inside_its_call(family):
    cfg, _, weights, n_encode = FAMILIES[family]
    p = FlowPredictor(cfg(), os.path.join(FIXTURES, weights), device="cpu")
    batch = _raw_batch()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("call"):
            p(*(batch[k][:1, :64, :96].numpy() for k in ("image1", "image2", "mask1", "mask2")))
    (call,) = _ranges(prof, lambda name: name == "call")
    found = _ranges(prof, _ours)
    assert Counter(n for n, _, _ in found) == Counter(
        {"ff.model.encode": n_encode, "ff.model.cost": 1, "ff.model.refine": 1})
    assert all(_inside(r, call) for r in found)


def test_with_no_profiler_a_span_is_the_shared_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert trace.span("ff.step.forward") is trace.span("ff.model.cost")
    with trace.span("ff.model.encode") as entered:
        assert entered is None
    _step(_model("ff_raft"))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_the_profiler_changes_no_value(family):
    model = _model(family)
    twin = copy.deepcopy(model)
    plain = _step(model)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _step(twin)
    assert plain == traced
    for (name, a), b in zip(model.named_parameters(), twin.parameters()):
        assert torch.equal(a, b), name

    cfg, _, weights, _ = FAMILIES[family]
    p = FlowPredictor(cfg(), os.path.join(FIXTURES, weights), device="cpu")
    inputs = [t[:, :64, :96].numpy() for t in (_raw_batch()[k] for k in KEYS[:4])]
    untraced = p(*inputs)
    with profile(activities=[ProfilerActivity.CPU]):
        np.testing.assert_array_equal(p(*inputs), untraced)


@pytest.mark.parametrize("alt_corr", [True, False])
def test_the_alt_corr_walk_records_its_spans_once_a_chunk(alt_corr, monkeypatch):
    """A 64x96 pair has 8 x 12 = 96 queries: chunks of 40 walk 3 a
    refinement (the last a tail of 16), one `chunk_levels` call each."""
    cfg = FFRaftConfig(fusion="parallel", fuse_cnet=True, iters=ITERS, alt_corr=alt_corr,
                       alt_corr_chunk=40)
    model = FFRaft(cfg)
    model.load_state_dict(load_npz(os.path.join(FIXTURES, "trained_smoke.npz")), strict=True)
    batch = _raw_batch()
    inputs = [batch[k][:1, :64, :96] for k in KEYS[:4]]
    chunks = []
    monkeypatch.setattr(corr_ops, "chunk_levels",
                        lambda *a: chunks.append(a[3]) or chunk_levels(*a))
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        model.eval()(*inputs)
    walked = 3 * ITERS if alt_corr else 0
    assert len(chunks) == walked and sum(chunks) == (96 * ITERS if alt_corr else 0)
    found = _ranges(prof, _ours)
    counts = Counter(n for n, _, _ in found)
    assert {n: counts[n] for n in WALK_SPANS} == dict.fromkeys(WALK_SPANS, walked)
    (refine,) = [r for r in found if r[0] == "ff.model.refine"]
    assert all(_inside(r, refine) for r in found if r[0] in WALK_SPANS)
    walk = [r[0] for r in found if r[0] in WALK_SPANS]
    assert walk == list(WALK_SPANS) * walked


def test_the_pwc_predictor_records_its_spans(monkeypatch):
    """A 64x96 pair (resized to 64x128 inside): levels 6 to 2 at 1x2 ...
    16x32; D called once a level, the decoders' spans in their order."""
    p = FlowPredictor(FFPWCNetConfig(), os.path.join(FIXTURES, "trained_smoke_pwc.npz"),
                      device="cpu")
    batch = _raw_batch()
    inputs = [batch[k][:1, :64, :96].numpy() for k in KEYS[:4]]
    untraced = p(*inputs)
    calls = []

    def counted(f1, *args, **kwargs):
        calls.append(tuple(f1.shape))
        return local_corr(f1, *args, **kwargs)

    monkeypatch.setattr(pwc_nn, "local_corr", counted)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("call"):
            traced = p(*inputs)
    np.testing.assert_array_equal(traced, untraced)
    (call,) = _ranges(prof, lambda name: name == "call")
    found = _ranges(prof, _ours)
    assert Counter(n for n, _, _ in found) == Counter(
        {"ff.model.encode": 1, "ff.model.refine": 1, "ff.pwc.warp": 4, "ff.pwc.corr": 5,
         "ff.pwc.dense": 5, "ff.pwc.context": 1})
    assert all(_inside(r, call) for r in found)
    (refine,) = [r for r in found if r[0] == "ff.model.refine"]
    (encode,) = [r for r in found if r[0] == "ff.model.encode"]
    assert encode[2] <= refine[1]
    inner = [r for r in found if r[0] in PWC_SPANS]
    assert all(_inside(r, refine) for r in inner)
    assert [r[0] for r in inner] == (["ff.pwc.corr", "ff.pwc.dense"]
                                     + ["ff.pwc.warp", "ff.pwc.corr", "ff.pwc.dense"] * 4
                                     + ["ff.pwc.context"])
    assert calls == [(1, 64 >> lvl, 128 >> lvl, c)
                     for lvl, c in ((6, 196), (5, 128), (4, 96), (3, 64), (2, 32))]
