"""Warm-started sequences, `flow_init` and `pad_to`: the port against the
JAX package on the trained FF-RAFT fixture, f32 at 96x128 with 4
refinements, on the multi-pixel affine clip (`data/synthetic.py`).

- `forward_interpolate` against JAX's: 1e-6 (the same numpy and scipy
  calls; exact in practice).
- `FlowPredictor.sequence` with warm start over 3 frames, the JAX
  predictor loading the fixture as a reference `.pth`; the `flow_init`
  forward of FF-RAFT; `pad_to`: 1e-2 px, the port's stated parity with the
  reference (`test_torch_ff_raft.py`).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from focusflow_official_tpu.compat.torch_import import variables_to_torch_state_dict
from focusflow_official_tpu.ops.coords import forward_interpolate as jax_forward_interpolate
from focusflow_official_tpu.predict import FlowPredictor as JFlowPredictor
from focusflow_official_tpu_torch.data import synthetic
from focusflow_official_tpu_torch.models import FFFlowFormer, FFRaft, FlowFormerConfig
from focusflow_official_tpu_torch.ops.coords import forward_interpolate
from focusflow_official_tpu_torch.predict import FlowPredictor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")
YAML = os.path.join(ROOT, "configs", "smoke_chairs.yaml")  # the fixture's config, 4 iters
TOL = 1e-2


@pytest.mark.parametrize("scale", [0.3, 4.0, 40.0])
def test_forward_interpolate_equals_jax(scale):
    """Small, multi-pixel and large flows (many splats fall outside)."""
    flow = (np.random.RandomState(0).randn(23, 31, 2) * scale).astype(np.float32)
    got = forward_interpolate(flow)
    assert got.dtype == np.float32 and got.shape == flow.shape
    np.testing.assert_allclose(got, jax_forward_interpolate(flow), atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def predictors(tmp_path_factory):
    """(port predictor, JAX predictor) on the same weights, f32; the JAX
    one reads the fixture as a reference .pth, as its users load one."""
    with np.load(os.path.join(FIX, "trained_smoke.npz")) as raw:
        variables = traverse_util.unflatten_dict(
            {tuple(k.split("/")): raw[k] for k in raw.files})
    path = str(tmp_path_factory.mktemp("pth") / "trained_smoke.pth")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in variables_to_torch_state_dict(variables).items()}, path)
    ours = FlowPredictor(YAML, os.path.join(FIX, "trained_smoke.npz"), device="cpu",
                         dtype=torch.float32)
    theirs = JFlowPredictor(YAML, path, compute_dtype="float32", corr_impl="xla")
    return ours, theirs


@pytest.fixture(scope="module")
def clip():
    frames, flows = synthetic.affine_clip(np.random.RandomState(3), 96, 128, 3)
    rng = np.random.RandomState(4)
    masks = [synthetic.keypoint_mask(rng, 96, 128) for _ in frames]
    return frames, masks, flows


@pytest.fixture(autouse=True)
def _no_tpu_knobs(monkeypatch):
    for knob in ("FF_CHUNKED_FNET", "FF_PACKED_CCE", "FF_PACKED_CCE_BN", "FF_PACKED_STEM"):
        monkeypatch.setenv(knob, "0")


def test_sequence_warm_start_equals_jax(predictors, clip):
    ours, theirs = predictors
    frames, masks, _ = clip
    got = ours.sequence(frames, masks, warm_start=True)
    want = theirs.sequence(frames, masks, warm_start=True)
    assert got.shape == want.shape == (2, 96, 128, 2)
    assert float(np.abs(got - want).max()) <= TOL
    cold = ours.sequence(frames, masks, warm_start=False)
    np.testing.assert_array_equal(cold[0], got[0])  # the first pair has no warm start
    assert float(np.abs(cold[1] - got[1]).max()) > 10 * TOL


def test_flow_init_forward_equals_jax(predictors, clip):
    """FF-RAFT from coords0 + flow_init, flow_init a smooth multi-pixel
    field on the /8 grid: both flows (low and full resolution)."""
    from focusflow_official_tpu.train.submission import _forward_with_lowres

    ours, theirs = predictors
    frames, masks, flows = clip
    init = forward_interpolate(flows[0][::8, ::8] / 8.0)
    args = [a[None] for a in (frames[1], frames[2], masks[1], masks[2])]
    forward = _forward_with_lowres(theirs.model, theirs.variables, 4)
    want_up, want_lr = forward(*map(jnp.asarray, args), jnp.asarray(init[None]))
    model = ours.model
    assert isinstance(model, FFRaft)
    with torch.inference_mode():
        got_lr, got_up = model(*map(torch.from_numpy, args), iters=4,
                               flow_init=torch.from_numpy(init[None]))
    assert float(np.abs(got_lr.numpy() - np.asarray(want_lr)).max()) <= TOL
    assert float(np.abs(got_up.numpy() - np.asarray(want_up)).max()) <= TOL
    with torch.inference_mode():
        zero = model(*map(torch.from_numpy, args), iters=4,
                     flow_init=torch.zeros(1, 12, 16, 2))[1]
        none = model(*map(torch.from_numpy, args), iters=4)[1]
    torch.testing.assert_close(zero, none, rtol=0, atol=0)


def test_pad_to_equals_jax(predictors, clip, tmp_path):
    """Each pair edge-padded to 104x136 before the /8 pad, cropped back."""
    ours, theirs = predictors
    frames, masks, _ = clip
    ours.pad_to = theirs.pad_to = (104, 136)
    try:
        got = ours(frames[0], frames[1], masks[0], masks[1])
        want = theirs(frames[0], frames[1], masks[0], masks[1])
    finally:
        ours.pad_to = theirs.pad_to = None
    assert got.shape == want.shape == (96, 128, 2)
    assert float(np.abs(got - want).max()) <= TOL
    with pytest.raises(ValueError, match="smaller"):
        FlowPredictor(YAML, os.path.join(FIX, "trained_smoke.npz"), device="cpu",
                      dtype=torch.float32, pad_to=(88, 128))(frames[0], frames[1])


def test_flowformer_iters_and_flow_init():
    """FF-FlowFormer takes `iters` (default decoder_depth) and `flow_init`:
    iters=decoder_depth is the default run to the bit, a zero warm start is
    no warm start, and another count runs that many refinements."""
    torch.manual_seed(0)
    model = FFFlowFormer(FlowFormerConfig(encoder_depth=1, decoder_depth=2)).eval()
    rng = np.random.RandomState(5)
    args = [torch.from_numpy((rng.rand(1, 64, 64, c) * 255).astype(np.float32))
            for c in (3, 3, 1, 1)]
    with torch.inference_mode():
        lr, up = model(*args)
        lr2, up2 = model(*args, iters=2, flow_init=torch.zeros(1, 8, 8, 2))
        lr3, _ = model(*args, iters=3)
    assert torch.equal(up, up2) and torch.equal(lr, lr2)
    assert up.shape == (1, 64, 64, 2) and not torch.equal(lr, lr3)
    with pytest.raises(ValueError, match="iters"):
        model(*args, iters=0)
