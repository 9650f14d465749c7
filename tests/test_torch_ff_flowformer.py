"""The port's FF-FlowFormer end to end against the JAX package's, in f32.

- the trained fixture (`tests/fixtures/trained_smoke_ff.npz`: full width,
  encoder_depth 1, GMA) at 64x96 with 2 refinements;
- seeded random weights at 72x104 with 1 refinement, where the Twins
  sub-sampling and the 7x7 windows do not divide the grids and the flow is
  several pixels, so a relative tolerance has force;
- the port alone on the trained shift probe at 8 refinements.

JAX runs its reference-semantics decoder (`corr_impl="xla"`, the NHWC
lookup form) with every `FF_*` override cleared.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from scipy.ndimage import gaussian_filter

from focusflow_official_tpu.models.ff_flowformer import FFFlowFormer as JFF
from focusflow_official_tpu.models.ff_flowformer import FlowFormerConfig as JConfig
from focusflow_official_tpu_torch.compat.weights import load_npz, params_from_jax
from focusflow_official_tpu_torch.models import FFFlowFormer, FlowFormerConfig
from focusflow_official_tpu_torch.predict import FlowPredictor

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "trained_smoke_ff.npz")
_KNOBS = ("FF_DEC_CHUNK", "FF_PALLAS_LSA", "FF_PALLAS_ATTN", "FF_FAST_GELU",
          "FF_PE_FOLD")


def textured_pair(seed=0, h=64, w=96, dx=3, dy=-2):
    """Band-limited noise and its (dx, dy) integer shift, 3% keypoint masks
    (the trained FlowFormer gates' probe, blurred with scipy)."""
    rng = np.random.RandomState(seed)
    base = rng.rand(h, w, 3).astype(np.float32)
    img1 = np.zeros_like(base)
    for sigma, gain in ((1.5, 1.0), (5.0, 2.0), (12.0, 4.0)):
        img1 += gain * gaussian_filter(base, (sigma, sigma, 0), mode="mirror")
    img1 -= img1.min()
    img1 *= 255.0 / max(img1.max(), 1e-6)
    img2 = np.roll(np.roll(img1, dy, 0), dx, 1)
    m1 = ((rng.rand(h, w, 1) > 0.97) * 255).astype(np.float32)
    m2 = ((rng.rand(h, w, 1) > 0.97) * 255).astype(np.float32)
    return img1, img2, m1, m2, (dx, dy)


def _random_weights(seed=7):
    """Seeded weights of the fixture's shapes: kernels ~ N(0, 1/fan_in),
    LayerNorm scales ~ 1 + N(0, 0.1), every other leaf ~ N(0, 0.1)."""
    rng = np.random.RandomState(seed)
    flat = {}
    with np.load(FIXTURE) as raw:
        for k in raw.files:
            shape, leaf = raw[k].shape, k.rsplit("/", 1)[1]
            if leaf == "kernel":
                a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
            elif leaf == "scale":
                a = 1 + 0.1 * rng.randn(*shape)
            else:
                a = 0.1 * rng.randn(*shape)
            flat[k] = a.astype(np.float32)
    return flat


def _jax_flow(flat, cfg, inputs):
    v = traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(a, jnp.float32) for k, a in flat.items()})
    with pytest.MonkeyPatch.context() as mp:
        for knob in _KNOBS:
            mp.delenv(knob, raising=False)
        up, lr = JFF(cfg).apply(v, *map(jnp.asarray, inputs), test_mode=True)
    return np.asarray(lr), np.asarray(up)


def _port_flow(sd, cfg, inputs):
    model = FFFlowFormer(cfg).eval()
    model.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        lr, up = model(*map(torch.from_numpy, inputs))
    return lr.numpy(), up.numpy()


@pytest.fixture(scope="module")
def trained_case():
    i1, i2, m1, m2, _ = textured_pair(seed=1)
    inputs = (i1[None], i2[None], m1[None], m2[None])
    with np.load(FIXTURE) as raw:
        flat = {k: raw[k] for k in raw.files}
    want = _jax_flow(flat, JConfig(encoder_depth=1, decoder_depth=2, corr_impl="xla"),
                     inputs)
    return inputs, want


@pytest.fixture(scope="module")
def random_case():
    rng = np.random.RandomState(3)
    i1 = (rng.rand(1, 72, 104, 3) * 255).astype(np.float32)
    i2 = np.roll(np.roll(i1, -2, 1), 3, 2)
    m1 = ((rng.rand(1, 72, 104, 1) > 0.97) * 255).astype(np.float32)
    m2 = ((rng.rand(1, 72, 104, 1) > 0.97) * 255).astype(np.float32)
    inputs = (i1, i2, m1, m2)
    flat = _random_weights()
    want = _jax_flow(flat, JConfig(encoder_depth=1, decoder_depth=1, corr_impl="xla"),
                     inputs)
    return inputs, flat, want


def test_fixture_loads_strict():
    sd = load_npz(FIXTURE)
    with np.load(FIXTURE) as raw:
        assert len(sd) == len(raw.files) == 445
        kernel = raw["params/memory_decoder/decoder_layer_cross_attend_k/kernel"]
    model = FFFlowFormer(FlowFormerConfig(encoder_depth=1))
    model.load_state_dict(sd, strict=True)  # raises on any missing/extra key
    w = model.memory_decoder.decoder_layer_cross_attend_k.weight
    np.testing.assert_array_equal(w.detach().numpy(), kernel.T)
    tokens = model.memory_encoder.cost_perceiver_encoder.latent_tokens
    assert tuple(tokens.shape) == (1, 8, 128)


def test_converter_rejects_unknown_leaves():
    with pytest.raises(KeyError):
        params_from_jax({"params/a/b/unknown": np.zeros(3, np.float32)})
    with pytest.raises(KeyError):
        params_from_jax({"params/a/kernel": np.zeros((2, 2, 2), np.float32)})


def test_trained_flow_matches_jax(trained_case):
    inputs, (want_lr, want) = trained_case
    got_lr, got = _port_flow(load_npz(FIXTURE),
                             FlowFormerConfig(encoder_depth=1, decoder_depth=2), inputs)
    assert got.shape == want.shape == (1, 64, 96, 2)
    # the port's stated parity with the JAX package: 1e-2 px
    assert float(np.abs(got_lr - want_lr).max()) <= 1e-2
    assert float(np.abs(got - want).max()) <= 1e-2


def test_random_weight_flow_matches_jax(random_case):
    inputs, flat, (want_lr, want) = random_case
    got_lr, got = _port_flow(params_from_jax(flat),
                             FlowFormerConfig(encoder_depth=1, decoder_depth=1), inputs)
    assert got.shape == want.shape == (1, 72, 104, 2)
    scale = float(np.abs(want).max())
    assert scale > 5.0  # multi-pixel flow: the relative bound below has force
    # f32 through the whole model, sums in other orders (measured ~5e-6 of
    # the largest flow): 1e-4 of it
    assert float(np.abs(got - want).max()) <= 1e-4 * scale
    assert float(np.abs(got_lr - want_lr).max()) <= 1e-4 * scale


def test_predictor_recovers_shift():
    """The trained weights, through the port's entry point, on the shift
    probe at 8 refinements: interior EPE under the JAX gate's 6 px (zero
    flow scores 3.6 px, untrained weights ~300 px)."""
    i1, i2, m1, m2, (dx, dy) = textured_pair(seed=5)
    p = FlowPredictor(FlowFormerConfig(encoder_depth=1, decoder_depth=8), FIXTURE,
                      device="cpu")
    flow = p(i1, i2, m1, m2)
    assert flow.shape == (64, 96, 2) and np.isfinite(flow).all()
    epe = np.sqrt(((flow[8:-8, 8:-8] - np.array([dx, dy])) ** 2).sum(-1))
    assert float(epe.mean()) < 6.0, float(epe.mean())


def test_predictor_pads_to_eight():
    """A frame size that is not a multiple of 8 is padded and cropped back."""
    i1, i2, m1, m2, _ = textured_pair(seed=2, h=61, w=90)
    p = FlowPredictor(FlowFormerConfig(encoder_depth=1, decoder_depth=1), FIXTURE,
                      device="cpu")
    flow = p(i1, i2, m1, m2)
    assert flow.shape == (61, 90, 2) and np.isfinite(flow).all()


def test_unported_options_raise():
    """The unported variants have no field (the frozen dataclass refuses
    them; `fusion` is a field since vanilla FlowFormer is ported), and a
    model with no refinement has no upsampling mask."""
    for kw in ({"gma": False}, {"use_mlp": True}, {"cost_heads_num": 2}):
        with pytest.raises(TypeError):
            FlowFormerConfig(**kw)
    assert FlowFormerConfig(fusion=None).fusion is None
    with pytest.raises(ValueError):
        FFFlowFormer(FlowFormerConfig(decoder_depth=0))
