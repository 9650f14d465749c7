"""The port's FF-PWCNet against the JAX package in f32 on the CPU: the CCE
extractor and one decoder level alone on seeded flax weights, the whole
model on the trained fixture (`tests/fixtures/trained_smoke_pwc.npz`, full
width) at an input the /64 resize changes, and the vanilla PWC-Net."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from focusflow_official_tpu.models import FFPWCNet as JFFPWCNet
from focusflow_official_tpu.models import FFRaftConfig as JConfig
from focusflow_official_tpu.models.ff_pwcnet import PWCNet as JPWCNet
from focusflow_official_tpu.nn import pwc as jpwc
from focusflow_official_tpu_torch.compat.weights import load_npz, params_from_jax
from focusflow_official_tpu_torch.models import FFPWCNet, FFPWCNetConfig, PWCNet
from focusflow_official_tpu_torch.nn import pwc as tpwc
from focusflow_official_tpu_torch.predict import FlowPredictor

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "trained_smoke_pwc.npz")
RNG = np.random.RandomState(53)


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(variables) -> dict:
    return {"/".join(k): np.asarray(v) for k, v in
            traverse_util.flatten_dict(variables).items()}


def _pair(seed=0, h=100, w=150):
    """A smooth textured frame (white noise dies in the /64 resize), its
    copy shifted by (5, -3), 3% keypoint masks."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    img1 = np.zeros((h, w, 3), np.float32)
    for _ in range(12):
        fy, fx = rng.uniform(0.02, 0.4, 2)
        img1 += rng.uniform(0.3, 1.0) * np.sin(
            (fy * yy + fx * xx)[..., None] + rng.uniform(0, 6.28, 3))
    img1 = (img1 - img1.min()) * (255.0 / (img1.max() - img1.min()))
    img2 = np.roll(np.roll(img1, -3, 0), 5, 1)
    m1 = ((rng.rand(h, w, 1) > 0.97) * 255).astype(np.float32)
    m2 = ((rng.rand(h, w, 1) > 0.97) * 255).astype(np.float32)
    return img1[None], img2[None], m1[None], m2[None]


def test_load_npz_maps_all_184_arrays_strict():
    sd = load_npz(FIXTURE)
    with np.load(FIXTURE) as raw:
        assert len(sd) == len(raw.files) == 184
        k = raw["params/netFiv/netUpfeat/kernel"]
    model = FFPWCNet(FFPWCNetConfig())
    model.load_state_dict(sd, strict=True)  # raises on any missing/extra key
    w = model.netFiv.netUpfeat.weight  # torch's (I, O, kh, kw)
    assert tuple(w.shape) == (529, 2, 4, 4) and k.shape == (4, 4, 2, 529)
    np.testing.assert_array_equal(w.detach().numpy(), k.transpose(3, 2, 0, 1))
    assert tuple(model.netSix.netOne_0.weight.shape) == (128, 81, 3, 3)
    assert [getattr(model, n).netOne_0.in_channels for n in
            ("netFiv", "netFou", "netThr", "netTwo")] == [213, 181, 149, 117]
    assert model.netRefiner.netMain_0.in_channels == 565


def test_fusion_extractor_matches_jax():
    x = RNG.rand(1, 64, 128, 3).astype(np.float32) * 255
    m = RNG.rand(1, 64, 128, 3).astype(np.float32) * 255
    jmod = jpwc.PWCFusionExtractor(fusion_type="1x1conv")
    variables = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(m))
    want = jmod.apply(variables, jnp.asarray(x), jnp.asarray(m))
    tmod = tpwc.PWCFusionExtractor("1x1conv").eval()
    tmod.load_state_dict(params_from_jax(_flat(variables)), strict=True)
    with torch.inference_mode():
        got = tmod(_t(x), _t(m))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    assert got[5].shape == (1, 1, 2, 196)
    for g, w in zip(got, want):
        # 18 f32 convs deep on 0-255 inputs: relative to the level's size
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        assert float(np.abs(g.numpy() - np.asarray(w)).max()) <= 1e-5 * scale


def test_decoder_level_matches_jax():
    """Level 5 with a previous level: both transposed convs, the scaled
    warp, the cost volume and the DenseNet stack (new channels first)."""
    h, w = 4, 6
    one = RNG.randn(1, h, w, 128).astype(np.float32)
    two = RNG.randn(1, h, w, 128).astype(np.float32)
    prev_flow = RNG.randn(1, h // 2, w // 2, 2).astype(np.float32)
    prev_feat = RNG.randn(1, h // 2, w // 2, 529).astype(np.float32)
    jmod = jpwc.PWCDecoder(level=5)
    args = (jnp.asarray(one), jnp.asarray(two),
            (jnp.asarray(prev_flow), jnp.asarray(prev_feat)))
    variables = jmod.init(jax.random.PRNGKey(2), *args)
    want_flow, want_feat = jmod.apply(variables, *args)
    tmod = tpwc.PWCDecoder(5).eval()
    tmod.load_state_dict(params_from_jax(_flat(variables)), strict=True)
    with torch.inference_mode():
        flow, feat = tmod(_t(one), _t(two), (_t(prev_flow).permute(0, 3, 1, 2),
                                             _t(prev_feat).permute(0, 3, 1, 2)))
    assert feat.shape == (1, 661, h, w) and tmod.feat_dim == 661
    np.testing.assert_allclose(feat.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_feat), rtol=0, atol=1e-4)
    np.testing.assert_allclose(flow.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_flow), rtol=0, atol=1e-4)


def test_ff_pwcnet_matches_jax_at_every_level():
    """Trained fixture, 100x150 (resized to 128x192 inside), f32. Measured:
    the largest |port - JAX| of each decoder level's flow (in that level's
    pixels) and of the test-mode flow at the input's size; bound 1e-3 px."""
    i1, i2, m1, m2 = _pair()
    with np.load(FIXTURE) as raw:
        v = traverse_util.unflatten_dict(
            {tuple(k.split("/")): jnp.asarray(raw[k], jnp.float32)
             for k in raw.files})
    jmodel = JFFPWCNet(JConfig(fusion="parallel", fusion_type="1x1conv"))
    jargs = list(map(jnp.asarray, (i1, i2, m1, m2)))
    want_list = jmodel.apply(v, *jargs, test_mode=False)
    want = np.asarray(jmodel.apply(v, *jargs, test_mode=True))

    model = FFPWCNet(FFPWCNetConfig()).eval()
    model.load_state_dict(load_npz(FIXTURE), strict=True)
    with torch.inference_mode():
        got, got_list = model(*map(_t, (i1, i2, m1, m2)))
    assert got.shape == want.shape == (1, 100, 150, 2)
    assert [tuple(f.shape) for f in got_list] == [
        (1, 32, 48, 2), (1, 16, 24, 2), (1, 8, 12, 2), (1, 4, 6, 2), (1, 2, 3, 2)]
    for lvl, (g, w) in zip((2, 3, 4, 5, 6), zip(got_list, want_list)):
        err = float(np.abs(g.numpy() - np.asarray(w)).max())
        assert err <= 1e-3, f"level {lvl}: {err}"
    assert float(np.abs(got.numpy() - want).max()) <= 1e-3
    assert float(np.abs(want).mean()) > 0.05  # not a comparison of zeros


def test_vanilla_pwcnet_matches_jax():
    i1, i2, _, _ = _pair(seed=3, h=64, w=128)
    jmodel = JPWCNet()
    variables = jmodel.init(jax.random.PRNGKey(4), jnp.asarray(i1), jnp.asarray(i2))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(i1), jnp.asarray(i2),
                                   test_mode=True))
    model = PWCNet().eval()
    model.load_state_dict(params_from_jax(_flat(variables)), strict=True)
    with torch.inference_mode():
        got, levels = model(_t(i1), _t(i2))
    assert got.shape == want.shape == (1, 64, 128, 2) and len(levels) == 5
    # untrained weights on 0-255 inputs: relative to the flow's size
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got.numpy() - want).max()) <= 1e-4 * scale


@pytest.mark.parametrize("fusion", ["parallel", None])
def test_predictor_returns_finite_flow(fusion, tmp_path):
    i1, i2, m1, m2 = _pair(seed=5)
    if fusion is None:  # the vanilla model's weights: the fixture minus the CCE
        with np.load(FIXTURE) as raw:
            flat = {k: raw[k] for k in raw.files
                    if "mask_" not in k and "fusion" not in k}
        path = str(tmp_path / "vanilla.npz")
        np.savez(path, **flat)
    else:
        path = FIXTURE
    p = FlowPredictor(FFPWCNetConfig(fusion=fusion), path, device="cpu")
    flow = p(i1[0], i2[0], m1[0], m2[0])
    assert flow.shape == (100, 150, 2) and flow.dtype == np.float32
    assert np.isfinite(flow).all()
    batch = p(np.concatenate([i1, i1]), np.concatenate([i2, i2]))
    assert batch.shape == (2, 100, 150, 2)


def test_bf16_tracks_f32_on_trained_weights():
    """The bounds of the JAX package's own bf16 gate for this fixture:
    mean |diff| < 0.05 max(mean |flow|, 1), median < 0.1 px."""
    i1, i2, m1, m2 = _pair(seed=6, h=128, w=192)
    f32 = FlowPredictor(FFPWCNetConfig(), FIXTURE, device="cpu")(i1, i2, m1, m2)
    bf16 = FlowPredictor(FFPWCNetConfig(), FIXTURE, device="cpu",
                         dtype=torch.bfloat16)(i1, i2, m1, m2)
    diff = np.abs(bf16 - f32)
    assert float(diff.mean()) < 0.05 * max(float(np.abs(f32).mean()), 1.0)
    assert float(np.median(diff)) < 0.1


def test_ff_pwcnet_needs_parallel_fusion():
    with pytest.raises(ValueError):
        FFPWCNet(FFPWCNetConfig(fusion=None))
    with pytest.raises(TypeError):
        FlowPredictor(object(), FIXTURE, device="cpu")
