"""The attention and conv front ends (MODEL.FUSION: attention | conv) in the
port against the JAX package, in f32 on the CPU, on JAX-initialised
parameters (norm scales, batch statistics and the attention's temperature
moved off their identity start) converted by `params_from_jax`, and seeded
numpy inputs, `fusion_channel` 16:

- `nn/attention.py`: `ChannelLayerNorm`, `MutualAttention`, `Mlp` and
  `MaskImageChannelAttentionTransformerBlock`;
- every front-end block: `ConvTranspose2x` (flax's transposed kernel: the
  converter's plain transpose, no flip of its own), `SAM`,
  `UNetConvBlock` (with and without the transformer, with and without the
  downsample), `UNetMaskConvBlock`, `UNetUpBlock`, `FusionLayer`,
  `_GNResBlock`, `ConvEncoder`, `_DecoderBlock`, `ConvDecoder`,
  `ConvFusionLayer` and `ConvPromptLayer`;
- `init_mask`'s `tile_channels`;
- both front ends before a plain RAFT end to end at 64x96, 2 refinements
  (JAX's variable tree, `jax.eval_shape` of its `init`, with seeded
  values: compiling the attention model's init alone takes 30 s): flows
  within 1e-4 x max(1, max |flow|);
- the converter's round trip and the reference `.pth` (JAX's
  `variables_to_torch_state_dict`) loaded `strict=True`.

Module bounds: 2e-5 of the output's scale, as `test_torch_encoders.py`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from focusflow_official_tpu.compat.torch_import import variables_to_torch_state_dict
from focusflow_official_tpu.models import FFRaft as JFFRaft
from focusflow_official_tpu.models import FFRaftConfig as JConfig
from focusflow_official_tpu.models import frontends as jf
from focusflow_official_tpu.models.mask_modal import init_mask as jinit_mask
from focusflow_official_tpu.nn import attention as ja
from focusflow_official_tpu_torch.compat.torch_import import load_torch_pretrained
from focusflow_official_tpu_torch.compat.weights import params_from_jax, params_to_jax
from focusflow_official_tpu_torch.models import FFRaft, FFRaftConfig
from focusflow_official_tpu_torch.models import frontends as tf
from focusflow_official_tpu_torch.models.mask_modal import init_mask
from focusflow_official_tpu_torch.nn import attention as ta

RNG = np.random.RandomState(141)
B, H, W, ITERS, WF = 2, 64, 96, 2, 16


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _flat(variables) -> dict:
    return {"/".join(k): np.asarray(v) for k, v in
            traverse_util.flatten_dict(variables).items()}


def _randomize(variables):
    flat = traverse_util.flatten_dict(variables, sep="/")
    for k, v in flat.items():
        leaf = k.rsplit("/", 1)[-1]
        if k.startswith("batch_stats") and leaf == "mean":
            flat[k] = jnp.asarray(RNG.randn(*v.shape).astype(np.float32) * 0.3)
        elif k.startswith("batch_stats") and leaf == "var":
            flat[k] = jnp.asarray(RNG.uniform(0.5, 2.0, v.shape).astype(np.float32))
        elif leaf in ("scale", "temperature"):
            flat[k] = jnp.asarray(RNG.uniform(0.5, 1.5, v.shape).astype(np.float32))
    return traverse_util.unflatten_dict(flat, sep="/")


def _close(got, want, rel: float = 2e-5) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= rel * scale


def _x(*shape, lo=-1.0, hi=1.0):
    return RNG.uniform(lo, hi, shape).astype(np.float32)


nchw = lambda a: torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)
nhwc = lambda t: t.permute(0, 2, 3, 1).numpy()


def _run(jmod, tmod, args, layout="nchw"):
    """Init `jmod` on NHWC numpy `args`, load the port's `tmod` from the
    same variables and run both -> (JAX's outputs, the port's as NHWC
    numpy, the variables). `layout`: how the port's module takes and
    gives its tensors ('nchw' or 'nhwc')."""
    jargs = [jnp.asarray(a) for a in args]
    variables = _randomize(jmod.init(jax.random.PRNGKey(0), *jargs))
    want = jmod.apply(variables, *jargs)
    tmod.load_state_dict(params_from_jax(_flat(variables)), strict=True)
    tmod.eval()
    conv_in = nchw if layout == "nchw" else (lambda a: torch.from_numpy(a))
    conv_out = nhwc if layout == "nchw" else (lambda t: t.numpy())
    with torch.no_grad():
        got = tmod(*map(conv_in, args))
    unpack = lambda t: [unpack(u) for u in t] if isinstance(t, (tuple, list)) else conv_out(t)
    return want, unpack(got), variables


@pytest.mark.parametrize("bias", [True, False])
def test_channel_layer_norm_matches_jax(bias):
    x = _x(B, 6, 8, 16) * 3 + 1
    want, got, _ = _run(ja.ChannelLayerNorm(16, bias), ta.ChannelLayerNorm(16, bias), [x])
    _close(got, want)


@pytest.mark.parametrize("heads", [1, 2, 4])
def test_mutual_attention_matches_jax(heads):
    """q from the first argument, k and v from the second."""
    x, y = _x(B, 6, 8, 16), _x(B, 6, 8, 16)
    tmod = ta.MutualAttention(16, heads)
    want, got, _ = _run(ja.MutualAttention(16, heads), tmod, [x, y])
    _close(got, want)
    with torch.no_grad():  # the two arguments play different parts
        assert not np.allclose(nhwc(tmod(nchw(y), nchw(x))), got, atol=1e-3)


def test_mlp_matches_jax():
    x = _x(B, 6, 8, 16)
    want, got, _ = _run(ja.Mlp(16, 64), ta.Mlp(16, 64), [x], layout="nhwc")
    _close(got, want)


@pytest.mark.parametrize("expansion", [2, 4])
def test_transformer_block_matches_jax(expansion):
    mask, image = _x(B, 6, 8, 32), _x(B, 6, 8, 32)
    want, got, _ = _run(ja.MaskImageChannelAttentionTransformerBlock(32, 2, expansion),
                        ta.MaskImageChannelAttentionTransformerBlock(32, 2, expansion),
                        [mask, image])
    _close(got, want)


def test_conv_transpose_2x_matches_jax():
    """flax's ConvTranspose with `transpose_kernel=True` holds (kh, kw, O, I)
    and flips it inside the call; the converter's plain transpose to
    torch's (I, O, kh, kw) gives the same outputs, and a flipped kernel
    would not."""
    x = _x(B, 5, 7, 6)
    jmod = jf.ConvTranspose2x(4)
    want, got, variables = _run(jmod, tf.ConvTranspose2x(6, 4), [x])
    assert got.shape == (B, 10, 14, 4)
    _close(got, want)
    flipped = tf.ConvTranspose2x(6, 4)
    sd = params_from_jax(_flat(variables))
    sd["weight"] = sd["weight"].flip(-1, -2)
    flipped.load_state_dict(sd)
    with torch.no_grad():
        assert not np.allclose(nhwc(flipped(nchw(x))), want, atol=1e-3)


def test_sam_matches_jax():
    x, img = _x(B, 8, 12, WF), _x(B, 8, 12, 3)
    want, got, _ = _run(jf.SAM(WF), tf.SAM(WF), [x, img])
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("downsample,heads", [(True, 1), (False, 4), (True, None), (False, None)])
def test_unet_conv_block_matches_jax(downsample, heads):
    x = _x(B, 8, 12, 8)
    args = [x] + ([_x(B, 8, 12, WF)] if heads else [])
    want, got, _ = _run(jf.UNetConvBlock(8, WF, downsample, 0.2, heads),
                        tf.UNetConvBlock(8, WF, downsample, 0.2, heads), args)
    for a, b in zip(got if downsample else (got,), want if downsample else (want,)):
        _close(a, b)


@pytest.mark.parametrize("downsample", [True, False])
def test_unet_mask_conv_block_matches_jax(downsample):
    want, got, _ = _run(jf.UNetMaskConvBlock(8, WF, downsample),
                        tf.UNetMaskConvBlock(8, WF, downsample), [_x(B, 8, 12, 8)])
    for a, b in zip(got if downsample else (got,), want if downsample else (want,)):
        _close(a, b)


def test_unet_up_block_matches_jax():
    want, got, _ = _run(jf.UNetUpBlock(2 * WF, WF), tf.UNetUpBlock(2 * WF, WF),
                        [_x(B, 4, 6, 2 * WF), _x(B, 8, 12, WF)])
    _close(got, want)


def test_fusion_layer_matches_jax():
    """The attention front end, depth 3, heads (1, 2, 4)."""
    x, m = _x(B, 16, 24, 3), _x(B, 16, 24, 3)
    want, got, _ = _run(jf.FusionLayer(3, 3, WF), tf.FusionLayer(3, 3, WF), [x, m],
                        layout="nhwc")
    assert got.shape == (B, 16, 24, WF)
    _close(got, want)


@pytest.mark.parametrize("cin,cout,stride", [(8, 16, 2), (16, 16, 1)])
def test_gn_res_block_matches_jax(cin, cout, stride):
    want, got, _ = _run(jf._GNResBlock(cout, stride), tf._GNResBlock(cin, cout, stride),
                        [_x(B, 8, 12, cin)])
    _close(got, want)


def test_conv_encoder_decoder_and_layer_match_jax():
    x = _x(B, 16, 24, 6)
    want, got, _ = _run(jf.ConvEncoder(128), tf.ConvEncoder(6, 128), [x])
    _close(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        _close(a, b)
    skips = [_x(B, 16, 24, 32), _x(B, 8, 12, 64)]
    jdec = jf.ConvDecoder(WF)
    variables = _randomize(jdec.init(jax.random.PRNGKey(1), jnp.asarray(_x(B, 4, 6, 128)),
                                     [jnp.asarray(s) for s in skips]))
    feats = _x(B, 4, 6, 128)
    want = jdec.apply(variables, jnp.asarray(feats), [jnp.asarray(s) for s in skips])
    tdec = tf.ConvDecoder(128, WF)
    tdec.load_state_dict(params_from_jax(_flat(variables)), strict=True)
    with torch.no_grad():
        _close(nhwc(tdec.eval()(nchw(feats), [nchw(s) for s in skips])), want)
    want, got, _ = _run(jf._DecoderBlock(32), tf._DecoderBlock(64, 32, 32),
                        [_x(B, 8, 12, 64), _x(B, 16, 24, 32)])
    _close(got, want)
    want, got, _ = _run(jf.ConvFusionLayer(WF), tf.ConvFusionLayer(WF),
                        [_x(B, 16, 24, 3), _x(B, 16, 24, 3)], layout="nhwc")
    _close(got, want)


@pytest.mark.parametrize("cin,cout", [(6, 16), (16, 16)])
def test_conv_prompt_layer_matches_jax(cin, cout):
    want, got, _ = _run(jf.ConvPromptLayer(cin, cout), tf.ConvPromptLayer(cin, cout),
                        [_x(B, 8, 12, cin)], layout="nhwc")
    _close(got, want)


@pytest.mark.parametrize("modal", ["point", "neighborE", "neighborG", "context", "frame"])
@pytest.mark.parametrize("tile", [True, False])
def test_init_mask_tile_channels_matches_jax(modal, tile):
    i1, i2 = _x(1, 24, 32, 3, lo=0, hi=255), _x(1, 24, 32, 3, lo=0, hi=255)
    m1 = ((RNG.rand(1, 24, 32, 1) > 0.97) * 255).astype(np.float32)
    kw = dict(mask_modal=modal, mask_channel=3, mask_dilate=5, kernel_size=7,
              kernel_sigma=2.0, tile_channels=tile)
    want = jinit_mask(*(jnp.asarray(a) for a in (i1, i2, m1, m1)), **kw)
    got = init_mask(*(torch.from_numpy(a) for a in (i1, i2, m1, m1)), **kw)
    for a, b in zip(got, want):
        _close(a.numpy(), b, 1e-6)
    if modal in ("point", "neighborE", "neighborG"):
        assert got[0].shape[-1] == (3 if tile else 1)


FRONTS = {"attention": dict(fusion="attention", fusion_channel=WF),
          "conv": dict(fusion="conv", fusion_channel=WF)}


def _drawn(tree):
    """Values for JAX's variable tree (`jax.eval_shape` of `init`: the
    model's own names and shapes, without compiling its init): kernels
    N(0, 1/fan_in), biases N(0, 0.01^2), scales, temperatures and batch
    statistics as `_randomize` draws them."""
    flat = {}
    for k, leaf in traverse_util.flatten_dict(tree, sep="/").items():
        if k.endswith("/kernel"):
            fan_in = int(np.prod(leaf.shape[:-1]))
            flat[k] = RNG.randn(*leaf.shape) / np.sqrt(fan_in)
        elif k.endswith("/bias"):
            flat[k] = RNG.randn(*leaf.shape) * 0.01
        else:
            flat[k] = np.ones(leaf.shape)
        flat[k] = jnp.asarray(flat[k].astype(np.float32))
    return _randomize(traverse_util.unflatten_dict(flat, sep="/"))


@pytest.fixture(scope="module")
def front_models():
    out = {}
    x, m = jnp.zeros((1, H, W, 3)), jnp.zeros((1, H, W, 1))
    for name, kw in FRONTS.items():
        jmodel = JFFRaft(JConfig(corr_impl="xla", iters=ITERS, **kw))
        variables = _drawn(jax.eval_shape(lambda: jmodel.init(
            jax.random.PRNGKey(9), x, x, m, m, iters=1, test_mode=True)))
        tmodel = FFRaft(FFRaftConfig(iters=ITERS, **kw))
        tmodel.load_state_dict(params_from_jax(_flat(variables)), strict=True)
        out[name] = (jmodel, variables, tmodel.eval())
    return out


@pytest.mark.parametrize("name", sorted(FRONTS))
def test_front_end_model_matches_jax(front_models, name):
    """The front end on each frame and its mask, then a plain RAFT with
    `fusion_channel` input channels: test-mode flows within 1e-4 x max(1,
    max |flow|)."""
    jmodel, variables, tmodel = front_models[name]
    i1 = _x(B, H, W, 3, lo=0, hi=255)
    inputs = [i1, np.roll(i1, 3, 2), ((RNG.rand(B, H, W, 1) > 0.97) * 255).astype(np.float32),
              ((RNG.rand(B, H, W, 1) > 0.97) * 255).astype(np.float32)]
    want = jax.jit(lambda v, *a: jmodel.apply(v, *a, iters=ITERS, test_mode=True))(
        variables, *map(jnp.asarray, inputs))
    with torch.no_grad():
        got = tmodel(*map(torch.from_numpy, inputs))
    for ours, theirs in zip(got, want):
        theirs = np.asarray(theirs)
        assert ours.shape == theirs.shape
        assert float(np.abs(ours.numpy() - theirs).max()) <= 1e-4 * max(
            1.0, float(np.abs(theirs).max()))
    assert tmodel.flow_net.fnet.conv1.in_channels == WF
    assert tmodel.flow_net.cnet.conv1.in_channels == WF


@pytest.mark.parametrize("name", sorted(FRONTS))
def test_front_end_round_trip_and_pth(front_models, name, tmp_path):
    _, variables, tmodel = front_models[name]
    flat = _flat(variables)
    exported = params_to_jax(tmodel.state_dict())
    assert set(exported) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(exported[k], flat[k])
    path = tmp_path / "front.pth"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                variables_to_torch_state_dict(variables).items()}, path)
    got = load_torch_pretrained(str(path), FFRaft(tmodel.cfg))
    want = tmodel.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
