"""The port's CCE fusion units (`nn/fusion_units.py`) against the JAX
package's, in f32 on the CPU, on flax-initialised weights (seeded) and
seeded numpy inputs: each of Concat, SA and CA alone, `FusionUnit` both
ways and '1x1conv-unidirection', the CCE layer with each type (its
mask-to-image-only `fusion5` included), and the PWC extractor with CA.

The port runs NCHW (SA's statistics over dim 1, CA's over dims 2 and 3),
JAX NHWC. Bounds: a unit is a few f32 convs, 1e-5 of the output's scale;
the extractor the bound of `test_torch_pwc.py` (1e-5 of the scale). The
CCE layer, 20 convs and 11 instance norms deep with a 3x3 pair in every
SA and CA unit, within 5e-5 of the scale: on these inputs JAX's own f32
output is up to 1.9e-5 of the scale from the same weights run in f64
(SA 2.3e-5 of it from the port's f32 output, CA 2.2e-5), and the port's
within 5e-6. The
units in bf16 (the card's serving type, where CA's global max and SA's
channel max are taken on bf16 values) are held to JAX's f32 result within
2^-5 of its scale: inputs, weights and each conv's output rounded to 8
bits of mantissa, three convs and a sigmoid deep.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from focusflow_official_tpu.nn import fusion_units as jfu
from focusflow_official_tpu.nn import pwc as jpwc
from focusflow_official_tpu.nn.cce import BasicParallelFusionLayer as JCCE
from focusflow_official_tpu_torch.compat.weights import params_from_jax
from focusflow_official_tpu_torch.nn import fusion_units as tfu
from focusflow_official_tpu_torch.nn import pwc as tpwc
from focusflow_official_tpu_torch.nn.cce import BasicParallelFusionLayer as TCCE

RNG = np.random.RandomState(71)
OPS = ("concat", "SA", "CA")
C = 64


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def reference_layout(monkeypatch):
    for knob in ("FF_CHUNKED_FNET", "FF_PACKED_CCE", "FF_PACKED_CCE_BN",
                 "FF_PACKED_STEM"):
        monkeypatch.setenv(knob, "0")


def _flat(variables) -> dict:
    return {"/".join(k): np.asarray(v) for k, v in
            traverse_util.flatten_dict(variables).items()}


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).float().numpy()


def _qv(h=12, w=20):
    q = RNG.randn(2, h, w, C).astype(np.float32)
    v = RNG.randn(2, h, w, C).astype(np.float32)
    return q, v


def _jax_op(ftype):
    return {"concat": jfu.Concat, "SA": jfu.SA, "CA": jfu.CA}[ftype](C)


def _close(got: np.ndarray, want, rel: float) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= rel * scale


@pytest.mark.parametrize("ftype", OPS)
def test_unit_matches_jax(ftype):
    q, v = _qv()
    jmod = _jax_op(ftype)
    variables = jmod.init(jax.random.PRNGKey(5), jnp.asarray(q), jnp.asarray(v))
    want = jmod.apply(variables, jnp.asarray(q), jnp.asarray(v))
    tmod = {"concat": tfu.Concat, "SA": tfu.SA, "CA": tfu.CA}[ftype](C).eval()
    tmod.load_state_dict(params_from_jax(_flat(variables)), strict=True)
    with torch.inference_mode():
        got = tmod(_nchw(q), _nchw(v))
    _close(_nhwc(got), want, 1e-5)
    # SA's convs carry no bias; CA's gate is two sigmoids at reduction 16
    names = set(tmod.state_dict())
    if ftype == "SA":
        assert names == {"conv_q.weight", "conv_v_0.weight", "s_map_0.weight"}
    if ftype == "CA":
        assert tuple(tmod.c_map_0.weight.shape) == (C // 16, C, 1, 1)
        assert tuple(tmod.conv_q.weight.shape) == (C, 2 * C, 3, 3)


@pytest.mark.parametrize("ftype", OPS)
def test_unit_bf16_against_jax_f32(ftype):
    q, v = _qv()
    jmod = _jax_op(ftype)
    variables = jmod.init(jax.random.PRNGKey(6), jnp.asarray(q), jnp.asarray(v))
    want = jmod.apply(variables, jnp.asarray(q), jnp.asarray(v))
    tmod = {"concat": tfu.Concat, "SA": tfu.SA, "CA": tfu.CA}[ftype](C).eval()
    tmod.load_state_dict(params_from_jax(_flat(variables)), strict=True)
    tmod.to(torch.bfloat16)
    with torch.inference_mode():
        got = tmod(_nchw(q).to(torch.bfloat16), _nchw(v).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(_nhwc(got), want, 2 ** -5)


@pytest.mark.parametrize("ftype,bi", [(t, bi) for t in OPS for bi in (True, False)]
                         + [("1x1conv-unidirection", True)])
def test_fusion_unit_matches_jax(ftype, bi):
    mask, img = _qv(8, 12)
    jmod = jfu.FusionUnit(C, ftype, bi)
    variables = jmod.init(jax.random.PRNGKey(7), jnp.asarray(mask), jnp.asarray(img))
    want_mask, want_img = jmod.apply(variables, jnp.asarray(mask), jnp.asarray(img))
    tmod = tfu.FusionUnit(C, ftype, bi).eval()
    tmod.load_state_dict(params_from_jax(_flat(variables)), strict=True)
    with torch.inference_mode():
        got_mask, got_img = tmod(_nchw(mask), _nchw(img))
    _close(_nhwc(got_img), want_img, 1e-5)
    _close(_nhwc(got_mask), want_mask, 1e-5)
    one_way = not bi or ftype == "1x1conv-unidirection"
    assert (tmod.img2mask is None) == one_way
    if one_way:  # the mask passes through untouched
        assert torch.equal(got_mask, _nchw(mask))


def test_unknown_fusion_type_raises():
    with pytest.raises(ValueError, match="not supported"):
        tfu.FusionUnit(C, "attention")


@pytest.mark.parametrize("ftype", OPS)
def test_cce_layer_with_each_type(reference_layout, ftype):
    """Both directions at fusion1-4 and `fusion5` mask-to-image only (for
    concat: img_out = conv([img, mask]), no residual), instance norms."""
    b, h, w = 2, 64, 96
    x = RNG.uniform(-1, 1, (b, h, w, 3)).astype(np.float32)
    m1 = np.where(RNG.rand(b, h, w, 1) > 0.97, 1.0, -1.0).astype(np.float32)
    jmod = JCCE(img_channel=3, mask_channel=3, output_dim=256, norm_fn="instance",
                fusion_type=ftype)
    variables = jmod.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(m1))
    want = jmod.apply(variables, jnp.asarray(x), jnp.asarray(m1))
    tmod = TCCE(3, 3, 256, "instance", ftype).eval()
    tmod.load_state_dict(params_from_jax(_flat(variables)), strict=True)
    assert tmod.fusion5.img2mask is None and tmod.fusion4.img2mask is not None
    with torch.inference_mode():
        got = tmod(torch.from_numpy(x), torch.from_numpy(np.repeat(m1, 3, axis=-1)))
    assert got.shape == (b, h // 8, w // 8, 256)
    _close(got.numpy(), want, 5e-5)


def test_pwc_extractor_with_ca():
    """FF-PWCNet's extractor: CA at fusion1-5 both ways, fusion6 one way
    (the `i < 5` rule)."""
    x = RNG.rand(1, 64, 128, 3).astype(np.float32) * 255
    m = RNG.rand(1, 64, 128, 3).astype(np.float32) * 255
    jmod = jpwc.PWCFusionExtractor(fusion_type="CA")
    variables = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(m))
    want = jmod.apply(variables, jnp.asarray(x), jnp.asarray(m))
    tmod = tpwc.PWCFusionExtractor("CA").eval()
    tmod.load_state_dict(params_from_jax(_flat(variables)), strict=True)
    assert tmod.fusion6.img2mask is None and tmod.fusion5.img2mask is not None
    with torch.inference_mode():
        got = tmod(torch.from_numpy(x), torch.from_numpy(m))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        _close(g.numpy(), w, 1e-5)
