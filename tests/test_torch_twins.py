"""The port's Twins-SVT CCE tower against the JAX package's, in f32, on
JAX-initialised weights (biases and LayerNorm affines randomised so that
padded tokens differ from zeros) carried over by `params_from_jax`.

72x104 input: the stage grids are 18x26 and 9x13, so neither the GSA
sub-sampling (sr 8, 4) nor the 7x7 windows divide them. That pins the
flax 'SAME' padding of the strided convs and the zero padding before the
qkv projection.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from focusflow_official_tpu.nn import twins as jtwins
from focusflow_official_tpu_torch.compat.weights import params_from_jax
from focusflow_official_tpu_torch.nn import twins as ttwins


def _randomised(variables, seed):
    """Flat '/'-joined variables with biases ~ N(0, 0.1) and LayerNorm
    scales ~ 1 + N(0, 0.1)."""
    rng = np.random.RandomState(seed)
    flat = {}
    for path, a in traverse_util.flatten_dict(variables).items():
        a = np.asarray(a, np.float32)
        if path[-1] == "bias":
            a = (0.1 * rng.randn(*a.shape)).astype(np.float32)
        elif path[-1] == "scale":
            a = (1 + 0.1 * rng.randn(*a.shape)).astype(np.float32)
        flat["/".join(path)] = a
    return flat


@pytest.fixture(scope="module")
def tower():
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (2, 72, 104, 3)).astype(np.float32)
    mask = rng.uniform(-1, 1, (2, 72, 104, 3)).astype(np.float32)
    model = jtwins.TwinsSVT2StageCCE()
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))
    flat = _randomised(variables, 1)
    want = np.asarray(model.apply(
        traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(a)
                                      for k, a in flat.items()}),
        jnp.asarray(x), jnp.asarray(mask)))
    return x, mask, flat, want


def test_params_load_strict(tower):
    _, _, flat, _ = tower
    ported = ttwins.TwinsSVT2StageCCE()
    ported.load_state_dict(params_from_jax(flat), strict=True)
    qkv = ported.blocks_0_0.attn.qkv.weight
    np.testing.assert_array_equal(
        qkv.detach().numpy(),
        flat["params/blocks_0_0/attn/qkv/kernel"].T)
    dw = ported.pos_block_1.proj_0.weight
    assert tuple(dw.shape) == (256, 1, 3, 3)


def test_tower_matches_jax(tower):
    x, mask, flat, want = tower
    ported = ttwins.TwinsSVT2StageCCE().eval()
    ported.load_state_dict(params_from_jax(flat), strict=True)
    with torch.inference_mode():
        got = ported(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (2, 9, 13, 256)
    # f32 through 8 blocks, sums in other orders (measured ~1e-6 of the
    # features' scale): 1e-5 of it
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 1e-5 * scale


@pytest.mark.parametrize("size,sr", [(110, 8), (55, 4), (56, 4), (18, 8)])
def test_strided_conv_pads_as_flax_same(size, sr):
    """The GSA `sr` conv at the bench grids (110 rows at sr 8 and 55 at
    sr 4 both give 14 rows of keys) against flax's 'SAME' conv."""
    import flax.linen as fnn

    rng = np.random.RandomState(size)
    x = rng.randn(1, size, 3 * sr - 1, 4).astype(np.float32)
    conv = fnn.Conv(5, (sr, sr), strides=(sr, sr), precision=jax.lax.Precision.HIGHEST)
    v = conv.init(jax.random.PRNGKey(size), jnp.asarray(x))
    want = np.asarray(conv.apply(v, jnp.asarray(x)))
    ported = torch.nn.Conv2d(4, 5, sr, sr)
    sd = params_from_jax({"params/" + "/".join(k): np.asarray(a) for k, a in
                          traverse_util.flatten_dict(v["params"]).items()})
    ported.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        got = ttwins.conv_nhwc(ported, torch.from_numpy(x), same=True).numpy()
    assert got.shape == want.shape == (1, -(-size // sr), 3, 5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
