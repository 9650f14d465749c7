"""The port's cost-perceiver layers against the JAX package's, in f32, on
JAX-initialised weights (biases and LayerNorm affines randomised) carried
over by `params_from_jax`.

The vertical layer runs on an 11x13 grid: the global block pads it to
12x16 (sr 4) and the local block to 14x14 (7x7 windows), as the bench's
55x128 grid needs both paddings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from focusflow_official_tpu.nn import latent_cost as jlc
from focusflow_official_tpu_torch.compat.weights import params_from_jax
from focusflow_official_tpu_torch.nn import latent_cost as tlc

# f32, sums and softmax in other orders: 1e-5 of the output's scale
REL = 1e-5


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


def _run_both(jmodule, tmodule, args, seed=0):
    """Init `jmodule` on `args`, randomise biases and LayerNorm scales, load
    the same weights into `tmodule` (strict) and run both."""
    rng = np.random.RandomState(seed)
    variables = jmodule.init(jax.random.PRNGKey(seed), *map(
        lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a, args))
    flat = {}
    for path, a in traverse_util.flatten_dict(variables).items():
        a = np.asarray(a, np.float32)
        if path[-1] == "bias":
            a = (0.1 * rng.randn(*a.shape)).astype(np.float32)
        elif path[-1] == "scale":
            a = (1 + 0.1 * rng.randn(*a.shape)).astype(np.float32)
        flat["/".join(path)] = a
    v = traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(a)
                                      for k, a in flat.items()})
    want = jmodule.apply(v, *map(
        lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a, args))
    tmodule.load_state_dict(params_from_jax(flat), strict=True)
    tmodule.eval()
    with torch.inference_mode():
        got = tmodule(*map(lambda a: torch.from_numpy(a)
                           if isinstance(a, np.ndarray) else a, args))
    return got, want


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got - want).max()) <= REL * scale, (
        float(np.abs(got - want).max()), scale)


def test_position_embedding_matches_jax():
    x = np.random.RandomState(3).uniform(0, 500, (2, 7, 2)).astype(np.float32)
    got = tlc.linear_position_embedding_sine(torch.from_numpy(x), 64).numpy()
    want = np.asarray(jlc.linear_position_embedding_sine(jnp.asarray(x), 64))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_cost_patch_embed_matches_jax():
    # 30 cost maps of 13x21: padded to 16x24, three stride-2 convs -> 2x3
    x = _rand(1, 30, 13, 21, 1, scale=3.0)
    (got, gsize), (want, wsize) = _run_both(
        jlc.CostPatchEmbed(8, 1, 64), tlc.CostPatchEmbed(1, 64), (x,))
    assert tuple(gsize) == tuple(wsize) == (2, 3)
    _close(got, want)


def test_broad_cross_attention_matches_jax():
    query = _rand(2, 1, 8, 128)
    tgt = _rand(3, 6, 40, 96)
    got, want = _run_both(jlc.BroadCrossAttentionLayer(128, 128, 128, 96),
                          tlc.BroadCrossAttentionLayer(128, 128, 128, 96),
                          (query, tgt))
    _close(got, want)


def test_self_attention_matches_jax():
    x = _rand(4, 10, 8, 128)
    got, want = _run_both(jlc.SelfAttentionLayer(128),
                          tlc.SelfAttentionLayer(128), (x,))
    _close(got, want)


@pytest.mark.parametrize("vert_c_dim", [16, 64])
def test_vertical_layer_with_context_matches_jax(vert_c_dim):
    h, w, dim, cdim = 11, 13, 64, 48
    x = _rand(5, 4, h * w, dim)
    context = _rand(6, 4, h, w, cdim)

    jmod = jlc.VerticalSelfAttentionLayer(dim, vert_c_dim)
    tmod = tlc.VerticalSelfAttentionLayer(dim, vert_c_dim, context_dim=cdim)
    got, want = _run_both(
        _SizeBound(jmod, (h, w)), _TorchSizeBound(tmod, (h, w)), (x, context))
    _close(got, want)


class _SizeBound:
    """Bind the static grid size so `_run_both` passes arrays only."""

    def __init__(self, module, size):
        self.module, self.size = module, size

    def init(self, key, x, context):
        return self.module.init(key, x, self.size, context)

    def apply(self, v, x, context):
        return self.module.apply(v, x, self.size, context)


class _TorchSizeBound(torch.nn.Module):
    def __init__(self, module, size):
        super().__init__()
        self.module, self.size = module, size

    def load_state_dict(self, sd, strict=True):
        return self.module.load_state_dict(sd, strict=strict)

    def forward(self, x, context):
        return self.module(x, self.size, context)
