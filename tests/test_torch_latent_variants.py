"""The cost perceiver's variant layers and the position encodings in the
port against the JAX package's, in f32 on the CPU, on JAX-initialised
weights carried over by `params_from_jax` (biases and LayerNorm affines
randomised; ConvNext's `gamma`, 1e-6 at its initialisation, drawn at
0.5 x N(0, 1), so each block moves its output; the learned encodings'
tables as flax draws them, U[0, 1)):

- `CostPatchEmbed` at patch size 4 (two 6x6 stride-2 convs);
- `MLPMixerLayer` over K = 8 tokens;
- `ConvNextBlock` and `ConvNextLayer` (four blocks);
- `GroupAttnRPEContext` with the context (vert_c_dim 16) and without it
  (vert_c_dim 0), on a 11x13 grid that pads to two 7x7 windows an axis,
  so every one of the five shifts moves keys across windows;
- `GroupVerticalSelfAttentionLayer`, with and without the context;
- `PositionEncodingSine`, `LinearPositionEncoding`, `LearnedPositionEncoding`.

Each within 1e-5 of its output's scale (f32 sums and softmax in other
orders), and each layer with weights moves its input by more than that
bound, so the comparison is not of two identities.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from focusflow_official_tpu.nn import latent_cost as jlc
from focusflow_official_tpu.nn import position_encoding as jpe
from focusflow_official_tpu_torch.compat.weights import params_from_jax
from focusflow_official_tpu_torch.nn import latent_cost as tlc
from focusflow_official_tpu_torch.nn import position_encoding as tpe

REL = 1e-5  # f32, sums and softmax in other orders: of the output's scale
H, W = 11, 13  # pads to 14x14: two 7x7 windows an axis


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


class _Sized:
    """Bind the static grid size of a JAX module taking (x, size, context)."""

    def __init__(self, module, size=(H, W)):
        self.module, self.size = module, size

    def init(self, key, *args):
        return self.module.init(key, args[0], self.size, *args[1:])

    def apply(self, v, *args):
        return self.module.apply(v, args[0], self.size, *args[1:])


class _TorchSized(torch.nn.Module):
    def __init__(self, module, size=(H, W)):
        super().__init__()
        self.module, self.size = module, size

    def load_state_dict(self, sd, strict=True):
        return self.module.load_state_dict(sd, strict=strict)

    def forward(self, x, *args):
        return self.module(x, self.size, *args)


def _run_both(jmodule, tmodule, args, seed=0):
    """Init `jmodule` on `args`, randomise biases, LayerNorm scales and
    `gamma`, load the same weights into `tmodule` (strict), run both."""
    rng = np.random.RandomState(seed)
    variables = jmodule.init(jax.random.PRNGKey(seed), *map(jnp.asarray, args))
    flat = {}
    for path, a in traverse_util.flatten_dict(variables).items():
        a = np.asarray(a, np.float32)
        if path[-1] == "bias":
            a = 0.1 * rng.randn(*a.shape)
        elif path[-1] == "scale":
            a = 1 + 0.1 * rng.randn(*a.shape)
        elif path[-1] == "gamma":
            a = 0.5 * rng.randn(*a.shape)
        flat["/".join(path)] = np.asarray(a, np.float32)
    want = jmodule.apply(_tree(flat), *map(jnp.asarray, args))
    tmodule.load_state_dict(params_from_jax(flat), strict=True)
    tmodule.eval()
    with torch.inference_mode():
        got = tmodule(*map(torch.from_numpy, args))
    return got, want


def _tree(flat):
    return traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(a)
                                         for k, a in flat.items()})


def _close(got, want, moved_from=None):
    """Within REL of the output's scale; with `moved_from`, the output also
    differs from that tensor by more than the bound."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    bound = REL * max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got - want).max()) <= bound, (float(np.abs(got - want).max()), bound)
    if moved_from is not None:
        assert float(np.abs(want - moved_from).max()) > 100 * bound


def test_cost_patch_embed_patch4_matches_jax():
    # 30 cost maps of 13x21: padded to 16x24, two stride-2 convs -> 4x6
    x = _rand(1, 30, 13, 21, 1, scale=3.0)
    (got, gsize), (want, wsize) = _run_both(
        jlc.CostPatchEmbed(4, 1, 64), tlc.CostPatchEmbed(1, 64, patch_size=4), (x,))
    assert tuple(gsize) == tuple(wsize) == (4, 6)
    assert not hasattr(tlc.CostPatchEmbed(1, 64, patch_size=4), "proj_4")
    _close(got, want)


def test_mlp_mixer_matches_jax():
    x = _rand(2, 10, 8, 128)
    got, want = _run_both(jlc.MLPMixerLayer(128, 8), tlc.MLPMixerLayer(128, 8), (x,))
    _close(got, want, moved_from=x)


@pytest.mark.parametrize("layer", ["block", "layer"])
def test_convnext_matches_jax(layer):
    x = _rand(3, 4, H, W, 32)
    if layer == "block":
        jmod, tmod = jlc.ConvNextBlock(32), tlc.ConvNextBlock(32)
    else:
        jmod, tmod = jlc.ConvNextLayer(32), tlc.ConvNextLayer(32)
    got, want = _run_both(jmod, tmod, (x,))
    _close(got, want, moved_from=x)


@pytest.mark.parametrize("vert_c_dim", [0, 16])
def test_group_attention_matches_jax(vert_c_dim, monkeypatch):
    b, dim, cdim = 10, 32, 24
    x = _rand(4, b, H * W, dim)
    # the context at batch 2 is tiled to the 10 tokens' batch, as both tile it
    args = (x,) if vert_c_dim == 0 else (x, _rand(5, 2, H, W, cdim))
    tmod = _TorchSized(tlc.GroupAttnRPEContext(dim, 2, 7, vert_c_dim, context_dim=cdim))
    got, want = _run_both(_Sized(jlc.GroupAttnRPEContext(dim, 2, 7, vert_c_dim)), tmod, args)
    _close(got, want)
    # the shifts matter: without them the first four groups' outputs move
    # by far more than the bound, the fifth (in place) not at all
    monkeypatch.setattr(tlc, "_shift_groups", lambda t, ws: t)
    with torch.inference_mode():
        unshifted = tmod(*map(torch.from_numpy, args)).numpy()
    moved = np.abs(unshifted - np.asarray(got)).reshape(5, -1).max(axis=1)
    assert (moved[:4] > 100 * REL * float(np.abs(want).max())).all() and moved[4] == 0.0


@pytest.mark.parametrize("vert_c_dim", [0, 16])
def test_group_vertical_layer_matches_jax(vert_c_dim):
    b, dim, cdim = 5, 32, 24
    x = _rand(6, b, H * W, dim)
    args = (x,) if vert_c_dim == 0 else (x, _rand(7, b, H, W, cdim))
    got, want = _run_both(
        _Sized(jlc.GroupVerticalSelfAttentionLayer(dim, vert_c_dim, num_heads=2)),
        _TorchSized(tlc.GroupVerticalSelfAttentionLayer(dim, vert_c_dim, num_heads=2,
                                                        context_dim=cdim)), args)
    _close(got, want, moved_from=x)


def test_group_attention_needs_five_groups():
    mod = tlc.GroupAttnRPEContext(32, 2)
    with pytest.raises(ValueError, match="multiple of 5"):
        mod(torch.zeros(4, H * W, 32), (H, W))


@pytest.mark.parametrize("name", ["sine", "linear", "learned"])
def test_position_encodings_match_jax(name):
    x = _rand(8, 2, H, W, 64)
    jmod, tmod = {"sine": (jpe.PositionEncodingSine(64), tpe.PositionEncodingSine(64)),
                  "linear": (jpe.LinearPositionEncoding(64), tpe.LinearPositionEncoding()),
                  "learned": (jpe.LearnedPositionEncoding(64, 20),
                              tpe.LearnedPositionEncoding(64, 20))}[name]
    got, want = _run_both(jmod, tmod, (x,))
    _close(got, want, moved_from=x)
