"""Plain RAFT's encoders (`nn/encoders.py`) against the JAX package's, in
f32 on the CPU, on flax-initialised weights (seeded; the batch norms'
scales, biases and running statistics moved off their identity start)
and seeded numpy inputs at 64x96:

- `BasicEncoder` with instance norms (the fnet; kernels C1 and C2 on the
  card, their plain versions here), batch norms in eval mode and in train
  mode (the batch's statistics, and the running averages after the
  step), and no norms;
- `ChannelProject` (ABANDON_FNET): the half-pixel resize to H/8 x W/8 and
  the 1x1 conv.

Bounds: 2e-5 of the output's scale (`test_torch_cce.py`'s: ten convs
deep, sums in another order); the running statistics 1e-5 of theirs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from focusflow_official_tpu.nn.encoders import BasicEncoder as JBasicEncoder
from focusflow_official_tpu.nn.encoders import ChannelProject as JChannelProject
from focusflow_official_tpu_torch.compat.weights import params_from_jax
from focusflow_official_tpu_torch.nn.encoders import BasicEncoder, ChannelProject

RNG = np.random.RandomState(83)
B, H, W = 2, 64, 96


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _flat(variables) -> dict:
    return {"/".join(k): np.asarray(v) for k, v in
            traverse_util.flatten_dict(variables).items()}


def _randomize_norms(variables):
    flat = traverse_util.flatten_dict(variables, sep="/")
    for k, v in flat.items():
        leaf = k.rsplit("/", 1)[-1]
        if k.startswith("batch_stats") and leaf == "mean":
            flat[k] = jnp.asarray(RNG.randn(*v.shape).astype(np.float32) * 0.3)
        elif k.startswith("batch_stats") and leaf == "var":
            flat[k] = jnp.asarray(RNG.uniform(0.5, 2.0, v.shape).astype(np.float32))
        elif leaf == "scale":
            flat[k] = jnp.asarray(RNG.uniform(0.5, 1.5, v.shape).astype(np.float32))
    return traverse_util.unflatten_dict(flat, sep="/")


def _close(got: np.ndarray, want, rel: float = 2e-5) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= rel * scale


def _image():
    return RNG.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)


@pytest.mark.parametrize("norm_fn,mode", [("instance", "eval"), ("batch", "eval"),
                                          ("batch", "train"), ("none", "eval")])
def test_basic_encoder_matches_jax(norm_fn, mode):
    x = _image()
    jmod = JBasicEncoder(3, output_dim=256, norm_fn=norm_fn)
    variables = _randomize_norms(jmod.init(jax.random.PRNGKey(4), jnp.asarray(x)))
    tmod = BasicEncoder(3, 256, norm_fn)
    tmod.load_state_dict(params_from_jax(_flat(variables)), strict=True)
    if mode == "train":
        want, new_stats = jmod.apply(variables, jnp.asarray(x), train=True,
                                     mutable=["batch_stats"])
        tmod.train()
    else:
        want = jmod.apply(variables, jnp.asarray(x))
        tmod.eval()
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert got.shape == (B, H // 8, W // 8, 256)
    _close(got.numpy(), want)
    if mode == "train":  # the running averages took the batch's statistics
        stats = params_from_jax(_flat({"batch_stats": new_stats["batch_stats"]}))
        sd = tmod.state_dict()
        assert len(stats) == 2 * 15 and set(stats) < set(sd)
        for name, t in stats.items():
            scale = max(1.0, float(t.abs().max()))
            assert float((sd[name] - t).abs().max()) <= 1e-5 * scale, name


def test_basic_encoder_names_and_norm_kinds():
    """The CCE image branch's names (`conv1`, `norm1`, `layer{1-3}_{0,1}`,
    `conv2`), so its weights and the reference's `fnet.*` keys carry over;
    a stride-2 block's shortcut is normalised by its `norm3`."""
    enc = BasicEncoder(3, 256, "batch")
    names = {n.split(".")[0] for n in enc.state_dict()}
    assert names == {"conv1", "norm1", "conv2", *(f"layer{i}_{j}" for i in (1, 2, 3)
                                                  for j in (0, 1))}
    assert "layer2_0.norm3.running_mean" in enc.state_dict()
    assert not any("norm" in n for n in BasicEncoder(3, 256, "instance").state_dict())


@pytest.mark.parametrize("h,w", [(64, 96), (60, 100)])
def test_channel_project_matches_jax(h, w):
    x = RNG.uniform(-1, 1, (B, h, w, 3)).astype(np.float32)
    jmod = JChannelProject(3, 256)
    variables = jmod.init(jax.random.PRNGKey(5), jnp.asarray(x))
    want = jmod.apply(variables, jnp.asarray(x))
    tmod = ChannelProject(3, 256).eval()
    tmod.load_state_dict(params_from_jax(_flat(variables)), strict=True)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert got.shape == (B, h // 8, w // 8, 256)
    _close(got.numpy(), want, 1e-5)
