"""Kernel C2's residual form and the ResidualBlock that launches it.

C2 takes the block's shortcut add and final ReLU into its launch: out =
relu(r + relu((x - mean) * inv)), rounded in x's type where PyTorch's three
elementwise ops round. Its plain version (`apply_plain` with `residual`) is
held here to that composition bit for bit, and the port's `ResidualBlock`,
whose `norm2` now takes the shortcut, to the JAX `ResidualBlock` on the same
weights and inputs (f32, CPU; the card tests hold the kernel to the plain
version and the fnet to the unfused composition).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from focusflow_official_tpu.nn.blocks import ResidualBlock as JBlock
from focusflow_official_tpu_torch.compat.weights import params_from_jax
from focusflow_official_tpu_torch.kernels import instance_norm as kin
from focusflow_official_tpu_torch.nn.blocks import ResidualBlock as TBlock
from focusflow_official_tpu_torch.nn.norm import Norm


def _operands(seed, shape, dtype):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(*shape) * 3 + 1).astype(np.float32)).to(dtype)
    r = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)
    return x, r


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("relu", [True, False])
def test_residual_form_is_the_composition(dtype, relu):
    """The residual form equals torch.relu(r + plain form), rtol 0 atol 0."""
    x, r = _operands(0, (2, 9, 13, 24), dtype)
    mean, inv = kin.stats_plain(x)
    got = kin.apply_plain(x, mean, inv, relu, r)
    want = torch.relu(r + kin.apply_plain(x, mean, inv, relu))
    assert got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # the wrapper takes the plain version for CPU tensors
    torch.testing.assert_close(kin.instance_norm_apply(x, mean, inv, relu, r), want,
                               rtol=0, atol=0)
    torch.testing.assert_close(kin.instance_norm(x, 1e-5, relu, r),
                               torch.relu(r + kin.instance_norm(x, 1e-5, relu)),
                               rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["instance", "batch", "group", "none"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_norm_residual_is_relu_of_the_sum(kind, dtype):
    """`Norm.forward(x, relu, residual)` is torch.relu(residual + norm(x,
    relu)) bit for bit, for every kind, on NCHW-indexed tensors (the
    shortcut's NHWC view is not contiguous here: the CPU takes any
    strides)."""
    x, r = _operands(1, (2, 16, 7, 11), dtype)
    norm = Norm(kind, 16, 2)
    if kind in ("batch", "group"):
        with torch.no_grad():
            norm.weight.uniform_(0.5, 1.5)
            norm.bias.uniform_(-0.5, 0.5)
    if kind == "batch":
        norm.running_mean.uniform_(-0.3, 0.3)
        norm.running_var.uniform_(0.5, 2.0)
    with torch.inference_mode():
        got = norm(x, relu=True, residual=r)
        want = torch.relu(r + norm(x, relu=True))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _randomize_batch_stats(variables, rng):
    flat = traverse_util.flatten_dict(variables, sep="/")
    for k, v in flat.items():
        leaf = k.rsplit("/", 1)[-1]
        if k.startswith("batch_stats") and leaf == "mean":
            flat[k] = jnp.asarray(rng.randn(*v.shape).astype(np.float32) * 0.3)
        elif k.startswith("batch_stats") and leaf == "var":
            flat[k] = jnp.asarray(rng.uniform(0.5, 2.0, v.shape).astype(np.float32))
        elif leaf == "scale" or (leaf == "bias" and "norm" in k):
            lo, hi = (0.5, 1.5) if leaf == "scale" else (-0.5, 0.5)
            flat[k] = jnp.asarray(rng.uniform(lo, hi, v.shape).astype(np.float32))
    return traverse_util.unflatten_dict(flat, sep="/")


@pytest.mark.parametrize("norm_fn", ["instance", "batch", "group"])
@pytest.mark.parametrize("cin,cout,stride", [(32, 32, 1), (32, 48, 2)])
def test_residual_block_matches_jax(norm_fn, cin, cout, stride):
    """The port's ResidualBlock (the shortcut add and ReLU in `norm2`)
    against the JAX ResidualBlock (`nn.relu(x + y)` after norm2) in f32.
    Two 3x3 convs and two or three norms, sums in another order: 1e-5 of
    the output's scale."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 20, 28, cin).astype(np.float32)
    jmod = JBlock(cin, cout, norm_fn, stride)
    variables = jmod.init(jax.random.PRNGKey(5), jnp.asarray(x))
    variables = _randomize_batch_stats(variables, rng)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))

    tmod = TBlock(cin, cout, norm_fn, stride).eval()
    flat = {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(variables, sep="/").items()}
    tmod.load_state_dict(params_from_jax(flat), strict=True)
    with torch.inference_mode():
        got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()

    assert got.shape == want.shape == (2, 20 // stride, 28 // stride, cout)
    assert float(want.min()) >= 0.0 and float(got.min()) >= 0.0  # the final ReLU
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
