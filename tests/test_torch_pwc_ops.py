"""The port's PWC-Net ops against the JAX package on the same numpy inputs:
the half-pixel resize, bilinear sampling at pixel coordinates, the backward
warp with its ones-channel mask, and one transposed-conv layer through the
weight converter. All f32; tolerances are absolute on values of size ~1."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from focusflow_official_tpu.nn.blocks import conv_transpose2d as jconv_transpose2d
from focusflow_official_tpu.ops.coords import resize_bilinear as jresize
from focusflow_official_tpu.ops.sampler import bilinear_sample as jsample
from focusflow_official_tpu.ops.warp import backwarp as jbackwarp
from focusflow_official_tpu_torch.compat.weights import params_from_jax
from focusflow_official_tpu_torch.ops.coords import resize_bilinear
from focusflow_official_tpu_torch.ops.sampler import bilinear_sample
from focusflow_official_tpu_torch.ops.warp import backwarp

RNG = np.random.RandomState(41)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("hw,new_hw", [
    ((436, 64), (448, 64)),  # the bench frame's rows up to the /64 size
    ((112, 40), (109, 40)),  # 448 -> 436 scaled down by 4: shrinking, no antialias
    ((20, 30), (64, 64)),    # both axes, a large factor
    ((64, 64), (20, 30)),
])
def test_resize_bilinear_matches_jax(hw, new_hw):
    x = RNG.randn(2, *hw, 3).astype(np.float32)
    want = np.asarray(jresize(jnp.asarray(x), new_hw))
    got = resize_bilinear(_t(x), new_hw).numpy()
    assert got.shape == want.shape == (2, *new_hw, 3)
    # the same two-tap blends with f32 source positions
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _border_coords(h, w):
    """Coordinates inside, exactly on and beyond every border, and on
    integer positions (zero fractional part)."""
    xs = np.array([-2.5, -1.0, -0.25, 0.0, 0.5, 3.0, w - 1.5, w - 1.0,
                   w - 0.75, w, w + 1.5], np.float32)
    ys = np.array([-3.0, -0.5, 0.0, 1.25, h - 2.0, h - 1.0, h - 0.5, h + 2.0],
                  np.float32)
    gx, gy = np.meshgrid(xs, ys)
    return np.stack([gx, gy], -1)[None]  # (1, 8, 11, 2)


def test_bilinear_sample_matches_jax():
    h, w = 9, 13
    img = RNG.randn(2, h, w, 5).astype(np.float32)
    coords = np.concatenate([
        _border_coords(h, w),
        np.stack([RNG.uniform(-3, w + 2, (1, 8, 11)),
                  RNG.uniform(-3, h + 2, (1, 8, 11))], -1).astype(np.float32)])
    want = np.asarray(jsample(jnp.asarray(img), jnp.asarray(coords)))
    got = bilinear_sample(_t(img), _t(coords)).numpy()
    assert got.shape == want.shape == (2, 8, 11, 5)
    # the same four gathers and f32 weights
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # a tap beyond the border is zero: the far corner sample is all padding
    assert np.all(got[0, -1, -1] == 0.0)


def test_backwarp_matches_jax():
    """Flows that leave the frame on every side; the ones-channel threshold
    zeroes every pixel whose sample touches the outside."""
    h, w = 12, 18
    img = RNG.randn(2, h, w, 4).astype(np.float32)
    flow = (RNG.randn(2, h, w, 2) * 4).astype(np.float32)
    flow[0, :, :3, 0] = -5.0   # off the left edge
    flow[0, :, -3:, 0] = 6.5   # off the right edge
    flow[1, :2, :, 1] = -4.25  # off the top
    flow[1, -2:, :, 1] = 3.0   # off the bottom
    flow[0, 5, 5] = 0.0        # an exact pixel
    want = np.asarray(jbackwarp(jnp.asarray(img), jnp.asarray(flow)))
    got = backwarp(_t(img), _t(flow)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.all(got[0, :, :3] == 0.0) and np.all(got[1, -2:] == 0.0)
    np.testing.assert_allclose(got[0, 5, 5], img[0, 5, 5], atol=1e-6)
    # the reference's quirk: the shift is u * W / (W - 1), not u
    flow1 = np.zeros((1, h, w, 2), np.float32)
    flow1[..., 0] = w - 1.0  # x = 0 would land on the last pixel without it
    out = backwarp(torch.ones((1, h, w, 1)), _t(flow1)).numpy()
    assert np.all(out == 0.0)  # x + W >= W for every x: outside


@pytest.mark.parametrize("cin,cout", [(2, 2), (7, 2)])
def test_conv_transpose_layer_matches_flax(cin, cout):
    """flax stores this kernel (kh, kw, O, I) (`transpose_kernel=True`); the
    converter's 4-D permutation gives torch's (I, O, kh, kw) with no flip,
    and padding ((2, 2), (2, 2)) equals ConvTranspose2d(k=4, s=2, p=1)."""
    layer = jconv_transpose2d(cout, name="up")
    x = RNG.randn(2, 5, 6, cin).astype(np.float32)
    variables = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    flat = {"/".join(k): np.asarray(v) for k, v in
            traverse_util.flatten_dict(variables).items()}
    kernel = RNG.randn(*flat["params/kernel"].shape).astype(np.float32)
    bias = RNG.randn(cout).astype(np.float32)
    assert kernel.shape == (4, 4, cout, cin)
    want = np.asarray(layer.apply(
        {"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}},
        jnp.asarray(x)))
    sd = params_from_jax({"params/kernel": kernel, "params/bias": bias})
    conv = torch.nn.ConvTranspose2d(cin, cout, 4, 2, 1)
    conv.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        got = conv(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 10, 12, cout)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
