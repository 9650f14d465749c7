"""The plain PyTorch version of the port's local correlation (kernel D)
against the JAX package: the XLA shift formulation and the Pallas kernel in
interpret mode, on the same numpy inputs in f32.

The plain version is what CPU tensors take and what the CUDA kernel is held
against on the card, so this pins the kernel's arithmetic here."""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from focusflow_official_tpu.ops.local_corr import local_corr as jlocal_corr
from focusflow_official_tpu.ops.pallas_local_corr import _forward as jpallas_forward
from focusflow_official_tpu_torch.kernels import local_corr as klc
from focusflow_official_tpu_torch.ops.local_corr import local_corr

RNG = np.random.RandomState(43)

SHAPES = [
    ((2, 12, 16, 32), 4),
    ((1, 9, 13, 24), 3),    # odd sizes, radius 3
    ((1, 7, 16, 196), 4),   # PWC level 6 at the bench size: lower than the window
]


def _maps(shape):
    return (RNG.randn(*shape).astype(np.float32),
            RNG.randn(*shape).astype(np.float32))


@pytest.mark.parametrize("shape,r", SHAPES)
def test_local_corr_matches_xla(shape, r):
    f1, f2 = _maps(shape)
    want = np.asarray(jlocal_corr(jnp.asarray(f1), jnp.asarray(f2), r))
    got = local_corr(torch.from_numpy(f1), torch.from_numpy(f2), r).numpy()
    assert got.shape == want.shape == shape[:3] + ((2 * r + 1) ** 2,)
    # f32 sums of C products of size ~1, in another order, over C
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,r", SHAPES)
def test_local_corr_matches_pallas_kernel(shape, r):
    f1, f2 = _maps(shape)
    want = np.asarray(jpallas_forward(jnp.asarray(f1), jnp.asarray(f2), r,
                                      interpret=True))
    got = local_corr(torch.from_numpy(f1), torch.from_numpy(f2), r).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("shape,r", SHAPES)
def test_local_corr_leaky_relu_matches_jax(shape, r, impl):
    """The fused form against the JAX decoder's lrelu(local_corr(.)) (JAX
    `nn/pwc.py`), through the XLA shifts or the Pallas kernel in interpret
    mode, in f32."""
    f1, f2 = _maps(shape)
    a, b = jnp.asarray(f1), jnp.asarray(f2)
    corr = (jlocal_corr(a, b, r) if impl == "xla"
            else jpallas_forward(a, b, r, interpret=True))
    want = np.asarray(jax.nn.leaky_relu(corr, 0.1))
    got = local_corr(torch.from_numpy(f1), torch.from_numpy(f2), r,
                     negative_slope=0.1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,r", SHAPES)
def test_local_corr_leaky_relu_is_plain_then_leaky_relu(shape, r, dtype):
    """The fused form is the plain form rounded to its type, then PyTorch's
    leaky ReLU: bit-equal, as the kernel's epilogue is held on the card."""
    f1, f2 = _maps(shape)
    a, b = torch.from_numpy(f1).to(dtype), torch.from_numpy(f2).to(dtype)
    got = klc.local_corr(a, b, r, negative_slope=0.1)
    want = F.leaky_relu(klc.local_corr_plain(a, b, r), 0.1)
    assert got.dtype == dtype and torch.equal(got, want)
    assert bool((got < 0).any()) and torch.equal(
        got[got < 0], (klc.local_corr_plain(a, b, r)[got < 0].float() * 0.1).to(dtype))


def test_local_corr_channel_order_and_padding():
    """Channel (dy+r)(2r+1) + (dx+r) pairs f1[y, x] with f2[y+dy, x+dx]; a
    displacement that leaves f2 reads zero."""
    f1 = np.zeros((1, 6, 7, 3), np.float32)
    f2 = np.zeros((1, 6, 7, 3), np.float32)
    f1[0, 2, 3] = (1.0, 2.0, 3.0)
    f2[0, 4, 2] = (3.0, 3.0, 3.0)  # dy = +2, dx = -1 from (2, 3)
    out = local_corr(torch.from_numpy(f1), torch.from_numpy(f2), 4).numpy()
    ch = (2 + 4) * 9 + (-1 + 4)
    assert out[0, 2, 3, ch] == pytest.approx(18.0 / 3.0)
    assert np.count_nonzero(out) == 1
    ones = torch.ones((1, 5, 5, 2))
    out = local_corr(ones, ones, 4)
    assert float(out[0, 0, 0, 0]) == 0.0 and float(out[0, 0, 0, 40]) == 1.0


def test_local_corr_bf16_keeps_type_and_f32_sums():
    f1, f2 = _maps((1, 8, 8, 64))
    a, b = torch.from_numpy(f1).bfloat16(), torch.from_numpy(f2).bfloat16()
    out = local_corr(a, b, 4)
    assert out.dtype == torch.bfloat16
    want = klc.local_corr_plain(a.float(), b.float(), 4)
    # one rounding of the f32 result to bf16
    assert float((out.float() - want).abs().max()) <= 2.0 ** -8 * float(want.abs().max())


def test_local_corr_refuses_other_devices():
    meta = torch.empty((1, 4, 4, 8), device="meta")
    with pytest.raises(ValueError):
        local_corr(meta, meta, 4)
