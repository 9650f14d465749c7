"""The plain versions of kernels E (small-kv attention) and F (7x7 window
attention) against the JAX package's Pallas kernels (interpret mode on the
CPU) and XLA lowerings, in f32.

The plain versions are what CPU tensors take and what the CUDA kernels are
held against on the card, so these pin the kernels' arithmetic here.
Tolerance 1e-5: the same f32 products, sums and softmax in other orders.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from focusflow_official_tpu.kernels import attention as jattn
from focusflow_official_tpu.kernels import window_attention as jwin
from focusflow_official_tpu.nn.latent_cost import _mha
from focusflow_official_tpu_torch.kernels import attention as tattn
from focusflow_official_tpu_torch.kernels import window_attention as twin

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# (B, N, M, C, heads): N not a multiple of the Pallas 512-query block; the
# Twins-like few-hundred-key side and the perceiver's 8-key side
@pytest.mark.parametrize("b,n,m,c,heads", [
    (2, 600, 112, 64, 4),
    (3, 8, 8, 128, 8),
    (5, 1, 8, 64, 8),
    (1, 70, 300, 64, 8),
])
def test_small_kv_plain_matches_pallas_and_xla(b, n, m, c, heads):
    q, k, v = _rand(1, b, n, c), _rand(2, b, m, c), _rand(3, b, m, c)
    scale = (c // heads) ** -0.5
    got = tattn.small_kv_attention_plain(
        *map(torch.from_numpy, (q, k, v)), heads, scale).numpy()
    args = tuple(map(jnp.asarray, (q, k, v)))
    pallas = np.asarray(jattn._forward(*args, heads, scale, interpret=True))
    xla = np.asarray(jattn._xla_attention(*args, heads, scale))
    assert got.shape == (b, n, c)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, xla, **TOL)


def test_small_kv_plain_value_width_differs():
    """v narrower than q/k (`_mha`'s vd): out is (B, N, Cv)."""
    b, n, m, heads = 4, 8, 112, 8
    q, k, v = _rand(4, b, n, 128), _rand(5, b, m, 128), _rand(6, b, m, 64)
    scale = 0.3
    got = tattn.small_kv_attention_plain(
        *map(torch.from_numpy, (q, k, v)), heads, scale).numpy()
    want = np.asarray(_mha(*map(jnp.asarray, (q, k, v)), heads, scale))
    assert got.shape == (b, n, 64)
    np.testing.assert_allclose(got, want, **TOL)


def test_small_kv_cpu_wrapper_is_plain():
    q, k, v = (torch.from_numpy(_rand(s, 2, 20, 32)) for s in (7, 8, 9))
    assert torch.equal(tattn.small_kv_attention(q, k, v, 4, 0.5),
                       tattn.small_kv_attention_plain(q, k, v, 4, 0.5))


def _bf16(seed, *shape):
    return torch.from_numpy(_rand(seed, *shape)).bfloat16()


# (B, N, M, C, Cv, heads): Twins-like widths with ragged N and M (no multiple
# of 16, 32 or 64), head widths 32 and 16, a narrower v, a wider spread of v
@pytest.mark.parametrize("b,n,m,c,cv,heads,vscale", [
    (2, 301, 437, 128, 128, 4, 1.0),
    (1, 203, 17, 64, 128, 4, 1.0),
    (2, 77, 100, 256, 128, 8, 4.0),
])
def test_small_kv_bf16_weights_within_stated_tolerance(b, n, m, c, cv, heads, vscale):
    """The tensor-core entry of the CUDA kernel rounds the softmax weights
    to bf16 before the value sum and divides by the f32 sum of the unrounded
    weights. That arithmetic, modelled here on bf16 inputs, stays within
    `bf16_bound` of the plain version (f32 weights) at every output: the bound the card
    tests and `chip_smoke.py` hold the kernel to."""
    q, k = _bf16(20, b, n, c), _bf16(21, b, m, c)
    v = (_bf16(22, b, m, cv).float() * vscale).bfloat16()
    d, dv = c // heads, cv // heads
    scale = d ** -0.5
    want = tattn.small_kv_attention_plain(q, k, v, heads, scale)
    qh = q.reshape(b, n, heads, d).float()
    kh = k.reshape(b, m, heads, d).float()
    vh = v.reshape(b, m, heads, dv).float()
    s = torch.einsum("bihd,bjhd->bhij", qh, kh) * scale
    p = torch.exp(s - s.amax(-1, keepdim=True))
    out = torch.einsum("bhij,bjhd->bihd", p.bfloat16().float(), vh)
    out = out / p.sum(-1).permute(0, 2, 1)[..., None]
    got = out.reshape(b, n, cv).bfloat16()
    diff = (got.float() - want.float()).abs()
    bound = tattn.bf16_bound(want, q, k, v, heads, scale)
    assert float(diff.max()) > 0.0 and bool((diff <= bound).all())
    # the bound is no looser than it must be: where the model differs most
    # from the plain version it is under four times that difference
    assert float(bound.flatten()[diff.argmax()]) < 4 * float(diff.max())
    # and the rounding of the weights alone, before the output is rounded,
    # stays under its share of the bound at every output: 2^-8 of its row's
    # sum of p |v| (and the f32 sums' own rounding)
    exact = tattn.small_kv_attention_plain(q.float(), k.float(), v.float(), heads, scale)
    carry = tattn.small_kv_attention_plain(q.float(), k.float(), v.float().abs(),
                                           heads, scale)
    moved = (out.reshape(b, n, cv) - exact).abs()
    assert bool((moved <= 2.0 ** -8 * carry + 1e-6).all())


# (B, Hp, Wp, C, heads): several windows each way; a single window (wp == ws)
@pytest.mark.parametrize("b,hp,wp,c,heads", [
    (2, 14, 21, 64, 4),
    (1, 7, 7, 32, 2),
    (3, 14, 7, 128, 8),
])
def test_window_plain_matches_pallas_and_xla(b, hp, wp, c, heads):
    ws = 7
    q, k, v = (_rand(s, b, hp, wp, c) for s in (10, 11, 12))
    scale = (c // heads) ** -0.5
    got = twin.window_attention_plain(
        *map(torch.from_numpy, (q, k, v)), ws, heads, scale).numpy()
    args = tuple(map(jnp.asarray, (q, k, v)))
    pallas = np.asarray(jwin._forward(*args, ws, heads, scale, interpret=True))
    xla = np.asarray(jwin._xla_attention(*args, ws, heads, scale))
    assert got.shape == (b, hp, wp, c)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, xla, **TOL)


def test_window_cpu_wrapper_is_plain_and_checks_grid():
    q, k, v = (torch.from_numpy(_rand(s, 1, 14, 14, 32)) for s in (13, 14, 15))
    assert torch.equal(twin.window_attention(q, k, v, 7, 4, 0.5),
                       twin.window_attention_plain(q, k, v, 7, 4, 0.5))
    with pytest.raises(ValueError):
        twin.window_attention(q[:, :10], k[:, :10], v[:, :10], 7, 4, 0.5)
