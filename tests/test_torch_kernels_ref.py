"""The plain PyTorch versions of the port's kernels against the JAX
package's Pallas kernels (interpret mode on the CPU) and XLA references.

The plain versions are what CPU tensors take and what the CUDA kernels are
held against on the card, so this pins the kernels' arithmetic here.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from focusflow_official_tpu.kernels import fold as jfold
from focusflow_official_tpu.kernels import instance_norm as jin
from focusflow_official_tpu.ops import corr as jcorr
from focusflow_official_tpu.ops.pallas_lookup import lookup_corr_pyramid_pallas
from focusflow_official_tpu_torch.kernels import fold as tfold
from focusflow_official_tpu_torch.kernels import instance_norm as tin
from focusflow_official_tpu_torch.kernels import lookup as tlookup
from focusflow_official_tpu_torch.ops import corr as tcorr

RNG = np.random.RandomState(31)
R = 4
K = 2 * R + 1


def _t(a):
    return torch.from_numpy(np.array(a))


def _pyramid(b=1, h1=4, w1=6, h2=16, w2=20):
    """Random level-0 volume and its pooled pyramid (both frameworks pool
    with floor semantics: 16x20 -> 8x10 -> 4x5 -> 2x2), and coords that put
    windows partly and wholly outside every level."""
    corr0 = RNG.randn(b, h1 * w1, h2, w2).astype(np.float32)
    levels = tcorr.corr_pyramid(_t(corr0), 4)
    coords = np.stack([RNG.uniform(-12, w2 + 12, (b, h1, w1)),
                       RNG.uniform(-12, h2 + 12, (b, h1, w1))],
                      -1).astype(np.float32)
    coords[0, 0, 0] = (3.0, 5.0)  # integer position: zero fractional part
    return corr0, levels, coords


def test_pyramid_matches_jax():
    corr0, levels, _ = _pyramid()
    want = jcorr.corr_pyramid(jnp.asarray(corr0), 4, R).levels
    assert [tuple(lv.shape) for lv in levels] == [w.shape for w in want]
    for got, w in zip(levels, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_lookup_plain_matches_xla_lookup():
    corr0, levels, coords = _pyramid()
    pyr = jcorr.CorrPyramid(tuple(jnp.asarray(lv.numpy()) for lv in levels), R)
    want = np.asarray(jcorr.lookup_corr_pyramid(pyr, jnp.asarray(coords),
                                                impl="xla"))
    got = tlookup.lookup_plain(levels, _t(coords), R).numpy()
    assert got.shape == (1, 4, 6, 4 * K * K)
    # the same gather arithmetic in f32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_lookup_plain_matches_pallas_kernel():
    _, levels, coords = _pyramid()
    want = np.asarray(lookup_corr_pyramid_pallas(
        [jnp.asarray(lv.numpy()) for lv in levels], jnp.asarray(coords), R))
    got = tlookup.lookup_plain(levels, _t(coords), R).numpy()
    # the Pallas kernel blends a shared patch in another order: f32 rounding
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_lookup_cpu_wrapper_is_plain():
    _, levels, coords = _pyramid()
    got = tlookup.lookup(levels, _t(coords), R)
    want = tlookup.lookup_plain(levels, _t(coords), R)
    assert torch.equal(got, want)


def _fold_inputs(q=600, cout=96, dtype=np.float32):
    a = RNG.randn(1, q, 4 * K * K).astype(np.float32)
    w = (RNG.randn(4 * K * K, cout) * 0.1).astype(np.float32)  # (I, O) as in flax
    bias = RNG.randn(cout).astype(np.float32)
    if dtype != np.float32:  # make the inputs exactly representable
        a, w, bias = (np.asarray(jnp.asarray(x).astype(dtype).astype(jnp.float32))
                      for x in (a, w, bias))
    return a, w, bias


def _chunks(a):
    """Reference-ordered (B, Q, L*K2) windows -> the Pallas fold's per-level
    (B, Q, K_y, K_x) chunks."""
    b, q, _ = a.shape
    return tuple(jnp.asarray(a[..., l * K * K:(l + 1) * K * K]
                             .reshape(b, q, K, K).transpose(0, 1, 3, 2))
                 for l in range(4))


@pytest.mark.parametrize("dtype,tol", [
    (np.float32, 1e-4),  # f32 sums of 324 products, other order
    (jnp.bfloat16, 3e-2),  # one bf16 rounding of outputs of magnitude ~3
])
def test_fold_plain_matches_pallas_fold(dtype, tol):
    a, w, bias = _fold_inputs(dtype=dtype)
    saved = jfold._INTERPRET
    jfold._INTERPRET = True
    try:
        want = jfold.fold_chunks_conv(_chunks(a), jnp.asarray(w),
                                      jnp.asarray(bias), dtype)
    finally:
        jfold._INTERPRET = saved
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    got = tfold.fold(_t(a[0]).to(tdt), _t(w.T).to(tdt), _t(bias).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want[0].astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("k", [81, 324])
def test_fold_plain_zero_padded_k(k):
    """The tensor-core entry of the CUDA kernel stages K rounded up to a
    multiple of 16 with zeros in the padding of both operands: that product
    is the unpadded one. bf16 inputs, whose products are exact in f32, so
    the two differ only where the f32 sums are taken in another order."""
    m, n = 70, 40  # a ragged second tile each way
    a = torch.from_numpy(RNG.randn(m, k).astype(np.float32)).bfloat16()
    w = torch.from_numpy((RNG.randn(n, k) * 0.1).astype(np.float32)).bfloat16()
    bias = torch.from_numpy(RNG.randn(n).astype(np.float32)).bfloat16()
    kp = (k + 15) // 16 * 16
    assert kp > k
    a_pad = torch.zeros((m, kp), dtype=a.dtype)
    w_pad = torch.zeros((n, kp), dtype=w.dtype)
    a_pad[:, :k], w_pad[:, :k] = a, w
    want = tfold.fold_plain(a.float(), w.float(), bias.float())
    got = tfold.fold_plain(a_pad.float(), w_pad.float(), bias.float())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    # in the working type the two round to the same bf16 values but where a
    # sum lies within 1e-6 of a rounding boundary
    diff = (tfold.fold_plain(a_pad, w_pad, bias).float()
            - tfold.fold_plain(a, w, bias).float()).abs()
    assert float((diff > 0).float().mean()) < 1e-2


@pytest.mark.parametrize("shape", [(2, 20, 24, 64), (1, 13, 17, 96),
                                   (2, 9, 11, 128)])
def test_stats_plain_matches_pallas_stats(shape):
    x = RNG.randn(*shape).astype(np.float32) * 3 + 1
    mean, ex2 = jin._stats_only(jnp.asarray(x), interpret=True)
    want_inv = 1.0 / np.sqrt(np.asarray(ex2) - np.asarray(mean) ** 2 + 1e-5)
    got_mean, got_inv = tin.instance_norm_stats(_t(x))
    assert got_mean.shape == got_inv.shape == (shape[0], shape[3])
    # f32 sums over H*W in another order
    np.testing.assert_allclose(got_mean.numpy(), np.asarray(mean), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_inv.numpy(), want_inv, rtol=1e-4)


@pytest.mark.parametrize("relu", [False, True])
def test_instance_norm_plain_matches_pallas(relu):
    x = RNG.randn(2, 20, 24, 64).astype(np.float32) * 3 + 1
    want = np.asarray(jin._forward(jnp.asarray(x), 1e-5, relu, interpret=True))
    got = tin.instance_norm(_t(x), 1e-5, relu).numpy()
    # normalised values are O(1): f32 rounding of the stats
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_wrappers_refuse_other_devices():
    """A wrapper takes its plain version for CPU tensors only; any other
    device is refused, never quietly computed elsewhere."""
    meta = torch.empty((1, 4, 4, 8), device="meta")
    with pytest.raises(ValueError):
        tin.instance_norm_stats(meta)
    with pytest.raises(ValueError):
        tfold.fold(meta[0, 0], meta[0, 0], meta[0, 0, 0])
    with pytest.raises(ValueError):
        tlookup.lookup([meta], torch.empty((1, 2, 2, 2), device="meta"), R)
