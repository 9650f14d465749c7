"""The plain PyTorch version of the port's fused lookup + convc1 against the
JAX package, from one level-0 volume: the production fused-chunk lookup
followed by `ChunkFoldedConv1x1`, and the Pallas stage-2 kernel in interpret
mode fed by a stage 1 computed by hand. f32, the tolerance of the JAX
package's own test of that kernel (2e-3 on outputs of size ~10)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from focusflow_official_tpu.kernels import stage2
from focusflow_official_tpu.nn.update import ChunkFoldedConv1x1
from focusflow_official_tpu.ops.corr import (
    _block_tent_weights_base, _pool_sizes, lookup_corr_fused_chunks)
from focusflow_official_tpu_torch.kernels import lookup_fold as klf
from focusflow_official_tpu_torch.kernels.fold import fold_plain
from focusflow_official_tpu_torch.kernels.lookup import lookup_plain
from focusflow_official_tpu_torch.ops.corr import corr_pyramid

RNG = np.random.RandomState(47)
B, H2, W2, R, LEVELS, COUT = 1, 15, 26, 3, 3, 64
K = 2 * R + 1
K2 = K * K
Q = H2 * W2


def _inputs():
    corr0 = RNG.randn(B, Q, H2, W2).astype(np.float32)
    cx = RNG.rand(B, H2, W2, 1) * (W2 - 1)
    cy = RNG.rand(B, H2, W2, 1) * (H2 - 1)
    coords = np.concatenate([cx, cy], -1).astype(np.float32)
    w = (RNG.randn(LEVELS * K2, COUT) * 0.1).astype(np.float32)  # (I, O) as in flax
    bias = RNG.randn(COUT).astype(np.float32)
    return corr0, coords, w, bias


def _port(corr0, coords, w, bias):
    levels = corr_pyramid(torch.from_numpy(corr0), LEVELS)
    out = klf.lookup_fold(levels, torch.from_numpy(coords), R,
                          torch.from_numpy(w.T.copy()), torch.from_numpy(bias))
    assert out.shape == (B, H2, W2, COUT)
    return out.reshape(B, Q, COUT).numpy()


def test_lookup_fold_matches_fused_chunks_then_fold():
    corr0, coords, w, bias = _inputs()
    chunks = lookup_corr_fused_chunks(jnp.asarray(corr0), jnp.asarray(coords),
                                      R, LEVELS, dtype=jnp.float32)
    mod = ChunkFoldedConv1x1(features=COUT, corr_levels=LEVELS, corr_radius=R)
    variables = {"params": {"kernel": jnp.asarray(w).reshape(1, 1, -1, COUT),
                            "bias": jnp.asarray(bias)}}
    want = np.asarray(mod.apply(variables, chunks))  # (B, Q, cout)
    np.testing.assert_allclose(_port(corr0, coords, w, bias), want,
                               atol=2e-3, rtol=1e-4)


@pytest.mark.parametrize("transpose_in_kernel", [True, False])
def test_lookup_fold_matches_pallas_stage2(transpose_in_kernel):
    """The TPU kernel takes the level-0 volume already contracted with the
    x tents (stage 1) and its weight rows in (l, j, i) order; both are the
    JAX side's business and are built here as its own test builds them."""
    corr0, coords, w, bias = _inputs()
    jc = jnp.asarray(coords)
    d = jnp.linspace(-R, R, K, dtype=jnp.float32)
    sizes = _pool_sizes(H2, W2, LEVELS)
    cxq = jc[..., 0].reshape(B, Q)
    cyq = jc[..., 1].reshape(B, Q)
    sx_all = jnp.concatenate(
        [_block_tent_weights_base(cxq / (2.0 ** l), d, l, W2, wl)
         for l, (_, wl) in enumerate(sizes)], axis=-2)
    t = jnp.einsum("bqyx,bqix->bqyi", jnp.asarray(corr0), sx_all)
    idx = np.array([l * K2 + i * K + j for l in range(LEVELS)
                    for j in range(K) for i in range(K)])
    saved = stage2._INTERPRET
    stage2._INTERPRET = True
    try:
        want = np.asarray(stage2.stage2_fold(
            t, cyq, jnp.asarray(w[idx]), jnp.asarray(bias), R,
            [hl for hl, _ in sizes], dtype=jnp.float32,
            transpose_in_kernel=transpose_in_kernel))
    finally:
        stage2._INTERPRET = saved
    np.testing.assert_allclose(_port(corr0, coords, w, bias), want,
                               atol=2e-3, rtol=1e-4)


def test_lookup_fold_plain_is_lookup_then_fold():
    """bf16: the window is rounded to the compute type between the lookup
    and the product, and the output is in the compute type."""
    corr0, coords, w, bias = _inputs()
    bf16 = torch.bfloat16
    levels = corr_pyramid(torch.from_numpy(corr0), LEVELS, bf16)
    wt = torch.from_numpy(w.T.copy()).to(bf16)
    bt = torch.from_numpy(bias).to(bf16)
    c = torch.from_numpy(coords)
    got = klf.lookup_fold(levels, c, R, wt, bt)
    assert got.dtype == bf16
    window = lookup_plain(levels, c, R).reshape(Q, -1).to(bf16)
    assert torch.equal(got.reshape(Q, COUT), fold_plain(window, wt, bt))


def test_lookup_fold_refuses_other_devices():
    meta = torch.empty((1, 4, 2, 2), device="meta")
    with pytest.raises(ValueError):
        klf.lookup_fold([meta], torch.empty((1, 2, 2, 2), device="meta"), 4,
                        torch.empty((8, 81), device="meta"),
                        torch.empty((8,), device="meta"))
