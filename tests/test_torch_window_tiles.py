"""The tile arithmetic of kernel F's tensor-core entry (`window_mma` in
`csrc/window_attention.cu`), modelled in plain torch: per window and head,
the 49 query rows padded to 64 (four m16 tiles), S = Q.K^T over 56 key
columns (seven n8 tiles) with columns 49-55 set to -inf, the softmax taken
whole as 2^(s * scale * log2 e - max) with the row sum of the unrounded
weights, P rounded to bf16 (columns 56-63 zero) for O = P.V over 64 value
rows, rows 49-63 of V staged as zeros, f32 sums, the 49 real rows kept.

The model is held to `window_attention_plain` within `bf16_bound` (the
bound the card holds the kernel to), and in f32 (P not rounded) to the JAX
package's `_xla_attention` at a grid that 7 does not divide before
padding. Two cases show why the padding is written as it is: NaN in the
padded value rows reaches every output (0 * NaN), and padded keys left in
the softmax break the bound.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from focusflow_official_tpu.kernels.window_attention import _xla_attention
from focusflow_official_tpu_torch.kernels import window_attention as kw

WS, ROWS, KEYS = 7, 64, 56
LOG2E = 1.4426950408889634


def _windows(t, heads):
    """(B, Hp, Wp, C) -> (B, nwin, heads, 49, d) f32."""
    b, hp, wp, c = t.shape
    nh, nw = hp // WS, wp // WS
    t = t.float().reshape(b, nh, WS, nw, WS, heads, c // heads)
    return t.permute(0, 1, 3, 5, 2, 4, 6).reshape(b, nh * nw, heads, WS * WS, c // heads)


def _merge(o, shape):
    b, hp, wp, c = shape
    nh, nw = hp // WS, wp // WS
    heads, d = o.shape[2], o.shape[-1]
    o = o.reshape(b, nh, nw, heads, WS, WS, d).permute(0, 1, 4, 2, 5, 3, 6)
    return o.reshape(b, hp, wp, c)


def _pad_rows(t, rows, fill=0.0):
    out = torch.full(t.shape[:-2] + (rows, t.shape[-1]), fill, dtype=torch.float32)
    out[..., : t.shape[-2], :] = t
    return out


def tile_model(q, k, v, heads, scale, *, round_p=True, v_fill=0.0, mask=True):
    """The kernel's tiles on (B, Hp, Wp, C) q, k, v -> (B, Hp, Wp, C) in
    q's type. `v_fill` fills value rows 49-63; `mask=False` leaves key
    columns 49-55 (zero keys) in the softmax."""
    qp = _pad_rows(_windows(q, heads), ROWS)  # padded query rows: zeros
    kp = _pad_rows(_windows(k, heads), ROWS)[..., :KEYS, :]
    vp = _pad_rows(_windows(v, heads), ROWS, v_fill)
    sl = max(abs(scale) * LOG2E, 1.17549435e-38)
    if scale < 0:  # the kernel moves the sign into q
        qp = -qp
    s = qp @ kp.transpose(-1, -2)  # (.., 64, 56)
    if mask:
        s[..., WS * WS:] = -math.inf
    m = s.amax(-1, keepdim=True) * sl
    p = torch.exp2(s * sl - m)
    l = p.sum(-1, keepdim=True)  # of the unrounded weights
    pt = torch.zeros(p.shape[:-1] + (ROWS,))
    pt[..., :KEYS] = p.bfloat16().float() if round_p else p
    o = (pt @ vp) / l
    return _merge(o[..., : WS * WS, :], q.shape).to(q.dtype)


def _qkv(seed, shape, dtype):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)
            for _ in range(3)]


@pytest.mark.parametrize("shape,heads,scale", [
    ((2, 14, 21, 128), 4, 32 ** -0.5),   # Twins stage 1's head width, odd window count
    ((1, 7, 14, 256), 8, 32 ** -0.5),    # stage 2's width: two groups of 4 heads
    ((2, 14, 14, 128), 8, 16 ** -0.5),   # the vertical local layer's head width 16
    ((1, 7, 7, 32), 2, -0.3),            # one window, a negative scale
])
def test_model_within_bf16_bound_of_plain(shape, heads, scale):
    q, k, v = _qkv(0, shape, torch.bfloat16)
    got = tile_model(q, k, v, heads, scale)
    want = kw.window_attention_plain(q, k, v, WS, heads, scale)
    bound = kw.bf16_bound(want, q, k, v, heads, scale)
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= bound).all()), float((diff / bound).max())
    # the bound is not slack: rounding P moves outputs by more than an f32 sum
    assert float(diff.max()) > 0


def test_nan_in_padded_value_rows_reaches_every_output():
    """P is 0 on value rows 49-63, but 0 * NaN = NaN: the kernel stages
    those rows as zeros, not left as they were."""
    q, k, v = _qkv(1, (1, 7, 14, 64), torch.bfloat16)
    good = tile_model(q, k, v, 2, 0.25)
    assert bool(torch.isfinite(good.float()).all())
    bad = tile_model(q, k, v, 2, 0.25, v_fill=math.nan)
    assert bool(torch.isnan(bad.float()).all())


def test_padded_keys_must_leave_the_softmax():
    """Key columns 49-55 hold zero keys; left in the softmax they take
    weight from the real keys, past the bound."""
    q, k, v = _qkv(2, (1, 7, 14, 64), torch.bfloat16)
    want = kw.window_attention_plain(q, k, v, WS, 2, 0.25)
    bound = kw.bf16_bound(want, q, k, v, 2, 0.25)
    got = tile_model(q, k, v, 2, 0.25, mask=False)
    assert not bool(((got.float() - want.float()).abs() <= bound).all())


@pytest.mark.parametrize("heads", [4, 8])
def test_f32_model_matches_jax_on_a_padded_grid(heads):
    """A 10x17 grid of tokens padded to 14x21 before the projections (as
    the callers pad), so padded tokens carry the bias; in f32 with P not
    rounded the model is the plain attention up to f32 sums."""
    rng = np.random.RandomState(3)
    c = 128
    x = rng.randn(2, 10, 17, c).astype(np.float32)
    xp = np.pad(x, ((0, 0), (0, 4), (0, 4), (0, 0)))
    q, k, v = (xp @ (rng.randn(c, c).astype(np.float32) / np.sqrt(c))
               + 0.1 * rng.randn(c).astype(np.float32) for _ in range(3))
    scale = (c // heads) ** -0.5
    want = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     WS, heads, scale))
    got = tile_model(*(torch.from_numpy(t) for t in (q, k, v)), heads, scale,
                     round_p=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    plain = kw.window_attention_plain(*(torch.from_numpy(t) for t in (q, k, v)),
                                      WS, heads, scale)
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-5, atol=1e-5)
