"""The split and the finish of kernel C1 (`in_stats` in
`csrc/instance_norm.cu`), modelled in plain torch: `plan` cuts a sample's
H*W rows into S slabs of ceil(H*W / S) (the last one shorter where S does
not divide H*W); in a slab, C / VEC threads cover a row (VEC channels each:
8 bf16 or 4 f32 on the vector entry, 1 on the scalar one) and 256 / (C /
VEC) rows are in flight, each thread summing its rows in row order in f32
(x^2 by FMA); the block adds its row groups in order into a partial, and
the block that finishes last adds the S partials in index order.

The model is held to `stats_plain` and to the JAX package's
`instance_norm_stats` (its XLA path, and its Pallas stats kernel in
interpret mode), C = 300 included (the scalar entry in bf16). Which block
finishes last does not change the bits, where a finish in arrival order
would.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from focusflow_official_tpu.kernels import instance_norm as jin
from focusflow_official_tpu_torch.kernels import instance_norm as kin

THREADS = 256  # a stats block, as `csrc/instance_norm.cu` builds it


def _fma(a, b, c):
    """a * b + c rounded once to f32 (exact for bf16 values, whose squares
    f32 holds; through f64 for f32 values)."""
    return (a.double() * b.double() + c.double()).float()


def partials(x, splits, vec):
    """(B, S, 2, C) block partials of NHWC x, summed as the kernel sums."""
    b, h, w, c = x.shape
    hw = h * w
    rows = -(-hw // splits)
    lanes = min(c // vec, THREADS)
    rps = THREADS // lanes  # rows in flight; thread rsub takes rows r0 + rsub + i * rps
    xf = x.float().reshape(b, hw, c)
    out = torch.zeros(b, splits, 2, c)
    for s in range(splits):
        r0, r1 = s * rows, min(hw, (s + 1) * rows)
        s1 = torch.zeros(b, rps, c)
        s2 = torch.zeros(b, rps, c)
        for i in range(-(-max(r1 - r0, 0) // rps)):
            idx = r0 + i * rps + torch.arange(rps)
            ok = (idx < r1)[None, :, None]
            v = torch.where(ok, xf[:, idx.clamp(max=hw - 1)], 0.0)
            s1 = s1 + v
            s2 = _fma(v, v, s2)
        t1 = torch.zeros(b, c)
        t2 = torch.zeros(b, c)
        for j in range(rps):  # the block's row groups, in order
            t1 = t1 + s1[:, j]
            t2 = t2 + s2[:, j]
        out[:, s, 0], out[:, s, 1] = t1, t2
    return out


def finish(part, hw, eps=1e-5, order=None):
    """mean, inv from the partials, added in index order (or in `order`,
    which the kernel does not do)."""
    t1 = torch.zeros(part.shape[0], part.shape[3])
    t2 = torch.zeros_like(t1)
    for s in order if order is not None else range(part.shape[1]):
        t1 = t1 + part[:, s, 0]
        t2 = t2 + part[:, s, 1]
    m = t1 / float(hw)
    var = torch.clamp(t2 / float(hw) - m * m, min=0.0)
    return m, torch.rsqrt(var + eps)


def last_block_finishes(part, hw, arrival):
    """The tickets: blocks take one each from the sample's counter in
    `arrival` order; the one that draws the last ticket finishes (in index
    order) and puts the counter back to 0 -> (mean, inv, counter after)."""
    counter = 0
    for _ in arrival:
        ticket, counter = counter, counter + 1
        if ticket == part.shape[1] - 1:
            mean, inv = finish(part, hw)
            counter = 0
    return mean, inv, counter


def stats_model(x, sms):
    b, h, w, c = x.shape
    vec = kin.vector_width(x.dtype) if kin.design(x) == "vector" else 1
    part = partials(x, kin.plan(h * w, b, sms), vec)
    mean, inv, _ = last_block_finishes(part, h * w, range(part.shape[1]))
    return mean, inv


def _x(seed, shape, dtype):
    rng = np.random.RandomState(seed)
    return torch.from_numpy((rng.randn(*shape) * 3 + 1).astype(np.float32)).to(dtype)


CASES = [
    # (shape, SMs): S = plan(H*W, B, SMs)
    ((1, 20, 50, 64), 2),     # S = 4, 250 rows each; 32 rows in flight (bf16)
    ((1, 7, 143, 96), 2),     # S = 4 of 251 rows, the last 248; 12 threads a bf16 row
    ((3, 40, 50, 128), 4),    # S = 3 of 667 rows, the last 666
    ((2, 9, 11, 300), 132),   # S = 1; bf16: the scalar entry, two channel chunks
    ((2, 55, 64, 8), 132),    # S = 28 of 126 rows, the last 118; one bf16 vector a row
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,sms", CASES)
def test_model_matches_plain_and_jax(dtype, shape, sms):
    x = _x(0, shape, dtype)
    mean, inv = stats_model(x, sms)
    rmean, rinv = kin.stats_plain(x)
    torch.testing.assert_close(mean, rmean, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(inv, rinv, rtol=1e-4, atol=1e-5)
    xj = jnp.asarray(x.float().numpy())  # the same values, in f32 on the JAX side
    jmean, jinv = jin.instance_norm_stats(xj, 1e-5)  # its XLA path off the TPU
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean)[:, 0, 0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(inv.numpy(), np.asarray(jinv)[:, 0, 0], rtol=1e-4, atol=1e-5)


def test_model_matches_the_pallas_stats_kernel():
    """The TPU kernel itself, in interpret mode, at one shape."""
    x = _x(1, (2, 12, 40, 64), torch.float32)
    jmean, jex2 = jin._stats_only(jnp.asarray(x.numpy()), interpret=True)
    jinv = 1.0 / np.sqrt(np.asarray(jex2) - np.asarray(jmean) ** 2 + 1e-5)
    mean, inv = stats_model(x, 2)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(inv.numpy(), jinv, rtol=1e-4, atol=1e-5)


def test_entry_by_width_and_alignment():
    """16-byte loads where C is a multiple of 8 (bf16) or 4 (f32) and x
    starts on a 16-byte boundary; scalar loads otherwise."""
    for shape, dtype, entry in (((1, 4, 4, 64), torch.bfloat16, "vector"),
                                ((1, 4, 4, 300), torch.bfloat16, "scalar"),
                                ((1, 4, 4, 300), torch.float32, "vector"),
                                ((1, 4, 4, 6), torch.float32, "scalar")):
        assert kin.design(torch.zeros(shape, dtype=dtype)) == entry
    flat = torch.zeros(1 + 4 * 4 * 64, dtype=torch.bfloat16)
    shifted = flat[1:].view(1, 4, 4, 64)  # 2 bytes past a 16-byte boundary
    assert shifted.is_contiguous() and kin.design(shifted) == "scalar"


def test_plan_covers_every_row_once():
    for hw, b, sms in ((112640, 2, 132), (28160, 2, 132), (7040, 2, 132),
                       (1001, 1, 2), (100, 3, 132), (1, 1, 132)):
        s = kin.plan(hw, b, sms)
        rows = -(-hw // s)
        assert 1 <= s and (s - 1) * rows < hw <= s * rows
        assert s <= -(-kin.BLOCKS_PER_SM * sms // b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_finish_order_does_not_depend_on_arrival(dtype):
    """The last block adds the partials in index order, whichever block it
    is: every arrival order gives the same bits. Added in arrival order
    instead, some orders give other bits."""
    x = _x(2, (2, 40, 90, 64), dtype)
    hw = 40 * 90
    part = partials(x, kin.plan(hw, 2, 8), kin.vector_width(dtype))
    assert part.shape[1] == 8
    want = finish(part, hw)
    rng = np.random.RandomState(0)
    moved = False
    for _ in range(20):
        arrival = rng.permutation(part.shape[1])
        *got, counter = last_block_finishes(part, hw, arrival)
        assert counter == 0  # zero again for the next launch
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        naive = finish(part, hw, order=arrival)
        moved |= not all(torch.equal(a, b) for a, b in zip(naive, want))
    assert moved
