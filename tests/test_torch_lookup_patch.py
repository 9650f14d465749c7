"""The window gather of kernels A and G (`csrc/lookup.cuh`), modelled in
torch: stage each (query, level) unit's zero-filled (2r+3)^2 patch, anchored
at floor(c / 2^l) - r, then compute every window value from the patch with
the per-value f32 arithmetic of the plain version. The model must give
`lookup_plain`'s bits (torch.equal) at coordinates chosen to break a
narrower patch or a shared fraction; the plain version is held against
the JAX package here too. Also: A's output type on the CPU, and the bf16
launch plan of the fused lookup + convc1 (`kernels/lookup_fold.py::plan`).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from focusflow_official_tpu.ops import corr as jcorr
from focusflow_official_tpu_torch.kernels import lookup as kl
from focusflow_official_tpu_torch.kernels import lookup_fold as klf
from focusflow_official_tpu_torch.ops.corr import corr_pyramid

SMS = 132  # an H100's SMs: the plan takes the card's count as an argument
LAYOUT = dict(rows=16, cols=256)  # the bf16 entry as `csrc/lookup_fold.cu` builds it


def _hard_coords(rng, b, h1, w1, span):
    """(B, H1, W1, 2) f32 coordinates of five kinds, mixed per value: the
    largest f32 below (or the least above) an integer at some level's scale
    (a fraction of 1 - 2^-24 there), uniform over [-40, span + 40] (negative,
    and past every edge of every level), 1000 + u and -1000 - u (an f32 ulp
    of 2^-14 there), and uniform inside the level."""
    shape = (b, h1, w1, 2)
    scale = 2.0 ** rng.randint(0, 4, shape)
    ints = rng.randint(-4, span + 4, shape) * scale
    below = np.nextafter(ints.astype(np.float32), np.float32(-np.inf))
    above = np.nextafter(ints.astype(np.float32), np.float32(np.inf))
    wide = rng.uniform(-40, span + 40, shape)
    far = np.where(rng.rand(*shape) < 0.5, 1000 + rng.rand(*shape), -1000 - rng.rand(*shape))
    inside = rng.uniform(0, span, shape)
    kind = rng.randint(0, 5, shape)
    out = np.choose(kind, [below, above, wide, far, inside]).astype(np.float32)
    out.reshape(-1, 2)[0] = (np.nextafter(np.float32(1), np.float32(0)),) * 2  # 1 - 2^-24
    return torch.from_numpy(out)


def _patch_lookup(levels, coords, r):
    """The kernels' gather in torch: per (query, level) the P x P patch
    (P = 2r+3) at (floor(x) - r, floor(y) - r), zero outside the level, then
    window_value's arithmetic with its taps read from the patch. Also
    returns the least and largest tap offset into the patch."""
    b, h1, w1, _ = coords.shape
    q = h1 * w1
    k, p = 2 * r + 1, 2 * r + 3
    c = coords.reshape(b, q, 2)
    d = torch.arange(-r, r + 1, dtype=torch.float32)
    dx, dy = d.repeat_interleave(k), d.repeat(k)  # x-offset slow
    prow = torch.arange(p).repeat_interleave(p)
    pcol = torch.arange(p).repeat(p)
    outs, lo, hi = [], p, -1
    for l, lv in enumerate(levels):
        h, w = lv.shape[2:]
        x = c[..., 0:1] * (1.0 / 2 ** l)
        y = c[..., 1:2] * (1.0 / 2 ** l)
        ax = torch.floor(x).long() - r
        ay = torch.floor(y).long() - r
        xi, yi = ax + pcol, ay + prow  # (B, Q, P*P)
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        flat = lv.reshape(b, q, h * w).float()
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1))
        patch = torch.where(inside, torch.gather(flat, 2, idx), torch.zeros(()))
        vx, vy = x + dx, y + dy  # (B, Q, K2)
        x0, y0 = torch.floor(vx), torch.floor(vy)
        wx, wy = vx - x0, vy - y0
        px, py = x0.long() - ax, y0.long() - ay
        lo = min(lo, int(px.min()), int(py.min()))
        hi = max(hi, int(px.max()), int(py.max()))

        def tap(oy, ox):
            return torch.gather(patch, 2, (py + oy) * p + px + ox)

        ux, uy = 1 - wx, 1 - wy
        v = tap(0, 0) * (ux * uy)
        v = v + tap(0, 1) * (wx * uy)
        v = v + tap(1, 0) * (ux * wy)
        v = v + tap(1, 1) * (wx * wy)
        outs.append(v)
    return torch.cat(outs, -1).reshape(b, h1, w1, -1), lo, hi


@pytest.mark.parametrize("r", [3, 4])
@pytest.mark.parametrize("num_levels", [1, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_patch_gather_equals_lookup_plain(r, num_levels, seed):
    """Level 3 of an 8 x 12 grid is 1 x 1; every kind of coordinate of
    `_hard_coords` occurs."""
    rng = np.random.RandomState(seed)
    b, h1, w1 = 2, 8, 12
    levels = corr_pyramid(torch.from_numpy(
        rng.randn(b, h1 * w1, h1, w1).astype(np.float32)), num_levels)
    coords = _hard_coords(rng, b, h1, w1, w1)
    got, lo, hi = _patch_lookup(levels, coords, r)
    want = kl.lookup_plain(levels, coords, r)
    assert torch.equal(got, want)
    assert 0 <= lo and hi <= 2 * r + 1  # every tap pair inside the patch


def test_patch_gather_needs_2r_plus_3():
    """floor(cx + d) - floor(cx) - d = 1 happens in f32: at cx = 1 - 2^-24,
    cx + 4 rounds to 5. A tap pair then starts at offset 2r+1 of the patch,
    past the 2r+2 patch of the TPU kernel, and the fraction there is 0."""
    cx = np.float32(1) - np.float32(2.0 ** -24)
    assert cx < 1 and np.floor(cx) == 0
    assert np.floor(cx + np.float32(4)) - np.floor(cx) - 4 == 1
    levels = [torch.randn(1, 1, 12, 12)]
    coords = torch.tensor([[[[cx, cx]]]], dtype=torch.float32)
    got, lo, hi = _patch_lookup(levels, coords, 4)
    assert hi == 9  # = 2r + 1: both taps 9 and 10 lie in an 11-wide patch
    assert torch.equal(got, kl.lookup_plain(levels, coords, 4))


def test_lookup_plain_matches_jax_at_hard_coords():
    """The plain version the patch model is held to, against the JAX
    package's XLA lookup at the same coordinates (f32 sums of the same four
    taps in another order)."""
    rng = np.random.RandomState(5)
    b, h1, w1, r = 1, 8, 12, 4
    corr0 = rng.randn(b, h1 * w1, h1, w1).astype(np.float32)
    levels = corr_pyramid(torch.from_numpy(corr0), 4)
    coords = _hard_coords(rng, b, h1, w1, w1)
    pyr = jcorr.CorrPyramid(tuple(jnp.asarray(lv.numpy()) for lv in levels), r)
    want = np.asarray(jcorr.lookup_corr_pyramid(pyr, jnp.asarray(coords.numpy()),
                                                impl="xla"))
    got = kl.lookup_plain(levels, coords, r).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("num_levels", [1, 4])
def test_lookup_bf16_out_on_cpu(num_levels):
    """bf16 levels give a bf16 window: the f32 sums of the same values
    rounded once, the bits of the f32 window's cast."""
    rng = np.random.RandomState(3)
    levels = corr_pyramid(torch.from_numpy(
        rng.randn(1, 96, 8, 12).astype(np.float32)), num_levels, torch.bfloat16)
    coords = _hard_coords(rng, 1, 8, 12, 12)
    got = kl.lookup(levels, coords, 4)
    want = kl.lookup_plain([lv.float() for lv in levels], coords, 4)
    assert got.dtype == torch.bfloat16 and want.dtype == torch.float32
    assert torch.equal(got, want.to(torch.bfloat16))


@pytest.mark.parametrize("r", [3, 4])
def test_lookup_f32_out_on_cpu(r):
    """f32 levels give an f32 window, the patch model's bits."""
    rng = np.random.RandomState(4)
    levels = corr_pyramid(torch.from_numpy(rng.randn(1, 96, 8, 12).astype(np.float32)), 4)
    coords = _hard_coords(rng, 1, 8, 12, 12)
    got = kl.lookup(levels, coords, r)
    assert got.dtype == torch.float32
    assert torch.equal(got, _patch_lookup(levels, coords, r)[0])


def test_lookup_fold_plan_raft():
    """FF-RAFT's shape: Q = 7040, 4 levels, (256, 324): one column slice,
    one block an SM, each walking a run of at most 54 queries (53.3 on
    average, where whole 32-row tiles would give the busiest block 64) in
    passes of 16 rows."""
    p = klf.plan(7040, 256, 4, torch.bfloat16, SMS, **LAYOUT)
    assert p == dict(entry="mma", grid=132, slices=1, per_block=54)


@pytest.mark.parametrize("q,n,grid,slices,per_block", [
    (192, 256, 12, 1, 16),     # the cuda test shapes: fewer blocks than SMs
    (140, 70, 9, 1, 16),       # Q = 140: runs of 15 and 16, a ragged tile
    (192, 300, 24, 2, 16),     # N = 300: two column slices of 256 and 44
    (99, 64, 7, 1, 15),
    (7040, 300, 132, 2, 107),  # two slices share the SMs, 66 blocks each
    (7040, 1000, 132, 4, 214),
    (100, 256, 1, 1, 100),     # a card of one SM: one block walks every tile
])
def test_lookup_fold_plan_shapes(q, n, grid, slices, per_block):
    sms = 1 if grid == 1 else SMS
    p = klf.plan(q, n, 4, torch.bfloat16, sms, **LAYOUT)
    assert (p["grid"], p["slices"], p["per_block"]) == (grid, slices, per_block)
    assert p["grid"] % p["slices"] == 0 and p["grid"] <= max(sms, p["slices"])
    # the runs of a slice cover the queries once, none longer than per_block
    per_slice = grid // slices
    runs = [q * (j + 1) // per_slice - q * j // per_slice for j in range(per_slice)]
    assert sum(runs) == q and max(runs) == per_block and min(runs) >= 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_lookup_fold_plan_refusals(dtype):
    """Plans exist for the radii the gather is built for, 3 and 4; f32
    takes the FMA entry, which lays itself out."""
    entry = "mma" if dtype == torch.bfloat16 else "fma"
    assert klf.plan(7040, 256, 4, dtype, SMS, **LAYOUT)["entry"] == entry
    assert klf.plan(100, 256, 3, dtype, SMS, **LAYOUT)["entry"] == entry
    for radius in (0, 1, 2, 5):
        with pytest.raises(ValueError):
            klf.plan(7040, 256, radius, dtype, SMS, **LAYOUT)
    if dtype == torch.float32:
        assert klf.plan(7040, 256, 4, dtype, SMS, **LAYOUT) == dict(
            entry="fma", grid=None, slices=None)
