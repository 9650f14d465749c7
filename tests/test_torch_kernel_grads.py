"""The backwards of the port's kernel Functions (`kernels/{instance_norm,
lookup,lookup_fold,fold}.py`) on the CPU, where each forward takes its
plain version and each backward is the same plain PyTorch the card runs:

- against autograd through the plain version (f64 where the plain
  version computes in x's type: C2; the others compute in f32);
- against `jax.vjp` of the JAX function, as the JAX tests run it on the
  CPU: `instance_norm_pallas` (both relu settings; the residual form
  relu(r + y) against the same composition in JAX), `instance_norm_stats`,
  `kernels/fold.py::_fold` (its Pallas forward in interpret mode) and
  `lookup_corr_pyramid_pallas` (interpret mode).

f32 bounds: 1e-5 of each gradient's largest value. The JAX lookup's VJP
differentiates its tent form in bf16 (`ops/pallas_lookup.py::_mxu_reference`
takes `_lookup_level_mxu`'s default dtype), so it is held at 1% of the
largest value, and the port's f32 tent form is held at 1e-5 against
`jax.vjp` of the same tent form in f32 and of the gather form (XLA).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from focusflow_official_tpu.kernels import fold as jfold
from focusflow_official_tpu.kernels.instance_norm import (instance_norm_pallas,
                                                           instance_norm_stats as jstats)
from focusflow_official_tpu.ops.corr import CorrPyramid, _lookup_level_mxu, lookup_corr_pyramid
from focusflow_official_tpu.ops.pallas_lookup import lookup_corr_pyramid_pallas
from focusflow_official_tpu_torch.kernels import fold as kf
from focusflow_official_tpu_torch.kernels import instance_norm as kin
from focusflow_official_tpu_torch.kernels import lookup as kl
from focusflow_official_tpu_torch.kernels import lookup_fold as klf

RNG = np.random.RandomState(11)


def _close(got, want, rel=1e-5, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= rel * max(float(np.abs(want).max()), 1e-30), (what, err)


def _grads(fn, inputs, cot):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    out = fn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    cots = [torch.from_numpy(c) for c in (cot if isinstance(cot, tuple) else (cot,))]
    return [g.numpy() for g in torch.autograd.grad(outs, leaves, cots)]


def _pyramid(b, h, w):
    """Four levels of a seeded (B, H*W, H, W) volume, pooled as the port
    pools, and coordinates with subpixel offsets, some off the level."""
    corr = torch.from_numpy(RNG.randn(b, h * w, h, w).astype(np.float32))
    from focusflow_official_tpu_torch.ops.corr import corr_pyramid

    levels = [lv.numpy() for lv in corr_pyramid(corr, 4)]
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    grid = np.stack([xs, ys], -1)[None].astype(np.float32)
    coords = grid + RNG.randn(b, h, w, 2).astype(np.float32) * 3
    return levels, coords


# ---------------------------------------------------------------- C1, C2
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("residual", [False, True])
def test_instance_norm_matches_plain_f64(relu, residual):
    x = (RNG.randn(2, 9, 13, 16) * 3 + 1).astype(np.float64)
    r = RNG.randn(*x.shape).astype(np.float64)
    cot = RNG.randn(*x.shape).astype(np.float64)
    inputs = [x, r] if residual else [x]

    def plain(x_, *r_):
        return kin.apply_plain(x_, *[s.double() for s in kin.stats_plain(x_)], relu,
                               *(r_ or (None,)))

    got = _grads(lambda x_, *r_: kin.instance_norm(x_, 1e-5, relu, *(r_ or (None,))),
                 inputs, cot)
    want = _grads(plain, inputs, cot)
    for name, a, b in zip(("dx", "dr"), got, want):
        # the VJP recomputes its stats in f32, as the JAX VJP does
        _close(a, b, 1e-5, name)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("residual", [False, True])
def test_instance_norm_matches_jax_vjp(relu, residual):
    x = (RNG.randn(2, 9, 13, 16) * 3 + 1).astype(np.float32)
    r = RNG.randn(*x.shape).astype(np.float32)
    cot = RNG.randn(*x.shape).astype(np.float32)
    if residual:
        f = lambda x_, r_: jax.nn.relu(r_ + instance_norm_pallas(x_, 1e-5, relu))
        _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(r))
        got = _grads(lambda x_, r_: kin.instance_norm(x_, 1e-5, relu, r_), [x, r], cot)
    else:
        _, vjp = jax.vjp(lambda x_: instance_norm_pallas(x_, 1e-5, relu), jnp.asarray(x))
        got = _grads(lambda x_: kin.instance_norm(x_, 1e-5, relu), [x], cot)
    for name, a, b in zip(("dx", "dr"), got, vjp(jnp.asarray(cot))):
        _close(a, b, 1e-5, name)


def test_instance_norm_stats_matches_plain_and_jax_vjp():
    x = (RNG.randn(2, 11, 7, 24) * 2 + 1).astype(np.float32)
    gm, gi = (RNG.randn(2, 24).astype(np.float32) for _ in range(2))
    got = _grads(lambda x_: kin.instance_norm_stats(x_), [x], (gm, gi))[0]
    want = _grads(lambda x_: kin.stats_plain(x_), [x], (gm, gi))[0]
    _close(got, want, 1e-5, "plain")
    _, vjp = jax.vjp(lambda x_: jstats(x_, 1e-5), jnp.asarray(x))
    (jx,) = vjp((jnp.asarray(gm)[:, None, None, :], jnp.asarray(gi)[:, None, None, :]))
    _close(got, jx, 1e-5, "jax")


def test_instance_norm_bf16_gradient_lands_in_bf16():
    x = torch.from_numpy((RNG.randn(1, 6, 8, 16) * 2).astype(np.float32)).bfloat16()
    x.requires_grad_(True)
    kin.instance_norm(x, 1e-5, True).float().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and torch.isfinite(x.grad).all()


# ------------------------------------------------------------------- B
def test_fold_matches_plain_and_jax_vjp(monkeypatch):
    m, k, n = 520, 324, 64
    a = RNG.randn(m, k).astype(np.float32)
    w = (RNG.randn(n, k) * 0.1).astype(np.float32)
    bias = RNG.randn(n).astype(np.float32)
    cot = RNG.randn(m, n).astype(np.float32)
    got = _grads(kf.fold, [a, w, bias], cot)
    want = _grads(kf.fold_plain, [a, w, bias], cot)
    monkeypatch.setattr(jfold, "_INTERPRET", True)
    # JAX's fold: (B, Q, K) windows, a (K, N) weight
    _, vjp = jax.vjp(lambda p, w_, b_: jfold._fold(p, w_, b_, jnp.float32),
                     jnp.asarray(a[None]), jnp.asarray(w.T), jnp.asarray(bias))
    jda, jdw, jdb = vjp(jnp.asarray(cot[None]))
    for name, g, p, j in zip(("da", "dw", "dbias"), got, want,
                             (np.asarray(jda)[0], np.asarray(jdw).T, jdb)):
        _close(g, p, 1e-5, f"{name} plain")
        _close(g, j, 1e-5, f"{name} jax")


# ------------------------------------------------------------------- A
@pytest.mark.parametrize("coords_grad", [False, True])
def test_lookup_matches_plain(coords_grad):
    levels, coords = _pyramid(2, 8, 12)
    k = 4 * 81
    cot = RNG.randn(2, 8, 12, k).astype(np.float32)
    if coords_grad:
        fn = lambda c, *lv: kl.lookup(lv, c, 4)
        plain = lambda c, *lv: kl.lookup_plain(lv, c, 4)
        inputs = [coords, *levels]
    else:
        fn = lambda *lv: kl.lookup(lv, torch.from_numpy(coords), 4)
        plain = lambda *lv: kl.lookup_plain(lv, torch.from_numpy(coords), 4)
        inputs = levels
    for i, (g, p) in enumerate(zip(_grads(fn, inputs, cot), _grads(plain, inputs, cot))):
        _close(g, p, 1e-5, f"input {i}")


def test_lookup_matches_jax_vjp():
    """The levels' and the coordinates' gradients: against the JAX tent
    form in f32 and the XLA gather form at 1e-5, against the Pallas
    lookup's own VJP (bf16 tents) at 1e-2."""
    levels, coords = _pyramid(1, 8, 12)
    cot = RNG.randn(1, 8, 12, 4 * 81).astype(np.float32)
    got = _grads(lambda c, *lv: kl.lookup(lv, c, 4), [coords, *levels], cot)
    jl, jc, jg = tuple(map(jnp.asarray, levels)), jnp.asarray(coords), jnp.asarray(cot)

    def tent_f32(ls, c):
        return jnp.concatenate([_lookup_level_mxu(lv, c / 2.0 ** i, 4, jnp.float32)
                                for i, lv in enumerate(ls)], axis=-1)

    def gather(ls, c):
        return lookup_corr_pyramid(CorrPyramid(levels=ls, radius=4), c, impl="xla")

    for name, f, rel in (("tent f32", tent_f32, 1e-5), ("gather", gather, 1e-5),
                         ("pallas", lambda ls, c: lookup_corr_pyramid_pallas(ls, c, 4), 1e-2)):
        _, vjp = jax.vjp(f, jl, jc)
        dls, dc = vjp(jg)
        for i, (g, d) in enumerate(zip(got[1:], dls)):
            _close(g, d, rel, f"{name} level {i}")
        _close(got[0], dc, rel, f"{name} coords")


# ------------------------------------------------------------------- G
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lookup_fold_matches_plain(dtype):
    levels, coords = _pyramid(2, 8, 12)
    w = (RNG.randn(16, 4 * 81) * 0.05).astype(np.float32)
    bias = RNG.randn(16).astype(np.float32)
    cot = RNG.randn(2, 8, 12, 16).astype(np.float32)
    c = torch.from_numpy(coords)

    def run(fn):
        leaves = [torch.from_numpy(a).to(dtype).requires_grad_(True)
                  for a in (w, bias, *levels)]
        out = fn(leaves[2:], c, 4, leaves[0], leaves[1])
        return [g.float().numpy() for g in torch.autograd.grad(
            out, leaves, torch.from_numpy(cot).to(dtype))]

    got, want = run(klf.lookup_fold), run(klf.lookup_fold_plain)
    # bf16: both round the same f32 sums once, in other orders: one ulp
    rel = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    for name, g, p in zip(("dweight", "dbias", "level 0", "level 1", "level 2", "level 3"),
                          got, want):
        _close(g, p, rel, name)


def test_lookup_fold_is_lookup_then_fold():
    """G's VJP equals the lookup's and the fold's composed (the JAX
    trainer runs the two apart), also in the coordinates."""
    levels, coords = _pyramid(1, 8, 12)
    w = (RNG.randn(8, 4 * 81) * 0.05).astype(np.float32)
    bias = RNG.randn(8).astype(np.float32)
    cot = RNG.randn(1, 8, 12, 8).astype(np.float32)

    def apart(c, w_, b_, *lv):
        return kf.fold(kl.lookup(lv, c, 4).reshape(96, -1), w_, b_).reshape(1, 8, 12, -1)

    got = _grads(lambda c, w_, b_, *lv: klf.lookup_fold(lv, c, 4, w_, b_),
                 [coords, w, bias, *levels], cot)
    want = _grads(apart, [coords, w, bias, *levels], cot)
    for i, (g, p) in enumerate(zip(got, want)):
        _close(g, p, 1e-5, f"input {i}")


def test_functions_cost_nothing_under_inference_mode():
    """Under `torch.inference_mode` a Function's forward is the wrapper's:
    no graph, the same values."""
    levels, coords = _pyramid(1, 8, 12)
    lv = [torch.from_numpy(a) for a in levels]
    with torch.inference_mode():
        out = kl.lookup(lv, torch.from_numpy(coords), 4)
    assert out.grad_fn is None
    assert torch.equal(out, kl.lookup_plain(lv, torch.from_numpy(coords), 4))
