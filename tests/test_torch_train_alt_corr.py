"""Training with ALT_CORR (`ops/corr.py::alternate_corr_fold`: the chunk walk
as one autograd Function whose backward walks the chunks again), in f32 on
the CPU at 64x96 (96 queries), 2 refinements, chunks of 40 queries (two
and a tail of 16):

- the port's train step against the JAX package's `make_train_step` with
  ALT_CORR (its `lax.scan` over `lookup_corr_fused_chunks`, the same
  function as pooling then lookup), at full width on the trained fixture
  (`tests/fixtures/trained_smoke.npz`, the main path's config) and small
  (FF-RAFT-S on `variant_weights`), with the bounds of
  `tests/test_torch_train_step.py` (the harness of
  `test_torch_train_raft_variants.py`); bf16 at full width: the loss
  within 2%;
- the port's ALT_CORR step against its own materialized step on the same
  weights and batch: the loss within 1e-6 relative and each gradient
  within 1e-5 of its tensor's largest (a gradient that is zero but for
  rounding, the biases in front of an instance norm, whose shift the norm
  takes out, has no largest to be relative to: at most 1e-7 of the model's
  largest gradient, it is held to 1e-7 of that, as
  `test_torch_distributed.py` holds such tensors);
- `alternate_corr_fold` under `torch.autograd.graph.saved_tensors_hooks`:
  what autograd keeps is fmap1, fmap2, the coordinates and the weight (at
  most their bytes and the bias's), the same at chunks of 40 and of 8, and
  its gradients equal autograd's through the materialized pyramid (1e-5 of
  each one's largest).
"""

import numpy as np
import pytest
import torch

from focusflow_official_tpu_torch.compat.weights import load_npz
from focusflow_official_tpu_torch.kernels.lookup_fold import lookup_fold
from focusflow_official_tpu_torch.ops.corr import (AltCorr, all_pairs_corr,
                                                   alternate_corr_fold, corr_pyramid)
from test_torch_train_raft_variants import (FIXTURE, ITERS, STEPS, hold_first_step,
                                            hold_steps, hold_train_forward, jax_run,
                                            port_run, variant_weights)
from test_torch_train_raft_variants import _two_threads  # noqa: F401  (autouse fixtures)

CHUNK = 40
ZERO = 1e-7  # a gradient this far under the model's largest is rounding
MAIN = dict(fusion="parallel", fuse_cnet=True)
CASES = {"full": dict(MAIN, alt_corr=True, alt_corr_chunk=CHUNK),
         "small": dict(MAIN, small=True, alt_corr=True, alt_corr_chunk=CHUNK)}
RNG = np.random.RandomState(160)


def _weights(name: str) -> dict:
    return load_npz(FIXTURE) if name == "full" else variant_weights(CASES[name])


@pytest.fixture(scope="module")
def runs():
    out = {}
    for name, kw in CASES.items():
        sd = _weights(name)
        out[name] = (jax_run(kw, sd, STEPS), port_run(kw, sd, STEPS))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_alt_corr_train_forward_matches_jax(name):
    hold_train_forward(CASES[name], _weights(name))


@pytest.mark.parametrize("name", sorted(CASES))
def test_alt_corr_first_step_matches_jax(runs, name):
    (jm, jg, _), (tm, tg, _, _) = runs[name]
    hold_first_step(tm, tg, jm, jg)


@pytest.mark.parametrize("name", sorted(CASES))
def test_alt_corr_three_steps_match_jax(runs, name):
    (jm, _, jps), (tm, _, tps, lr_seen) = runs[name]
    hold_steps(tm, tps, jm, jps, lr_seen)


def test_alt_corr_bf16_loss_within_two_percent_of_jax():
    kw, sd = CASES["full"], _weights("full")
    jm, _, _ = jax_run(kw, sd, 1, dtype="bfloat16")
    tm, tg, _, _ = port_run(kw, sd, 1, dtype="bfloat16")
    assert abs(tm[0]["loss"] - jm[0]["loss"]) <= 0.02 * abs(jm[0]["loss"])
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in tg.values())


@pytest.mark.parametrize("name", sorted(CASES))
def test_alt_corr_step_matches_materialized(runs, name):
    """The same step without ALT_CORR: the loss within 1e-6 and each
    gradient within 1e-5 of its tensor's largest (within `ZERO` x the
    model's largest for a gradient of rounding alone)."""
    _, (tm, tg, _, _) = runs[name]
    kw = {k: v for k, v in CASES[name].items() if not k.startswith("alt_corr")}
    mm, mg, _, _ = port_run(kw, _weights(name), 1)
    assert abs(tm[0]["loss"] - mm[0]["loss"]) <= 1e-6 * abs(mm[0]["loss"])
    assert set(tg) == set(mg)
    top = max(float(g.abs().max()) for g in mg.values())
    for n, want in mg.items():
        err = float((tg[n] - want).abs().max())
        own = float(want.abs().max())
        assert err <= (ZERO * top if own <= ZERO * top else 1e-5 * own), (n, err, own)


def _fold_inputs(b=2, h1=8, w1=12, c=64, radius=4, n_out=32):
    f1, f2 = (torch.from_numpy(RNG.randn(b, h1, w1, c).astype(np.float32)).requires_grad_()
              for _ in "ab")
    grid = np.stack(np.meshgrid(np.arange(w1), np.arange(h1)), -1)[None]
    coords = torch.from_numpy((grid + RNG.randn(b, h1, w1, 2) * 3).astype(np.float32))
    k = 4 * (2 * radius + 1) ** 2
    w = torch.from_numpy((RNG.randn(n_out, k) / np.sqrt(k)).astype(np.float32)).requires_grad_()
    bias = torch.from_numpy(RNG.randn(n_out).astype(np.float32) * 0.1).requires_grad_()
    g = torch.from_numpy(RNG.randn(b, h1, w1, n_out).astype(np.float32))
    return f1, f2, coords, w, bias, g


def test_alt_corr_saves_no_chunk_tensor():
    """Autograd keeps fmap1, fmap2, the coordinates and the weight, whatever
    the chunk: the saved bytes are at most theirs and the bias's, and the
    same at chunks of 40 and 8; the gradients equal autograd's through the
    materialized pyramid."""
    f1, f2, coords, w, bias, g = _fold_inputs()
    limit = sum(t.numel() * t.element_size() for t in (f1, f2, coords, w, bias))
    saved, grads = {}, {}
    for chunk in (40, 8):
        seen = []

        def pack(t):
            seen.append(t.numel() * t.element_size())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = alternate_corr_fold(AltCorr(f1, f2, 4, chunk), coords, 4, w, bias)
        saved[chunk] = sum(seen)
        grads[chunk] = torch.autograd.grad(out, (f1, f2, w, bias), g)
    assert 0 < saved[40] == saved[8] <= limit
    want = torch.autograd.grad(
        lookup_fold(corr_pyramid(all_pairs_corr(f1, f2), 4), coords, 4, w, bias),
        (f1, f2, w, bias), g)
    for chunk in (40, 8):
        for got, ref in zip(grads[chunk], want):
            assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
