"""ALT_CORR (MODEL.ALT_CORR: the lookup without the all-pairs volume,
`ops/corr.py::AltCorr`) in the port, in f32 on the CPU:

- `alternate_corr_fold` (each chunk's product, pyramid and G's plain
  version) against G on the materialized pyramid of the same feature
  maps, at radius 3 and 4, B = 1 and 2, and chunks of every query, of a
  divisor of Q and of a size that leaves a tail (as the JAX package's
  `tests/test_corr.py::test_alternate_matches_materialized`): within 1e-5
  of the largest output;
- FF-RAFT with ALT_CORR against the same model materialized, on the
  trained fixture (`tests/fixtures/trained_smoke.npz`) at 64x96, 3
  refinements, the same chunk sizes: flows within 1e-5 x max(1, max
  |flow|); and through `FlowPredictor`;
- FF-RAFT and FF-RAFT-S with ALT_CORR against the JAX package's ALT_CORR
  model (`corr_impl="xla"`), on JAX's variable tree (`jax.eval_shape` of
  its `init`) with seeded values, 2 refinements, a chunk that leaves a
  tail, by the bounds of `tests/test_torch_raft_variants.py`: the port's
  flows within 1e-4 x max(1, max |flow|) of its own run in f64, JAX's
  within 1e-3 x that. (On these weights JAX's f32 flows, ALT_CORR or
  materialized alike, sit 4.2e-4 and 3.6e-3 px from the f64 run, at 12
  and 24 px flows; the port's 2.2e-5 and 6.3e-5.)
"""

import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from focusflow_official_tpu.models import FFRaft as JFFRaft
from focusflow_official_tpu.models import FFRaftConfig as JConfig
from focusflow_official_tpu_torch.compat.weights import load_npz, params_from_jax
from focusflow_official_tpu_torch.kernels.lookup_fold import lookup_fold
from focusflow_official_tpu_torch.models import FFRaft, FFRaftConfig
from focusflow_official_tpu_torch.ops.corr import (AltCorr, all_pairs_corr,
                                                   alternate_corr_fold, corr_pyramid)
from focusflow_official_tpu_torch.predict import FlowPredictor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "trained_smoke.npz")
RNG = np.random.RandomState(142)
H, W = 64, 96
Q = (H // 8) * (W // 8)  # 96 queries
CHUNKS = (Q, 32, 40)  # one chunk; a divisor; 2 chunks and a tail of 16
MAIN = dict(fusion="parallel", fusion_type="1x1conv", fuse_cnet=True)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True, scope="module")
def _reference_layout():
    with pytest.MonkeyPatch.context() as mp:
        for knob in ("FF_CHUNKED_FNET", "FF_PACKED_CCE", "FF_PACKED_CCE_BN",
                     "FF_PACKED_STEM"):
            mp.setenv(knob, "0")
        yield


@pytest.mark.parametrize("b,radius", [(1, 4), (2, 4), (2, 3)])
@pytest.mark.parametrize("chunk", CHUNKS + (1,))
def test_alternate_corr_fold_matches_materialized(b, radius, chunk):
    h1, w1, c = 8, 12, 64
    f1, f2 = (torch.from_numpy(RNG.randn(b, h1, w1, c).astype(np.float32)) for _ in "ab")
    grid = np.stack(np.meshgrid(np.arange(w1), np.arange(h1)), -1)[None]
    coords = torch.from_numpy((grid + RNG.randn(b, h1, w1, 2) * 3).astype(np.float32))
    k = 4 * (2 * radius + 1) ** 2
    w = torch.from_numpy((RNG.randn(32, k) / np.sqrt(k)).astype(np.float32))
    bias = torch.from_numpy(RNG.randn(32).astype(np.float32) * 0.1)
    got = alternate_corr_fold(AltCorr(f1, f2, 4, chunk), coords, radius, w, bias)
    want = lookup_fold(corr_pyramid(all_pairs_corr(f1, f2), 4), coords, radius, w, bias)
    assert got.shape == want.shape == (b, h1, w1, 32)
    assert float((got - want).abs().max()) <= 1e-5 * max(1.0, float(want.abs().max()))


def _shift_inputs(b=1):
    i1 = (RNG.rand(b, H, W, 3) * 255).astype(np.float32)
    i2 = np.roll(np.roll(i1, -2, 1), 3, 2)
    m1 = ((RNG.rand(b, H, W, 1) > 0.97) * 255).astype(np.float32)
    m2 = ((RNG.rand(b, H, W, 1) > 0.97) * 255).astype(np.float32)
    return i1, i2, m1, m2


def _flows_close(got, want, rel):
    for ours, theirs in zip(got, want):
        theirs = np.asarray(theirs)
        assert ours.shape == theirs.shape
        err = float(np.abs(ours.numpy() - theirs).max())
        assert err <= rel * max(1.0, float(np.abs(theirs).max())), err


@pytest.mark.parametrize("chunk", CHUNKS)
def test_alt_corr_model_matches_materialized(chunk):
    sd = load_npz(FIXTURE)
    models = []
    for alt in (False, True):
        m = FFRaft(FFRaftConfig(iters=3, alt_corr=alt, alt_corr_chunk=chunk, **MAIN))
        m.load_state_dict(sd, strict=True)
        models.append(m.eval())
    inputs = [torch.from_numpy(a) for a in _shift_inputs(2)]
    with torch.no_grad():
        want, got = (m(*inputs) for m in models)
    _flows_close(got, want, 1e-5)


def test_alt_corr_predictor_matches_materialized():
    """`FlowPredictor` on the CPU with ALT_CORR: the padded frame (60x92 ->
    64x96) through the chunked lookup, as the materialized predictor."""
    i1, i2, m1, m2 = (a[0, :60, :92] for a in _shift_inputs())
    flows = [FlowPredictor(FFRaftConfig(iters=3, alt_corr=alt, alt_corr_chunk=40, **MAIN),
                           FIXTURE, device="cpu", dtype=torch.float32)(i1, i2, m1, m2)
             for alt in (False, True)]
    assert flows[0].shape == (60, 92, 2)
    assert float(np.abs(flows[1] - flows[0]).max()) <= 1e-5 * max(
        1.0, float(np.abs(flows[0]).max()))


def _drawn(tree):
    """Seeded values on JAX's variable tree: kernels N(0, 1/fan_in),
    biases N(0, 0.01^2), norm scales U(0.5, 1.5), batch means N(0, 0.09),
    variances U(0.5, 2)."""
    flat = {}
    for k, leaf in traverse_util.flatten_dict(tree, sep="/").items():
        if k.endswith("/kernel"):
            a = RNG.randn(*leaf.shape) / np.sqrt(int(np.prod(leaf.shape[:-1])))
        elif k.startswith("batch_stats") and k.endswith("/mean"):
            a = RNG.randn(*leaf.shape) * 0.3
        elif k.startswith("batch_stats"):
            a = RNG.uniform(0.5, 2.0, leaf.shape)
        elif k.endswith("/scale"):
            a = RNG.uniform(0.5, 1.5, leaf.shape)
        else:
            a = RNG.randn(*leaf.shape) * 0.01
        flat[k] = a.astype(np.float32)
    return flat


@pytest.mark.parametrize("small", [False, True])
def test_alt_corr_matches_jax(small):
    kw = dict(MAIN, small=small, iters=2, alt_corr=True, alt_corr_chunk=40)
    jmodel = JFFRaft(JConfig(corr_impl="xla", **kw))
    x, m = jnp.zeros((1, H, W, 3)), jnp.zeros((1, H, W, 1))
    flat = _drawn(jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), x, x, m, m,
                                                     iters=1, test_mode=True)))
    tmodel = FFRaft(FFRaftConfig(**kw))
    tmodel.load_state_dict(params_from_jax(flat), strict=True)
    inputs = _shift_inputs(2)
    variables = traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(a)
                                              for k, a in flat.items()})
    want = jax.jit(lambda v, *a: jmodel.apply(v, *a, iters=2, test_mode=True))(
        variables, *map(jnp.asarray, inputs))
    with torch.no_grad():
        got = tmodel.eval()(*map(torch.from_numpy, inputs))
    ref = _f64_flows(tmodel, inputs)
    _flows_close(got, ref, 1e-4)
    _flows_close([torch.from_numpy(np.array(a)) for a in want], ref, 1e-3)


def _f64_flows(model, inputs):
    """The port's test-mode flows of `model` computed in f64 (where its
    plain ops allow: the instance norms take f32 statistics, the
    correlation's operands f32)."""
    import focusflow_official_tpu_torch.models.ff_raft as ff_raft

    saved = ff_raft.DTYPES["float32"]
    ff_raft.DTYPES["float32"] = torch.float64
    try:
        with torch.no_grad():
            flows = copy.deepcopy(model).double()(
                *(torch.from_numpy(a).double() for a in inputs))
    finally:
        ff_raft.DTYPES["float32"] = saved
    return [f.numpy() for f in flows]
