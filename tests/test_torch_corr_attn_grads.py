"""The backwards of kernels D (local correlation), E (small-kv attention)
and F (7x7 window attention) against the JAX package's VJPs, called
directly on the same numpy inputs:

- D: `ops/pallas_local_corr.py::_bwd` (the VJP of the plain correlation),
  and for the decoder's leaky-ReLU form the VJP of leaky_relu after it;
- E: `kernels/attention.py::_attention_bwd`;
- F: `kernels/window_attention.py::_attention_bwd`.

On the CPU each wrapper's forward is its plain version, and its backward
is the plain PyTorch VJP that the card runs too, so these tests hold the
card's backward. Bounds: f32, 1e-5 of the largest gradient (f32 sums in
another order); bf16, one bf16 ulp of the largest gradient (each side
computes in f32 and rounds once). JAX's local-correlation VJP runs in the
maps' type, so in bf16 it sums the 81 shifts' terms in bf16 (0.12 off the
f32 VJP on these inputs, 30 bf16 ulps); the port's runs in f32, so in bf16
JAX's is given the same bf16 values in f32 and its result rounded once.
Each is also held to autograd through its plain version, and
E's chunked backward to its one-chunk form.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focusflow_official_tpu.kernels import attention as jattn
from focusflow_official_tpu.kernels import window_attention as jwin
from focusflow_official_tpu.ops import pallas_local_corr as jlc
from focusflow_official_tpu.ops.local_corr import local_corr as jax_local_corr
from focusflow_official_tpu_torch.kernels import attention as ka
from focusflow_official_tpu_torch.kernels import local_corr as klc
from focusflow_official_tpu_torch.kernels import window_attention as kw

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs its files in parallel worker
    processes, and torch's default of a thread a core in each of them
    oversubscribes the CPU many times over."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _arrays(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _tol(want: np.ndarray, dtype: str) -> float:
    top = float(np.abs(want).max())
    return (1e-5 * max(1.0, top) if dtype == "float32"
            else 2.0 ** (np.floor(np.log2(max(top, 1e-30))) - 7))


def _hold(got, want, dtype: str, what: str) -> None:
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.float().numpy()
        b = np.asarray(jnp.asarray(b, jnp.float32)) if not isinstance(b, torch.Tensor) \
            else b.float().numpy()
        assert a.shape == b.shape, (what, i)
        err = float(np.abs(a - b).max())
        assert err <= _tol(b, dtype), (what, i, err, _tol(b, dtype))


def _port_grads(fn, inputs, g):
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    assert out.grad_fn is not None
    return torch.autograd.grad(out, leaves, g)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("slope", [None, 0.1])
def test_local_corr_backward_matches_jax(dtype, slope):
    tdt, jdt = DTYPES[dtype]
    r = 4
    f1, f2, g = _arrays(0, (2, 7, 11, 24), (2, 7, 11, 24), (2, 7, 11, 81))
    t1, t2 = (torch.from_numpy(a).to(tdt) for a in (f1, f2))
    # the bf16 values, in f32 for JAX's VJP (see the module's docstring)
    j1, j2, jg = (jnp.asarray(a, jdt).astype(jnp.float32) for a in (f1, f2, g))
    tg = torch.from_numpy(g).to(tdt)
    got = _port_grads(lambda a, b: klc.local_corr(a, b, r, negative_slope=slope), [t1, t2], tg)
    assert [x.dtype for x in got] == [tdt, tdt]
    if slope is None:
        want = jlc._bwd(r, (j1, j2), jg)
    else:
        _, vjp = jax.vjp(lambda a, b: jax.nn.leaky_relu(jax_local_corr(a, b, r), slope), j1, j2)
        want = vjp(jg)
    _hold(got, [w.astype(jdt) for w in want], dtype, "local_corr vs JAX")
    plain = _port_grads(lambda a, b: klc.local_corr_plain(a, b, r, slope), [t1, t2], tg)
    _hold(got, plain, dtype, "local_corr vs autograd")


def test_local_corr_backward_takes_a_strided_cotangent():
    f1, f2, g = _arrays(1, (1, 5, 6, 8), (1, 5, 6, 8), (1, 81, 5, 6))
    t1, t2 = torch.from_numpy(f1), torch.from_numpy(f2)
    tg = torch.from_numpy(g).permute(0, 2, 3, 1)  # (B, H, W, 81), not contiguous
    got = _port_grads(lambda a, b: klc.local_corr(a, b, 4), [t1, t2], tg)
    want = _port_grads(lambda a, b: klc.local_corr_plain(a, b, 4), [t1, t2], tg.contiguous())
    _hold(got, want, "float32", "strided cotangent")


# (b, n, m, c, cv, heads): the decoder's one query, the perceiver's latent
# tokens, a GSA with more queries than keys, and unequal value width
ATTENTION_SHAPES = [(6, 1, 8, 64, 64, 8), (3, 8, 12, 128, 128, 8), (2, 70, 20, 64, 64, 4),
                    (2, 9, 5, 32, 64, 4)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ATTENTION_SHAPES)
def test_attention_backward_matches_jax(shape, dtype):
    b, n, m, c, cv, heads = shape
    tdt, jdt = DTYPES[dtype]
    scale = (c // heads) ** -0.5
    q, k, v, g = _arrays(2, (b, n, c), (b, m, c), (b, m, cv), (b, n, cv))
    tq, tk, tv, tg = (torch.from_numpy(a).to(tdt) for a in (q, k, v, g))
    got = _port_grads(lambda *t: ka.small_kv_attention(*t, heads, scale), [tq, tk, tv], tg)
    assert [x.dtype for x in got] == [tdt] * 3
    if c == cv:  # JAX's backward takes one head width for q, k and v
        want = jattn._attention_bwd(heads, scale, tuple(jnp.asarray(a, jdt) for a in (q, k, v)),
                                    jnp.asarray(g, jdt))
        _hold(got, want, dtype, "attention vs JAX")
    plain = _port_grads(lambda *t: ka.small_kv_attention_plain(*t, heads, scale),
                        [tq, tk, tv], tg)
    _hold(got, plain, dtype, "attention vs autograd")


def test_attention_backward_in_chunks_equals_one_chunk(monkeypatch):
    """A P budget of one batch entry's worth cuts the backward into five
    chunks: the same gradients to the bit."""
    b, n, m, c, heads = 5, 40, 16, 64, 8
    q, k, v, g = (torch.from_numpy(a) for a in _arrays(3, (b, n, c), (b, m, c), (b, m, c),
                                                     (b, n, c)))
    whole = ka.attention_vjp(q, k, v, heads, 0.3, g)
    monkeypatch.setattr(ka, "VJP_CHUNK_BYTES", heads * n * m * 4)
    chunked = ka.attention_vjp(q, k, v, heads, 0.3, g)
    for a, w in zip(chunked, whole):
        assert torch.equal(a, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 14, 21, 64, 4), (1, 7, 28, 128, 8)])
def test_window_attention_backward_matches_jax(shape, dtype):
    b, hp, wp, c, heads = shape
    tdt, jdt = DTYPES[dtype]
    scale = (c // heads) ** -0.5
    q, k, v, g = _arrays(4, *[(b, hp, wp, c)] * 4)
    tq, tk, tv, tg = (torch.from_numpy(a).to(tdt) for a in (q, k, v, g))
    got = _port_grads(lambda *t: kw.window_attention(*t, 7, heads, scale), [tq, tk, tv], tg)
    assert [x.dtype for x in got] == [tdt] * 3
    want = jwin._attention_bwd(7, heads, scale, tuple(jnp.asarray(a, jdt) for a in (q, k, v)),
                               jnp.asarray(g, jdt))
    _hold(got, want, dtype, "window attention vs JAX")
    plain = _port_grads(lambda *t: kw.window_attention_plain(*t, 7, heads, scale),
                        [tq, tk, tv], tg)
    _hold(got, plain, dtype, "window attention vs autograd")


def test_window_attention_q_and_k_of_one_tensor():
    """The vertical local layer's call: q and k projected from one tensor,
    v from another; each input's gradient reaches its own tensor."""
    x, y, wq, wk, g = _arrays(5, (1, 7, 14, 32), (1, 7, 14, 32), (32, 32), (32, 32),
                              (1, 7, 14, 32))
    x, y, wq, wk, g = map(torch.from_numpy, (x, y, wq, wk, g))

    def run(attend):
        xs, ys = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
        out = attend(xs @ wq, xs @ wk, ys, 7, 4, 0.35)
        return torch.autograd.grad(out, (xs, ys), g)

    _hold(run(kw.window_attention), run(kw.window_attention_plain), "float32", "q, k of x")
