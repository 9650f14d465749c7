"""Batch norm in train mode, and the frozen batch norms of the later
stages, against the JAX package on the CPU, f32.

- The port's `Norm("batch")` in train mode against the JAX `Norm` with
  `use_running_average=False`: the output (normalised by the batch's f32
  statistics, the biased variance), the running averages after one step
  (momentum 0.1, the unbiased variance) and the gradients of the input and
  the affine parameters (`jax.vjp`), 1e-5 of each one's largest value.
- `FFRaft.freeze_bn()`: every batch norm in eval mode inside a training
  model, as JAX's `freeze_bn=True` (`config.py`: every stage but chairs):
  the train-mode forward normalises with the running statistics, leaves
  them as they are, and equals the JAX train-mode forward with
  `freeze_bn=True`.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from focusflow_official_tpu.models import FFRaft as JFFRaft
from focusflow_official_tpu.models import FFRaftConfig as JConfig
from focusflow_official_tpu.nn.norm import Norm as JNorm
from focusflow_official_tpu_torch.compat.weights import load_npz
from focusflow_official_tpu_torch.models import FFRaft, FFRaftConfig
from focusflow_official_tpu_torch.nn.norm import Norm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "trained_smoke.npz")
RNG = np.random.RandomState(21)


def _close(got, want, rel=1e-5, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    assert err <= rel * max(float(np.abs(want).max()), 1e-30), (what, err)


@pytest.mark.parametrize("relu", [False, True])
def test_batch_norm_train_mode_matches_jax(relu):
    b, h, w, c = 3, 7, 9, 16
    x = (RNG.randn(b, h, w, c) * 2 + 0.5).astype(np.float32)
    scale = (RNG.rand(c) + 0.5).astype(np.float32)
    bias = RNG.randn(c).astype(np.float32)
    mean0, var0 = RNG.randn(c).astype(np.float32), (RNG.rand(c) + 0.5).astype(np.float32)
    cot = RNG.randn(b, h, w, c).astype(np.float32)

    jn = JNorm("batch", c)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}

    def jax_fwd(x_, s_, b_):
        v = {"params": {"scale": s_, "bias": b_}, "batch_stats": variables["batch_stats"]}
        return jn.apply(v, x_, use_running_average=False, fuse_relu=relu,
                        mutable=["batch_stats"])

    (want, stats), vjp = jax.vjp(jax_fwd, jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    jdx, jds, jdb = vjp((jnp.asarray(cot), jax.tree.map(jnp.zeros_like, stats)))

    norm = Norm("batch", c).train()
    norm.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                          "running_mean": torch.from_numpy(mean0),
                          "running_var": torch.from_numpy(var0)})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)  # NCHW view
    out = norm(xt, relu=relu)
    dx, ds, db = torch.autograd.grad(out, (xt, norm.weight, norm.bias),
                                     torch.from_numpy(cot).permute(0, 3, 1, 2))
    _close(out.permute(0, 2, 3, 1).detach().numpy(), want, 1e-5, "output")
    _close(norm.running_mean.numpy(), stats["batch_stats"]["mean"], 1e-6, "running mean")
    _close(norm.running_var.numpy(), stats["batch_stats"]["var"], 1e-6, "running var")
    _close(dx.permute(0, 2, 3, 1).numpy(), jdx, 1e-5, "dx")
    _close(ds.numpy(), jds, 1e-5, "dscale")
    _close(db.numpy(), jdb, 1e-5, "dbias")


def test_batch_norm_eval_mode_keeps_running_stats():
    norm = Norm("batch", 8).eval()
    norm.running_mean.fill_(0.3)
    before = norm.state_dict()
    before = {k: v.clone() for k, v in before.items()}
    x = torch.randn(2, 8, 5, 6)
    y = norm(x)
    want = (x - 0.3) * torch.rsqrt(torch.tensor(1.0 + 1e-5))
    torch.testing.assert_close(y, want, rtol=1e-6, atol=1e-6)
    for k, v in norm.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_freeze_bn_matches_jax():
    """A training forward with frozen batch norms: the port's
    `model.train(); model.freeze_bn()` against JAX's `freeze_bn=True`
    train-mode forward, every iterate within 1e-4 px, and the running
    statistics untouched (the model is still in train mode)."""
    b, h, w, iters = 1, 64, 96, 2
    x = [(RNG.rand(b, h, w, 3) * 255).astype(np.float32) for _ in range(2)]
    m = [((RNG.rand(b, h, w, 1) > 0.97) * 255).astype(np.float32) for _ in range(2)]
    with np.load(FIXTURE) as raw:
        v = traverse_util.unflatten_dict(
            {tuple(k.split("/")): jnp.asarray(raw[k], jnp.float32) for k in raw.files})
    jm = JFFRaft(JConfig(fusion="parallel", fuse_cnet=True, iters=iters, corr_impl="xla",
                         freeze_bn=True))
    want, new = jax.jit(lambda v_, *a: jm.apply(v_, *a, iters=iters, train=True,
                                                mutable=["batch_stats"]))(
        v, *map(jnp.asarray, (x[0], x[1], m[0], m[1])))
    for a, e in zip(jax.tree.leaves(new), jax.tree.leaves(v["batch_stats"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(e))

    model = FFRaft(FFRaftConfig(fusion="parallel", fuse_cnet=True, iters=iters, freeze_bn=True))
    model.load_state_dict(load_npz(FIXTURE), strict=True)
    model.train().freeze_bn()
    assert model.training
    bns = [mod for mod in model.modules() if isinstance(mod, Norm) and mod.kind == "batch"]
    assert bns and not any(mod.training for mod in bns)
    before = {k: t.clone() for k, t in model.state_dict().items() if "running" in k}
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (x[0], x[1], m[0], m[1])))
    assert got.shape == want.shape == (iters, b, h, w, 2)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= 1e-4
    for k, t in before.items():
        assert torch.equal(model.state_dict()[k], t), k
