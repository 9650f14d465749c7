"""The port's FF-PWCNet train step against the JAX package's
`train/loop.py::make_train_step`, on the CPU, in f32: the trained fixture
(`tests/fixtures/trained_smoke_pwc.npz`), two samples of the multi-pixel
affine input (`data/synthetic.py`) at 64x128, the multiscale MixLoss of
`configs/smoke_pwc.yaml` ('pretrain' mode), AdamW with global clip 1.0
under OneCycle (4e-4 over 103 steps), no noise.

The JAX step is built on a `TrainState` of the fixture's variables (no
`model.init`, which takes a minute on the CPU) and compiled once; the JAX
train-mode forward once more. The first step's gradients are read from
the JAX step's Adam state: after one update, mu = (1 - b1) * the clipped
gradient.

Bounds:
- the train-mode forward: the five levels, finest first, within 1e-4 px
  of JAX's (f32 sums of up to 565 products in another order, through five
  levels of warps);
- the first step's loss and `epe` within 1e-5 relative;
- gradients: the cosine of the flat gradient >= 0.9999, and each tensor's
  within 3% of its norm plus 1e-6 of the largest gradient (the bound of
  FF-RAFT's step test, `test_torch_train_step.py`: f32 gradients through products summed in other orders; the
  1e-6 term covers tensors whose gradient is about zero, which f32 noise
  dominates). This network is far better conditioned than FF-RAFT (no
  norms, no gates): the port's gradients sit within 1e-5 of JAX's here.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from focusflow_official_tpu.losses import build_multiscale_loss as jax_loss
from focusflow_official_tpu.models import FFPWCNet as JFFPWCNet
from focusflow_official_tpu.models import FFRaftConfig as JConfig
from focusflow_official_tpu.train.loop import TrainState, make_train_step
from focusflow_official_tpu.train.loop import build_optimizer as jax_optimizer
from focusflow_official_tpu.train.schedule import one_cycle_lr
from focusflow_official_tpu_torch.compat.weights import load_npz, params_from_jax
from focusflow_official_tpu_torch.data.synthetic import chairs_layout
from focusflow_official_tpu_torch.losses import build_multiscale_loss
from focusflow_official_tpu_torch.models import FFPWCNet, FFPWCNetConfig
from focusflow_official_tpu_torch.train.loop import build_optimizer, train_step
from focusflow_official_tpu_torch.train.schedule import one_cycle

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "trained_smoke_pwc.npz")
B, H, W = 2, 64, 128
LR, TOTAL, WD, EPS, CLIP = 4e-4, 103, 1e-5, 1e-8, 1.0
KEYS = ("image1", "image2", "mask1", "mask2", "flow", "valid")
LOSS = dict(weights=[0.005, 0.01, 0.02, 0.08, 0.32], mode="pretrain", kernel_size=1,
            sigma=0.01, lamda=1.0)  # configs/smoke_pwc.yaml


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs its files in parallel worker
    processes, and torch's default of a thread a core in each of them
    oversubscribes the CPU many times over (these tests train on it)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _batch():
    ds = chairs_layout(0, n=B, h=H, w=W)
    return {k: np.stack([ds[i][k] for i in range(B)]).astype(np.float32) for k in KEYS}


def _jax_variables():
    with np.load(FIXTURE) as raw:
        return traverse_util.unflatten_dict(
            {tuple(k.split("/")): jnp.asarray(raw[k], jnp.float32) for k in raw.files})


def _jax_model():
    return JFFPWCNet(JConfig(fusion="parallel", fusion_type="1x1conv", corr_impl="xla"))


def _port_model():
    model = FFPWCNet(FFPWCNetConfig())
    model.load_state_dict(load_npz(FIXTURE), strict=True)
    return model.train()


@pytest.fixture(scope="module")
def runs():
    """The first step of each package -> ((JAX metrics, JAX clipped
    gradients by port name), (port metrics, port clipped gradients))."""
    v = _jax_variables()
    tx = jax_optimizer(one_cycle_lr(LR, TOTAL), weight_decay=WD, epsilon=EPS, clip=CLIP)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"], batch_stats={},
                       opt_state=tx.init(v["params"]), apply_fn=_jax_model().apply, tx=tx)
    step = make_train_step(jax_loss("MixLoss", **LOSS), iters=1, add_noise=False)
    state, m = step(state, {k: jnp.asarray(a) for k, a in _batch().items()},
                    jax.random.PRNGKey(0))
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    jg = params_from_jax({"params/" + "/".join(k): np.asarray(a) / 0.1
                          for k, a in traverse_util.flatten_dict(adam.mu).items()})
    jm = {k: float(x) for k, x in m.items()}

    model = _port_model()
    opt = build_optimizer(model, LR, weight_decay=WD, epsilon=EPS)
    tm = train_step(model, opt, one_cycle(opt, TOTAL), build_multiscale_loss("MixLoss", **LOSS),
                    {k: torch.from_numpy(a) for k, a in _batch().items()}, iters=None, clip=CLIP)
    tg = {n: p.grad.clone() for n, p in model.named_parameters()}
    return (jm, jg), ({k: float(x) for k, x in tm.items()}, tg)


def test_train_forward_levels_match_jax():
    batch = _batch()
    want = jax.jit(lambda v_, *a: _jax_model().apply(v_, *a, train=True))(
        _jax_variables(), *(jnp.asarray(batch[k]) for k in KEYS[:4]))
    with torch.no_grad():
        got = _port_model()(*(torch.from_numpy(batch[k]) for k in KEYS[:4]))
    assert isinstance(got, list) and len(got) == len(want) == 5
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        assert a.shape[1:3] == (H // 4 >> i, W // 4 >> i)
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= 1e-4, i


def test_first_step_loss_and_metrics(runs):
    (jm, _), (tm, _) = runs
    assert set(tm) == set(jm) == {"loss", "epe", "grad_norm"}
    for k in ("loss", "epe"):
        assert abs(tm[k] - jm[k]) <= 1e-5 * abs(jm[k]), (k, tm[k], jm[k])
    assert abs(tm["grad_norm"] - jm["grad_norm"]) <= 1e-4 * jm["grad_norm"]


def test_first_step_gradients(runs):
    (_, jg), (_, tg) = runs
    assert set(tg) == set(jg)
    flat_t = torch.cat([tg[n].flatten() for n in sorted(tg)]).double()
    flat_j = torch.cat([jg[n].flatten() for n in sorted(tg)]).double()
    assert float(torch.nn.functional.cosine_similarity(flat_t, flat_j, dim=0)) >= 0.9999
    top = float(flat_j.abs().max())
    for n in tg:
        err = float((tg[n] - jg[n]).norm())
        assert err <= 3e-2 * float(jg[n].norm()) + 1e-6 * top, n
