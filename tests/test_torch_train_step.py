"""The port's FF-RAFT train step against the JAX package's
`train/loop.py::make_train_step`, on the CPU: the trained fixture
(`tests/fixtures/trained_smoke.npz`), two samples of the multi-pixel affine
input (`data/synthetic.py`) at 64x96, 2 refinements, MixLoss, AdamW with
global clip 1.0 under OneCycle (4e-4 over 103 steps), no noise.

The JAX step is compiled twice, in f32 and in bf16 (module fixtures); the
train-mode forward once more. The first step's gradients are read from the
JAX step's Adam state: after one update, mu = (1 - b1) * the clipped
gradient.

Bounds, f32:
- every train-mode iterate within 1e-4 px, the loss within 1e-5 relative;
- gradients: the cosine of the flat gradient >= 0.9999, and each tensor's
  within 3% of its norm. The 1e-4 of each tensor's max that a
  well-conditioned product would meet does not hold for this network in
  f32 in either package: against the port's run in f64 (`_f64_grads`,
  which computes the model in f64 where its plain ops allow), the JAX f32
  gradients of the GRU and the encoders are off by up to 2% of their norm,
  through saturated gates and the norms' cancellations, and the port's f32
  ones by no more than the JAX ones (`test_first_step_gradients_no_worse_than_jax`:
  at most 0.4 of JAX's error on this input);
- after three steps: each step's loss within 1e-4; the parameters within
  2 x the summed lr of JAX's everywhere (Adam moves a parameter by about
  lr a step, and by a sign where a gradient is near zero) and within 10%
  of that sum on average; batch statistics within 1e-4 of their scale (the second and
  third steps' statistics come from parameters that differ by that much).
bf16: the loss within 2% of JAX's bf16 step.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import traverse_util

from focusflow_official_tpu.losses import build_sequence_loss as jax_loss
from focusflow_official_tpu.models import FFRaft as JFFRaft
from focusflow_official_tpu.models import FFRaftConfig as JConfig
from focusflow_official_tpu.train.loop import build_optimizer as jax_optimizer
from focusflow_official_tpu.train.loop import create_train_state, make_train_step
from focusflow_official_tpu.train.schedule import one_cycle_lr
from focusflow_official_tpu_torch.compat.weights import load_npz, params_from_jax
from focusflow_official_tpu_torch.data.synthetic import chairs_layout
from focusflow_official_tpu_torch.losses import build_sequence_loss
from focusflow_official_tpu_torch.models import FFRaft, FFRaftConfig
from focusflow_official_tpu_torch.train.loop import build_optimizer, train_step
from focusflow_official_tpu_torch.train.schedule import one_cycle

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "trained_smoke.npz")
B, H, W, ITERS, STEPS = 2, 64, 96, 2, 3
LR, TOTAL, WD, EPS, CLIP = 4e-4, 103, 1e-5, 1e-8, 1.0
KEYS = ("image1", "image2", "mask1", "mask2", "flow", "valid")


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


def _flat(tree, coll):
    return {f"{coll}/" + "/".join(k): np.asarray(v)
            for k, v in traverse_util.flatten_dict(tree).items()}


def _jax_variables():
    with np.load(FIXTURE) as raw:
        return traverse_util.unflatten_dict(
            {tuple(k.split("/")): jnp.asarray(raw[k], jnp.float32) for k in raw.files})


def _lrs(n):
    return [float(one_cycle_lr(LR, TOTAL)(t)) for t in range(n)]


def _jax_run(dtype: str, steps: int):
    """JAX's make_train_step from the fixture -> (metrics a step, the first
    step's clipped gradients by port name (Adam's mu is then 0.1 of them),
    the port-named parameters and batch statistics after `steps`)."""
    v = _jax_variables()
    model = JFFRaft(JConfig(fusion="parallel", fuse_cnet=True, iters=ITERS,
                            compute_dtype=dtype, corr_impl="xla"))
    batch = {k: jnp.asarray(a) for k, a in _batch().items()}
    tx = jax_optimizer(one_cycle_lr(LR, TOTAL), weight_decay=WD, epsilon=EPS, clip=CLIP)
    state = create_train_state(model, jax.random.PRNGKey(0), batch, tx)
    state = state.replace(params=v["params"], batch_stats=v["batch_stats"],
                          opt_state=tx.init(v["params"]))
    step = make_train_step(jax_loss("MixLoss"), iters=ITERS, add_noise=False)
    metrics, grads = [], None
    for i in range(steps):
        state, m = step(state, batch, jax.random.PRNGKey(i))
        metrics.append({k: float(x) for k, x in m.items()})
        if i == 0:
            (adam,) = [s for s in jax.tree_util.tree_leaves(
                state.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
                if isinstance(s, optax.ScaleByAdamState)]
            grads = params_from_jax({k: a / 0.1 for k, a in _flat(adam.mu, "params").items()})
    after = params_from_jax({**_flat(state.params, "params"),
                             **_flat(state.batch_stats, "batch_stats")})
    return metrics, grads, after


def _port_model(dtype="float32"):
    model = FFRaft(FFRaftConfig(fusion="parallel", fuse_cnet=True, iters=ITERS,
                                compute_dtype=dtype))
    model.load_state_dict(load_npz(FIXTURE), strict=True)
    return model.train()


def _port_run(dtype: str, steps: int):
    model = _port_model(dtype)
    opt = build_optimizer(model, LR, weight_decay=WD, epsilon=EPS)
    sched = one_cycle(opt, TOTAL)
    batch = {k: torch.from_numpy(a) for k, a in _batch().items()}
    metrics, grads, lrs = [], None, []
    for i in range(steps):
        lrs.append(opt.param_groups[0]["lr"])
        m = train_step(model, opt, sched, build_sequence_loss("MixLoss"), batch, iters=ITERS,
                       dtype={"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype],
                       clip=CLIP)
        metrics.append({k: float(x) for k, x in m.items()})
        if i == 0:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return metrics, grads, model.state_dict(), lrs


@pytest.fixture(scope="module")
def f32_runs():
    return _jax_run("float32", STEPS), _port_run("float32", STEPS)


def test_train_forward_every_iterate_matches_jax():
    v = _jax_variables()
    batch = _batch()
    jm = JFFRaft(JConfig(fusion="parallel", fuse_cnet=True, iters=ITERS, corr_impl="xla"))
    fwd = jax.jit(lambda v_, *a: jm.apply(v_, *a, iters=ITERS, train=True,
                                          mutable=["batch_stats"]))
    want, new_stats = fwd(v, *(jnp.asarray(batch[k]) for k in KEYS[:4]))
    model = _port_model()
    with torch.no_grad():
        got = model(*(torch.from_numpy(batch[k]) for k in KEYS[:4]))
    assert got.shape == want.shape == (ITERS, B, H, W, 2)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= 1e-4
    # the cnet's batch norms took the batch's statistics, as flax's did
    stats = params_from_jax(_flat(new_stats["batch_stats"], "batch_stats"))
    sd = model.state_dict()
    for name, want_stat in stats.items():
        scale = max(1.0, float(want_stat.abs().max()))
        assert float((sd[name] - want_stat).abs().max()) <= 1e-5 * scale, name


def test_first_step_loss_and_gradients(f32_runs):
    (jm, jg, _), (tm, tg, _, _) = f32_runs
    assert abs(tm[0]["loss"] - jm[0]["loss"]) <= 1e-5 * abs(jm[0]["loss"])
    assert abs(tm[0]["epe"] - jm[0]["epe"]) <= 1e-5 * abs(jm[0]["epe"])
    assert abs(tm[0]["grad_norm"] - jm[0]["grad_norm"]) <= 1e-2 * jm[0]["grad_norm"]
    assert set(tg) == set(jg)
    flat_t = torch.cat([tg[n].flatten() for n in sorted(tg)])
    flat_j = torch.cat([jg[n].flatten() for n in sorted(tg)])
    assert float(torch.nn.functional.cosine_similarity(flat_t, flat_j, dim=0)) >= 0.9999
    top = float(flat_j.abs().max())
    for n in tg:
        err = float((tg[n] - jg[n]).norm())
        assert err <= 3e-2 * float(jg[n].norm()) + 1e-6 * top, n


def _f64_grads():
    """The port's first-step loss gradient with the model computed in f64
    (the kernels' plain versions and VJPs keep their f32 parts), clipped
    as the step clips."""
    import focusflow_official_tpu_torch.models.ff_raft as ff_raft

    saved = ff_raft.DTYPES["float32"]
    ff_raft.DTYPES["float32"] = torch.float64
    try:
        model = _port_model().double()
        batch = {k: torch.from_numpy(a).double() for k, a in _batch().items()}
        flows = model(*(batch[k] for k in KEYS[:4]), iters=ITERS)
        loss, _ = build_sequence_loss("MixLoss")(flows, batch["flow"], batch["valid"],
                                                 batch["mask1"])
        loss.backward()
    finally:
        ff_raft.DTYPES["float32"] = saved
    grads = {n: p.grad for n, p in model.named_parameters()}
    norm = float(torch.sqrt(sum((g * g).sum() for g in grads.values())))
    return {n: g * min(1.0, CLIP / norm) for n, g in grads.items()}


def test_first_step_gradients_no_worse_than_jax(f32_runs):
    """Each f32 gradient against the f64 run: the port's error (the norm of
    the difference) no larger than JAX's, give or take 1e-6 of the largest
    gradient's norm (f32 noise on tensors whose gradient is about zero)."""
    (_, jg, _), (_, tg, _, _) = f32_runs
    ref = _f64_grads()
    top = max(float(r.norm()) for r in ref.values())
    for n, r in ref.items():
        port = float((tg[n].double() - r).norm())
        jax_err = float((jg[n].double() - r).norm())
        assert port <= jax_err + 1e-6 * top, (n, port, jax_err)


def test_params_and_batch_stats_after_three_steps(f32_runs):
    """The same schedule; each step's loss within 1e-4; every parameter
    within 2 x the summed lr of JAX's and within 10% of it on average. An
    Adam step moves every element by about lr, by its gradient's sign
    alone in the first steps, so an element whose gradient is about zero
    (f32 noise in either package) may step the other way; and this network
    is ill-conditioned past the first step (its first convs' gradients
    move by 10-150% when every parameter moves by 1e-6), so the steps after
    the first are held by the loss, not element by element."""
    (jm, _, jp), (tm, _, tp, lrs) = f32_runs
    np.testing.assert_allclose(lrs, _lrs(STEPS), rtol=1e-6)  # the same schedule
    for i in range(STEPS):
        assert abs(tm[i]["loss"] - jm[i]["loss"]) <= 1e-4 * abs(jm[i]["loss"]), i
    lr_sum = sum(lrs)
    total, count = 0.0, 0
    for name, want in jp.items():
        d = (tp[name] - want).abs()
        if name.endswith(("running_mean", "running_var")):
            assert float(d.max()) <= 1e-4 * max(1.0, float(want.abs().max())), name
            continue
        assert float(d.max()) <= 2 * lr_sum, name
        total, count = total + float(d.sum()), count + d.numel()
    assert total / count <= 0.1 * lr_sum


def test_schedule_matches_one_cycle_lr():
    """torch's OneCycleLR as `one_cycle` builds it against JAX's
    `one_cycle_lr`, step by step, over a whole cycle, with a second group
    at lr / 10."""
    total = 1100
    model = torch.nn.Linear(2, 2)
    opt = torch.optim.AdamW([dict(params=[model.weight], lr=LR),
                             dict(params=[model.bias], lr=LR / 10)])
    sched = one_cycle(opt, total)
    want = np.asarray(jax.vmap(one_cycle_lr(LR, total))(jnp.arange(total)))
    got = []
    for _ in range(total):
        got.append([g["lr"] for g in opt.param_groups])
        opt.step()
        sched.step()
    got = np.asarray(got)
    # JAX's schedule computes in f32: rounding near the floor of 1.6e-9
    np.testing.assert_allclose(got[:, 0], want, rtol=1e-5, atol=1e-10)
    np.testing.assert_allclose(got[:, 1], want / 10, rtol=1e-5, atol=1e-11)


def test_bf16_loss_within_two_percent_of_jax():
    jm, _, _ = _jax_run("bfloat16", 1)
    tm, tg, _, _ = _port_run("bfloat16", 1)
    assert abs(tm[0]["loss"] - jm[0]["loss"]) <= 0.02 * abs(jm[0]["loss"])
    # each gradient lands in f32 on its f32 parameter
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in tg.values())


def _port_names(flat_keys):
    """Flat flax keys (the fixture's) -> the port's names, in order."""
    with np.load(FIXTURE) as raw:
        return dict(zip(flat_keys, params_from_jax({k: raw[k] for k in flat_keys})))


def test_freeze_and_flow_net_labels_equal_jax():
    from focusflow_official_tpu.train import surgery as jsurgery
    from focusflow_official_tpu_torch.train import surgery

    params = _jax_variables()["params"]
    names = _port_names([k for k in _flat(params, "params")])
    for jfn, fn in ((jsurgery.freeze_mask_for_parallel, surgery.freeze_mask_for_parallel),
                    (jsurgery.flow_net_lr_labels, surgery.flow_net_lr_labels)):
        want = {names[k]: lbl for k, lbl in _flat(jfn(params), "params").items()}
        assert fn(want) == want
    frozen = surgery.freeze_mask_for_parallel(want)
    assert frozen["flow_net.fnet.conv1.weight"] == "frozen"
    assert frozen["flow_net.fnet.mask_conv1.weight"] == "trainable"
    assert frozen["flow_net.update_block.gru.convz1.weight"] == "frozen"
    assert frozen["flow_net.update_block.flow_head.conv1.weight"] == "trainable"


def test_frozen_group_stays_and_encoder_group_takes_a_tenth():
    """One AdamW step with equal gradients: a 'frozen' parameter does not
    move, an 'encoder' one moves a tenth as far as a 'trainable' one (as
    JAX's `test_separate_lr_flow_net_tenth`)."""
    model = torch.nn.Sequential(torch.nn.Linear(4, 4), torch.nn.Linear(4, 4),
                                torch.nn.Linear(4, 4))
    labels = {n: ("frozen", "encoder", "trainable")[int(n[0])]
              for n, _ in model.named_parameters()}
    opt = build_optimizer(model, 1e-3, weight_decay=0.0, labels=labels)
    assert sorted(g["label"] for g in opt.param_groups) == ["encoder", "frozen", "trainable"]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    step = {n: float((p.detach() - before[n]).abs().mean())
            for n, p in model.named_parameters()}
    assert step["0.weight"] == step["0.bias"] == 0.0
    np.testing.assert_allclose(step["1.weight"] / step["2.weight"], 0.1, rtol=1e-3)
