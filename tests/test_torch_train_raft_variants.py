"""Training the FF-RAFT variants: the port's train step against the JAX
package's `train/loop.py::make_train_step`, in f32 on the CPU: two samples
of the multi-pixel affine input (`data/synthetic.py`) at 64x96, 2
refinements, MixLoss, AdamW with global clip 1.0 under OneCycle (4e-4
over 103 steps), no noise. The cases:

- RAFT-S (`fusion=None, small=True`) and FF-RAFT-S (the CCE fnet and
  cnet, small);
- the conv and attention front ends (`fusion_channel` 16) with
  TRAIN.SEPARATE_LR's labels (`cli/train.py::param_labels`: `flow_net` at
  lr / 10, `fusion_layer` at lr; JAX's `flow_net_lr_labels`);
- the conv front end under FREEZE_BN: the front end's batch norm takes
  the batch's statistics and updates its running ones twice a step (frame
  1, then frame 2), as JAX's, and `flow_net`'s stay put.

The weights (`variant_weights`): every tensor of the trained fixture
(`tests/fixtures/trained_smoke.npz`) whose name and shape carry over (none
for the small models), the rest drawn from a seeded generator as
`chip_smoke.py::_raft_variant_weights` draws them (kernels 0.1 x
N(0, 1/fan_in), a front end's N(0, 1/fan_in), biases 0.01 x N(0, 1),
norms at their initialisation) with the running statistics moved off
theirs; carried to JAX by `params_to_jax`.

Bounds, those of `tests/test_torch_train_step.py`: every train-mode
iterate within 1e-4 px; the first step's loss within 1e-5 relative, the
flat gradient's cosine >= 0.9999 and each tensor within 3% of its norm
(plus 1e-6 of the largest gradient; JAX's read from its Adam state: after
one update mu = (1 - b1) x the clipped gradient); after three steps each
loss within 1e-4, the parameters within 2 x the summed lr (each group's
own) and batch statistics within 1e-4 of their scale (2e-4 for the
attention front end: `test_three_steps_match_jax`), and after the first
step, which takes them from the same parameters, within 1e-5. bf16 (FF-RAFT-S
and the conv front end): the loss within 2%.

`test_torch_train_alt_corr.py` and `test_torch_dropout.py` run ALT_CORR's
and dropout's cases through the same harness.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from focusflow_official_tpu.losses import build_sequence_loss as jax_loss
from focusflow_official_tpu.models import FFRaft as JFFRaft
from focusflow_official_tpu.models import FFRaftConfig as JConfig
from focusflow_official_tpu.train import surgery as jsurgery
from focusflow_official_tpu.train.loop import TrainState, make_train_step
from focusflow_official_tpu.train.loop import build_optimizer as jax_optimizer
from focusflow_official_tpu.train.schedule import one_cycle_lr
from focusflow_official_tpu_torch.compat.weights import load_npz, params_from_jax, params_to_jax
from focusflow_official_tpu_torch.data.synthetic import chairs_layout
from focusflow_official_tpu_torch.losses import build_sequence_loss
from focusflow_official_tpu_torch.models import FFRaft, FFRaftConfig
from focusflow_official_tpu_torch.train.loop import build_optimizer, train_step
from focusflow_official_tpu_torch.train.schedule import one_cycle

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "trained_smoke.npz")
B, H, W, ITERS, STEPS, WF = 2, 64, 96, 2, 3, 16
LR, TOTAL, WD, EPS, CLIP = 4e-4, 103, 1e-5, 1e-8, 1.0
KEYS = ("image1", "image2", "mask1", "mask2", "flow", "valid")
CASES = {
    "raft_s": dict(fusion=None, small=True),
    "ff_raft_s": dict(fusion="parallel", fuse_cnet=True, small=True),
    "conv": dict(fusion="conv", fusion_channel=WF),
    "attention": dict(fusion="attention", fusion_channel=WF),
    "conv_freeze_bn": dict(fusion="conv", fusion_channel=WF, freeze_bn=True),
}
SEPARATE_LR = ("conv", "attention", "conv_freeze_bn")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs its files in parallel worker
    processes."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def batch():
    ds = chairs_layout(0, n=B, h=H, w=W)
    return {k: np.stack([ds[i][k] for i in range(B)]).astype(np.float32) for k in KEYS}


def variant_weights(kw: dict, seed: int = 12) -> dict:
    """The port's state dict for the config `kw` (see the module docstring)."""
    model = FFRaft(FFRaftConfig(**kw))
    src = {} if kw.get("small") else load_npz(FIXTURE)
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, t in model.state_dict().items():
        if k in src and src[k].shape == t.shape:
            sd[k] = src[k]
        elif k.endswith("running_mean"):
            sd[k] = 0.3 * torch.randn(t.shape, generator=g)
        elif k.endswith("running_var"):
            sd[k] = 0.5 + 1.5 * torch.rand(t.shape, generator=g)
        elif k.endswith("temperature") or (t.dim() == 1 and k.endswith("weight")):
            sd[k] = t
        elif t.dim() > 1:
            scale = 1.0 if k.startswith("fusion_layer.") else 0.1
            sd[k] = scale / float(np.sqrt(t[0].numel())) * torch.randn(t.shape, generator=g)
        else:
            sd[k] = 0.01 * torch.randn(t.shape, generator=g)
    return sd


def _tree(flat: dict):
    return traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(a)
                                         for k, a in flat.items()})


def _flat(tree, coll: str) -> dict:
    return {f"{coll}/" + "/".join(k): np.asarray(v)
            for k, v in traverse_util.flatten_dict(tree).items()
            if not isinstance(v, optax.MaskedNode)}


def lrs(n: int) -> list:
    return [float(one_cycle_lr(LR, TOTAL)(t)) for t in range(n)]


def port_model(kw: dict, sd: dict, dtype: str = "float32") -> FFRaft:
    model = FFRaft(FFRaftConfig(iters=ITERS, compute_dtype=dtype, **kw))
    model.load_state_dict(sd, strict=True)
    model.train()
    if kw.get("freeze_bn"):
        model.freeze_bn()
    return model


def jax_run(kw: dict, sd: dict, steps: int, *, separate_lr: bool = False,
            dtype: str = "float32", rngs=None):
    """JAX's `make_train_step` from the weights `sd` -> (metrics a step, the
    first step's clipped gradients by port name, the port-named parameters
    and batch statistics after each step). `rngs`: each step's key (default
    PRNGKey(i))."""
    v = _tree(params_to_jax(sd))
    model = JFFRaft(JConfig(iters=ITERS, compute_dtype=dtype, corr_impl="xla", **kw))
    labels = jsurgery.flow_net_lr_labels(v["params"]) if separate_lr else None
    tx = jax_optimizer(one_cycle_lr(LR, TOTAL), weight_decay=WD, epsilon=EPS, clip=CLIP,
                       encoder_labels=labels, encoder_lr_factor=0.1 if separate_lr else None)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       batch_stats=v.get("batch_stats", {}), opt_state=tx.init(v["params"]),
                       apply_fn=model.apply, tx=tx)
    step = make_train_step(jax_loss("MixLoss"), iters=ITERS, add_noise=False)
    jbatch = {k: jnp.asarray(a) for k, a in batch().items()}
    metrics, grads, states = [], None, []
    for i in range(steps):
        state, m = step(state, jbatch, jax.random.PRNGKey(i) if rngs is None else rngs[i])
        metrics.append({k: float(x) for k, x in m.items()})
        states.append(params_from_jax({**_flat(state.params, "params"),
                                       **_flat(state.batch_stats, "batch_stats")}))
        if i == 0:
            mus = [s.mu for s in jax.tree_util.tree_leaves(
                state.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
                if isinstance(s, optax.ScaleByAdamState)]
            flat = {}
            for mu in mus:  # one Adam state a group; the others' leaves masked
                flat.update(_flat(mu, "params"))
            grads = params_from_jax({k: a / 0.1 for k, a in flat.items()})
    return metrics, grads, states


def port_run(kw: dict, sd: dict, steps: int, *, labels=None, dtype: str = "float32",
             **step_kw):
    """The port's `train_step` from `sd` -> (metrics a step, the first
    step's clipped gradients, the state after each step, each step's lr of
    the 'trainable' group)."""
    model = port_model(kw, sd, dtype)
    opt = build_optimizer(model, LR, weight_decay=WD, epsilon=EPS, labels=labels)
    sched = one_cycle(opt, TOTAL)
    tb = {k: torch.from_numpy(a) for k, a in batch().items()}
    metrics, grads, lr_seen, states = [], None, [], []
    for _ in range(steps):
        lr_seen.append(max(g["lr"] for g in opt.param_groups))
        m = train_step(model, opt, sched, build_sequence_loss("MixLoss"), tb, iters=ITERS,
                       dtype={"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype],
                       clip=CLIP, **step_kw)
        metrics.append({k: float(x) for k, x in m.items()})
        if grads is None:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        states.append({k: v.clone() for k, v in model.state_dict().items()})
    return metrics, grads, states, lr_seen


def hold_first_step(tm, tg, jm, jg, f64=None) -> None:
    """The first step's loss, `epe` and gradients against JAX's. `f64`: the
    port's first-step gradients computed in f64 (`f64_grads`); a tensor
    past its 3% is then held to be no farther from them than JAX's (as
    `test_torch_train_step.py::test_first_step_gradients_no_worse_than_jax`
    holds every tensor)."""
    for k in ("loss", "epe"):
        assert abs(tm[0][k] - jm[0][k]) <= 1e-5 * abs(jm[0][k]), (k, tm[0][k], jm[0][k])
    assert set(tg) == set(jg)
    flat_t = torch.cat([tg[n].flatten() for n in sorted(tg)]).double()
    flat_j = torch.cat([jg[n].flatten() for n in sorted(tg)]).double()
    assert float(torch.nn.functional.cosine_similarity(flat_t, flat_j, dim=0)) >= 0.9999
    top = float(flat_j.abs().max())
    for n in tg:
        err = float((tg[n] - jg[n]).norm())
        if err <= 3e-2 * float(jg[n].norm()) + 1e-6 * top or f64 is None:
            assert err <= 3e-2 * float(jg[n].norm()) + 1e-6 * top, (n, err, float(jg[n].norm()))
            continue
        port, jax_err = (float((g[n].double() - f64[n]).norm()) for g in (tg, jg))
        assert port <= jax_err + 1e-6 * top, (n, port, jax_err)


def f64_grads(kw: dict, sd: dict, dropout=None) -> dict:
    """The port's first-step loss gradient on `batch()` with the model
    computed in f64 (the kernels' plain versions keep their f32 parts) and
    `dropout`'s keep masks, clipped as the step clips."""
    import focusflow_official_tpu_torch.models.ff_raft as ff_raft

    saved = ff_raft.DTYPES["float32"]
    ff_raft.DTYPES["float32"] = torch.float64
    try:
        model = port_model(kw, sd).double()
        b = {k: torch.from_numpy(a).double() for k, a in batch().items()}
        flows = model(*(b[k] for k in KEYS[:4]), iters=ITERS,
                      **({} if dropout is None else {"dropout": dropout}))
        loss, _ = build_sequence_loss("MixLoss")(flows, b["flow"], b["valid"], b["mask1"])
        loss.backward()
    finally:
        ff_raft.DTYPES["float32"] = saved
    grads = {n: p.grad for n, p in model.named_parameters()}
    norm = float(torch.sqrt(sum((g * g).sum() for g in grads.values())))
    return {n: g * min(1.0, CLIP / norm) for n, g in grads.items()}


def hold_steps(tm, tps, jm, jps, lr_seen, factors=None, stats_tol: float = 1e-4) -> None:
    """Each step's loss within 1e-4; after the last step every parameter
    within 2 x its group's summed lr (`factors`: name -> lr factor) of
    JAX's and within 10% of it on average; batch statistics within 1e-5 of
    their scale after the first step (taken from the same parameters) and
    within `stats_tol` of it after the last."""
    np.testing.assert_allclose(lr_seen, lrs(len(lr_seen)), rtol=1e-6)
    for i in range(len(tm)):
        assert abs(tm[i]["loss"] - jm[i]["loss"]) <= 1e-4 * abs(jm[i]["loss"]), i
    for tp, jp, tol in ((tps[0], jps[0], 1e-5), (tps[-1], jps[-1], stats_tol)):
        for name, want in jp.items():
            if name.endswith(("running_mean", "running_var")):
                err = float((tp[name] - want).abs().max())
                assert err <= tol * max(1.0, float(want.abs().max())), (name, err)
    tp, jp = tps[-1], jps[-1]
    lr_sum = sum(lr_seen)
    total, count = 0.0, 0
    for name, want in jp.items():
        d = (tp[name] - want).abs()
        if name.endswith(("running_mean", "running_var")):
            continue
        bound = lr_sum * (1.0 if factors is None else factors[name])
        assert float(d.max()) <= 2 * bound, name
        total, count = total + float(d.sum()) / bound, count + d.numel()
    assert total / count <= 0.1


def jax_train_forward(kw: dict, sd: dict, rng=None):
    """JAX's train-mode forward on `batch()` -> (the stacked flows, the
    port-named batch statistics after it)."""
    model = JFFRaft(JConfig(iters=ITERS, corr_impl="xla", **kw))
    v = _tree(params_to_jax(sd))
    b = batch()
    fwd = jax.jit(lambda v_, *a: model.apply(v_, *a, iters=ITERS, train=True,
                                             mutable=["batch_stats"],
                                             rngs={"dropout": rng} if rng is not None else None))
    flows, new = fwd(v, *(jnp.asarray(b[k]) for k in KEYS[:4]))
    return np.asarray(flows), params_from_jax(_flat(new.get("batch_stats", {}), "batch_stats"))


def hold_train_forward(kw: dict, sd: dict) -> None:
    """The port's train-mode iterates within 1e-4 px of JAX's and the
    running statistics after the forward within 1e-5 of their scale."""
    want, stats = jax_train_forward(kw, sd)
    model = port_model(kw, sd)
    b = batch()
    with torch.no_grad():
        got = model(*(torch.from_numpy(b[k]) for k in KEYS[:4]))
    assert got.shape == want.shape == (ITERS, B, H, W, 2)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-4
    state = model.state_dict()
    for name, t in stats.items():
        scale = max(1.0, float(t.abs().max()))
        assert float((state[name] - t).abs().max()) <= 1e-5 * scale, name


@pytest.fixture(scope="module")
def weights():
    return {name: variant_weights(kw) for name, kw in CASES.items()}


def _labels(name: str, model: torch.nn.Module):
    """`cli/train.py::param_labels` of smoke_chairs.yaml with the case's
    TRAIN.SEPARATE_LR -> (labels, factor by name)."""
    from focusflow_official_tpu_torch.cli.train import param_labels
    from focusflow_official_tpu_torch.config import load_yaml_config

    cfg = load_yaml_config(os.path.join(ROOT, "configs", "smoke_chairs.yaml"))
    cfg.TRAIN.SEPARATE_LR = name in SEPARATE_LR
    labels, factor = param_labels(cfg, model)
    if labels is None:
        return None, None
    return labels, {n: factor if lbl == "encoder" else 1.0 for n, lbl in labels.items()}


class _Runs(dict):
    """Each case's JAX and port runs, made when a test first asks."""

    def __init__(self, weights):
        super().__init__()
        self.weights = weights

    def __missing__(self, name):
        kw, sd = CASES[name], self.weights[name]
        labels, factors = _labels(name, port_model(kw, sd))
        self[name] = (jax_run(kw, sd, STEPS, separate_lr=name in SEPARATE_LR),
                      port_run(kw, sd, STEPS, labels=labels), factors)
        return self[name]


@pytest.fixture(scope="module")
def runs(weights):
    return _Runs(weights)


@pytest.mark.parametrize("name", sorted(CASES))
def test_train_forward_matches_jax(weights, name):
    hold_train_forward(CASES[name], weights[name])


@pytest.mark.parametrize("name", sorted(CASES))
def test_first_step_matches_jax(runs, name):
    (jm, jg, _), (tm, tg, _, _), _ = runs[name]
    hold_first_step(tm, tg, jm, jg)


@pytest.mark.parametrize("name", sorted(CASES))
def test_three_steps_match_jax(runs, name):
    """The attention front end trains at lr with weights of full scale
    (N(0, 1/fan_in)): where Adam's first step takes the sign of a gradient
    at rounding level, its parameters sit 2 x lr apart in the two packages
    (within the bound), and they move the cnet's batch statistics of the
    later steps by up to 1.4e-4 of their scale (measured on this input);
    its third step's statistics are held to 2e-4 of it."""
    (jm, _, jp), (tm, _, tp, lr_seen), factors = runs[name]
    hold_steps(tm, tp, jm, jp, lr_seen, factors, 2e-4 if name == "attention" else 1e-4)


@pytest.mark.parametrize("name", SEPARATE_LR)
def test_separate_lr_labels_equal_jax(weights, name):
    """TRAIN.SEPARATE_LR: `flow_net` at lr / 10 and the front end's
    `fusion_layer` at lr, as JAX's `flow_net_lr_labels`."""
    sd = weights[name]
    labels, _ = _labels(name, port_model(CASES[name], sd))
    params = _tree(params_to_jax(sd))["params"]
    names = dict(zip(_flat(params, "params"), params_from_jax(_flat(params, "params"))))
    want = {names[k]: lbl for k, lbl in
            _flat(jsurgery.flow_net_lr_labels(params), "params").items()}
    assert labels == want
    assert {lbl for n, lbl in labels.items() if n.startswith("fusion_layer.")} == {"trainable"}
    assert {lbl for n, lbl in labels.items() if n.startswith("flow_net.")} == {"encoder"}


def test_freeze_bn_keeps_the_front_end_in_train_mode(runs, weights):
    """FREEZE_BN freezes `flow_net`'s batch norms alone: after three steps
    the conv front end's running statistics moved (and equal JAX's, in
    `test_three_steps_match_jax`), `flow_net`'s are as they started."""
    sd = weights["conv_freeze_bn"]
    _, (_, _, tps, _), _ = runs["conv_freeze_bn"]
    tp = tps[-1]
    model = port_model(CASES["conv_freeze_bn"], sd)
    norms = {n: m.training for n, m in model.named_modules() if getattr(m, "kind", "") == "batch"}
    assert norms and all(norms[n] == n.startswith("fusion_layer.") for n in norms)
    stats = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    front = [k for k in stats if k.startswith("fusion_layer.")]
    assert front and len(front) < len(stats)
    for k in stats:
        moved = not torch.equal(tp[k], sd[k])
        assert moved == (k in front), k


def test_front_end_statistics_update_twice_a_step(weights):
    """One train-mode forward of the conv front end updates its running
    statistics twice, frame 1's batch then frame 2's, as flax's two calls
    of one module do: the same as two updates by hand from each frame's
    statistics."""
    from focusflow_official_tpu_torch.models.mask_modal import init_mask
    from focusflow_official_tpu_torch.nn.norm import MOMENTUM

    kw = CASES["conv"]
    sd = weights["conv"]
    model = port_model(kw, sd)
    b = {k: torch.from_numpy(a) for k, a in batch().items()}
    norm = model.fusion_layer.encoder.norm1
    mean0, var0 = norm.running_mean.clone(), norm.running_var.clone()
    cfg = model.cfg
    m1, m2 = init_mask(b["image1"], b["image2"], b["mask1"], b["mask2"],
                       mask_modal=cfg.mask_modal, mask_channel=cfg.mask_channel,
                       mask_dilate=cfg.mask_dilate, kernel_size=cfg.kernel_size,
                       kernel_sigma=cfg.kernel_sigma)
    scale = lambda t: 2 * (t / 255.0) - 1.0
    enc = model.fusion_layer.encoder
    mean, var = mean0, var0
    with torch.no_grad():
        for img, msk in ((b["image1"], m1), (b["image2"], m2)):
            x = enc.conv1(torch.cat([scale(img), scale(msk)], -1).permute(0, 3, 1, 2))
            n = x.numel() // x.shape[1]
            bm, bv = x.mean((0, 2, 3)), x.var((0, 2, 3), unbiased=True)
            mean = (1 - MOMENTUM) * mean + MOMENTUM * bm
            var = (1 - MOMENTUM) * var + MOMENTUM * bv
            assert n > 1
        model(*(b[k] for k in KEYS[:4]))
    for got, want in ((norm.running_mean, mean), (norm.running_var, var)):
        assert float((got - want).abs().max()) <= 1e-5 * max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("name", ["ff_raft_s", "conv"])
def test_bf16_loss_within_two_percent_of_jax(weights, name):
    kw = CASES[name]
    jm, _, _ = jax_run(kw, weights[name], 1, dtype="bfloat16")
    tm, tg, _, _ = port_run(kw, weights[name], 1, dtype="bfloat16")
    assert abs(tm[0]["loss"] - jm[0]["loss"]) <= 0.02 * abs(jm[0]["loss"])
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in tg.values())


@pytest.mark.parametrize("name", sorted(CASES))
def test_export_carries_every_variable_and_loads_into_jax(runs, weights, name):
    """`params_to_jax` of the trained state (the trainer's `.npz` export)
    names JAX's variables exactly, at JAX's shapes, the conv front end's
    `batch_stats` among them."""
    _, (_, _, tps, _), _ = runs[name]
    flat = params_to_jax(tps[-1])
    kw = CASES[name]
    model = JFFRaft(JConfig(iters=ITERS, corr_impl="xla", **kw))
    x, m = jnp.zeros((1, H, W, 3)), jnp.zeros((1, H, W, 1))
    tree = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, x, m, m, iters=1,
                                             test_mode=True))
    want = traverse_util.flatten_dict(tree, sep="/")
    assert set(flat) == set(want)
    for k, leaf in want.items():
        assert flat[k].shape == leaf.shape, k
    if kw.get("fusion") == "conv":
        assert any(k.startswith("batch_stats/fusion_layer/") for k in flat)
