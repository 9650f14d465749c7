"""The RAFT family's other variants in the port against the JAX package,
in f32 on the CPU at 64x96, 2 refinements, two samples of the multi-pixel
affine input (`data/synthetic.py`):

- plain RAFT (`fusion=None`, `raft_CTK.yaml`'s model: instance-norm
  `BasicEncoder` fnet, batch-norm `BasicEncoder` cnet, no masks read);
- FF-RAFT with `fuse_cnet=False` (the CCE fnet, a `BasicEncoder` cnet);
- `abandon_fnet` (`ChannelProject` in place of the fnet);
- FF-RAFT with the fusion ablation's units, `CA`, `SA` and `concat`.

Weights: the trained fixture's (`tests/fixtures/trained_smoke.npz`) under
every flax path where the variant has the fixture's name and shape (the
plain encoders carry the CCE image branch's names); every other leaf
(the new fusion units, `channel_pjt`) drawn from a seeded numpy
generator, kernels N(0, 1/fan_in), biases N(0, 0.01^2). The variable tree
is JAX's own (`jax.eval_shape` of `init`). The port loads it through
`params_from_jax`; JAX runs on the port's export (`params_to_jax`), which
must give the tree back to the bit.

Bounds: the test-mode flows (low resolution and upsampled) within 1e-4 px
of the port's run of the same model in f64 (where its plain ops allow:
the instance norms take f32 statistics), and JAX's f32 flows within 1e-3
px of that run. JAX is not held to 1e-4 of the port's f32 flows: on these
inputs its own f32 flows are up to 2.7e-4 px from the f64 run (CA; the
port's 1.3e-5), through the CCE's f32 sums in another order, which the
refinements amplify (plain RAFT: JAX 4.8e-6, the port 9.4e-6). One train
step of plain RAFT
on `raft_CTK.yaml`'s loss (EPELoss, frozen batch norms: the kitti stage)
against JAX's `make_train_step`: the loss within 1e-5 relative, and the
gradients by the bounds of `test_torch_train_step.py` (the flat cosine
>= 0.9999, each tensor within 3% of its norm plus 1e-6 of the largest
gradient: f32 gradients through products summed in other orders, which
this network's saturated GRU gates and norms amplify in both packages).
Also: the reference `.pth` layout of plain RAFT (DDP's `module.` prefix,
the shared norm only as `downsample.1`) loads `strict=True`; LOAD_MODULE,
LOAD_MODULE_TO_BRANCH and FREEZE_MODULE on plain RAFT as in JAX.
"""

import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from focusflow_official_tpu import config as jconfig
from focusflow_official_tpu.compat.torch_import import torch_key_for_path as jax_torch_key
from focusflow_official_tpu.losses import build_sequence_loss as jax_loss
from focusflow_official_tpu.models import FFRaft as JFFRaft
from focusflow_official_tpu.models import FFRaftConfig as JConfig
from focusflow_official_tpu.train import surgery as jsurgery
from focusflow_official_tpu.train.loop import TrainState, make_train_step
from focusflow_official_tpu.train.loop import build_optimizer as jax_optimizer
from focusflow_official_tpu.train.schedule import one_cycle_lr
from focusflow_official_tpu_torch import config as tconfig
from focusflow_official_tpu_torch.cli import train as cli_train
from focusflow_official_tpu_torch.compat.torch_import import load_torch_pretrained
from focusflow_official_tpu_torch.compat.weights import params_from_jax, params_to_jax
from focusflow_official_tpu_torch.data.synthetic import chairs_layout
from focusflow_official_tpu_torch.losses import build_sequence_loss
from focusflow_official_tpu_torch.models import FFRaft, FFRaftConfig
from focusflow_official_tpu_torch.nn.encoders import BasicEncoder, ChannelProject
from focusflow_official_tpu_torch.train import surgery
from focusflow_official_tpu_torch.train.loop import build_optimizer, train_step
from focusflow_official_tpu_torch.train.schedule import one_cycle

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "trained_smoke.npz")
RAFT_CTK = os.path.join(ROOT, "configs", "ff-raft", "experiment", "raft_CTK.yaml")
B, H, W, ITERS = 2, 64, 96, 2
LR, TOTAL, WD, EPS, CLIP = 4e-4, 103, 1e-5, 1e-8, 1.0
KEYS = ("image1", "image2", "mask1", "mask2", "flow", "valid")
VARIANTS = {
    "plain": dict(fusion=None, fuse_cnet=True),
    "fuse_cnet_false": dict(fusion="parallel", fuse_cnet=False),
    "abandon_fnet": dict(fusion=None, abandon_fnet=True),
    "CA": dict(fusion="parallel", fuse_cnet=True, fusion_type="CA"),
    "SA": dict(fusion="parallel", fuse_cnet=True, fusion_type="SA"),
    "concat": dict(fusion="parallel", fuse_cnet=True, fusion_type="concat"),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs its files in parallel worker
    processes."""
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


def _batch():
    ds = chairs_layout(0, n=B, h=H, w=W)
    return {k: np.stack([ds[i][k] for i in range(B)]).astype(np.float32) for k in KEYS}


def _jax_model(kw, **extra):
    return JFFRaft(JConfig(corr_impl="xla", iters=ITERS, **kw, **extra))


def _variables(kw, seed=0):
    """The variant's flat flax variables: the fixture's where the name and
    shape carry over, else seeded -> (flat, the seeded keys)."""
    x = jnp.zeros((1, H, W, 3))
    m = jnp.zeros((1, H, W, 1))
    model = _jax_model(kw)
    tree = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, x, m, m, iters=ITERS,
                                             test_mode=True))
    rng = np.random.RandomState(seed)
    flat, seeded = {}, []
    with np.load(FIXTURE) as raw:
        for key, leaf in sorted(traverse_util.flatten_dict(tree, sep="/").items()):
            if key in raw.files and raw[key].shape == leaf.shape:
                flat[key] = raw[key].astype(np.float32)
                continue
            seeded.append(key)
            if key.endswith("/kernel"):
                fan_in = int(np.prod(leaf.shape[:-1]))
                flat[key] = (rng.randn(*leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
            else:
                assert key.endswith("/bias"), key
                flat[key] = (rng.randn(*leaf.shape) * 0.01).astype(np.float32)
    return flat, seeded


def _tree(flat):
    return traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(a)
                                         for k, a in flat.items()})


def _port_model(kw, flat, **extra):
    model = FFRaft(FFRaftConfig(iters=ITERS, **kw, **extra))
    model.load_state_dict(params_from_jax(flat), strict=True)
    return model


def _f64_flows(model, inputs):
    """The port's test-mode flows of `model` computed in f64."""
    import focusflow_official_tpu_torch.models.ff_raft as ff_raft

    saved = ff_raft.DTYPES["float32"]
    ff_raft.DTYPES["float32"] = torch.float64
    try:
        with torch.inference_mode():
            return copy.deepcopy(model).double()(
                *(torch.from_numpy(a).double() for a in inputs))
    finally:
        ff_raft.DTYPES["float32"] = saved


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_forward_matches_jax(name):
    kw = VARIANTS[name]
    flat, seeded = _variables(kw)
    model = _port_model(kw, flat).eval()
    exported = params_to_jax(model.state_dict())
    assert set(exported) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(exported[k], flat[k])
    batch = _batch()
    inputs = [batch[k] for k in KEYS[:4]]
    want_lr, want = jax.jit(lambda v, *a: _jax_model(kw).apply(v, *a, iters=ITERS,
                                                               test_mode=True))(
        _tree(exported), *map(jnp.asarray, inputs))
    with torch.inference_mode():
        got_lr, got = model(*map(torch.from_numpy, inputs))
    assert got.shape == want.shape == (B, H, W, 2)
    for ours, theirs, ref in zip((got_lr, got), (want_lr, want), _f64_flows(model, inputs)):
        ref = ref.numpy()
        assert float(np.abs(ours.numpy() - ref).max()) <= 1e-4
        assert float(np.abs(np.asarray(theirs) - ref).max()) <= 1e-3
    # which encoders the variant built, and which of its leaves were seeded
    net = model.flow_net
    if kw.get("abandon_fnet"):
        assert isinstance(net.channel_pjt, ChannelProject) and not hasattr(net, "fnet")
        assert seeded == ["params/flow_net/channel_pjt/conv1/bias",
                          "params/flow_net/channel_pjt/conv1/kernel"]
    elif kw["fusion"] is None:
        assert isinstance(net.fnet, BasicEncoder) and seeded == []
    if kw["fusion"] is None or not kw["fuse_cnet"]:
        assert isinstance(net.cnet, BasicEncoder) and net.cnet.norm1.kind == "batch"
    if "fusion_type" in kw:
        assert seeded and all("/fusion" in k for k in seeded)


def test_plain_raft_ignores_the_masks():
    kw = VARIANTS["plain"]
    model = _port_model(kw, _variables(kw)[0]).eval()
    batch = _batch()
    with torch.inference_mode():
        a = model(*(torch.from_numpy(batch[k]) for k in KEYS[:4]))[1]
        b = model(*(torch.from_numpy(batch[k]) for k in KEYS[:2]), None, None)[1]
    assert torch.equal(a, b)


def _ctk():
    """raft_CTK.yaml's model (cut to 2 refinements) and loss, as each
    package reads them."""
    cfg = tconfig.load_yaml_config(RAFT_CTK)
    ours = dataclasses.replace(tconfig.config_from_yaml(cfg), iters=ITERS)
    theirs = dataclasses.replace(jconfig.model_config_from_yaml(cfg, corr_impl="xla"),
                                 iters=ITERS)
    assert ours.fusion is None and ours.freeze_bn and theirs.freeze_bn
    kw = tconfig.loss_kwargs_from_yaml(cfg)
    assert kw == jconfig.loss_kwargs_from_yaml(cfg) and kw["loss_type"] == "EPELoss"
    return ours, theirs, kw


@pytest.fixture(scope="module")
def plain_step():
    """The first step of each package on raft_CTK.yaml's model from the
    same weights -> ((JAX metrics, JAX clipped gradients by port name),
    (port metrics, port gradients, the port's batch norms before and
    after))."""
    ours, theirs, kw = _ctk()
    flat, _ = _variables(VARIANTS["plain"])
    v = _tree(flat)
    tx = jax_optimizer(one_cycle_lr(LR, TOTAL), weight_decay=WD, epsilon=EPS, clip=CLIP)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]),
                       apply_fn=JFFRaft(theirs).apply, tx=tx)
    lkw = dict(kw)
    step = make_train_step(jax_loss(lkw.pop("loss_type"), **lkw), iters=ITERS, add_noise=False)
    state, m = step(state, {k: jnp.asarray(a) for k, a in _batch().items()},
                    jax.random.PRNGKey(0))
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    jg = params_from_jax({"params/" + "/".join(k): np.asarray(a) / 0.1
                          for k, a in traverse_util.flatten_dict(adam.mu).items()})

    model = FFRaft(ours)
    model.load_state_dict(params_from_jax(flat), strict=True)
    model.train().freeze_bn()
    before = {k: t.clone() for k, t in model.state_dict().items() if "running" in k}
    opt = build_optimizer(model, LR, weight_decay=WD, epsilon=EPS)
    lkw = dict(kw)
    tm = train_step(model, opt, one_cycle(opt, TOTAL),
                    build_sequence_loss(lkw.pop("loss_type"), **lkw),
                    {k: torch.from_numpy(a) for k, a in _batch().items()}, iters=ITERS,
                    clip=CLIP)
    tg = {n: p.grad.clone() for n, p in model.named_parameters()}
    after = {k: t for k, t in model.state_dict().items() if "running" in k}
    return ({k: float(x) for k, x in m.items()}, jg), (
        {k: float(x) for k, x in tm.items()}, tg, before, after)


def test_plain_raft_train_step_matches_jax(plain_step):
    (jm, jg), (tm, tg, before, after) = plain_step
    for k in ("loss", "epe"):
        assert abs(tm[k] - jm[k]) <= 1e-5 * abs(jm[k]), (k, tm[k], jm[k])
    assert set(tg) == set(jg)
    flat_t = torch.cat([tg[n].flatten() for n in sorted(tg)]).double()
    flat_j = torch.cat([jg[n].flatten() for n in sorted(tg)]).double()
    assert float(torch.nn.functional.cosine_similarity(flat_t, flat_j, dim=0)) >= 0.9999
    top = float(flat_j.abs().max())
    for n in tg:
        err = float((tg[n] - jg[n]).norm())
        assert err <= 3e-2 * float(jg[n].norm()) + 1e-6 * top, n
    # frozen batch norms (the kitti stage) keep their running statistics
    assert before and all(torch.equal(before[k], after[k]) for k in before)


def _reference_keys(flat):
    """Flat flax keys -> (the port's name, the reference key)."""
    names = params_from_jax(flat)
    out = {}
    for key, name in zip(flat, names):
        coll, *path = key.split("/")
        out[key] = (name, jax_torch_key(tuple(path), coll))
    return out


def test_reference_pth_loads_strict(tmp_path):
    """A plain RAFT checkpoint in the reference's layout: `module.`-prefixed
    keys, the shared downsample norm only under `downsample.1`."""
    flat, _ = _variables(VARIANTS["plain"])
    sd = params_from_jax(flat)
    ref = {}
    for name, rk in _reference_keys(flat).values():
        ref["module." + rk.replace(".norm3.", ".downsample.1.")] = sd[name] * 1.5 + 0.25
    assert any(".cnet.layer2.0.downsample.1.running_var" in k for k in ref)
    assert not any(".norm3." in k for k in ref)
    path = tmp_path / "raft-things.pth"
    torch.save(ref, path)
    model = FFRaft(FFRaftConfig(fusion=None, fuse_cnet=True))
    got = load_torch_pretrained(str(path), model)  # strict
    model.load_state_dict(got, strict=True)
    assert set(got) == set(sd)
    for k in sd:
        assert torch.equal(got[k], sd[k] * 1.5 + 0.25), k


def test_load_module_branch_and_freeze_as_jax(tmp_path):
    """LOAD_MODULE: a bare RAFT `.pth` (the flow_net subtree's keys) fills
    the whole plain model; LOAD_MODULE_TO_BRANCH then changes nothing
    (no mask branch), as JAX's `copy_to_branch`; FREEZE_MODULE's labels
    equal JAX's `freeze_mask_for_parallel`: both encoders and the update
    block's encoder and GRU frozen, the flow and mask heads trainable."""
    flat, _ = _variables(VARIANTS["plain"])
    sd = params_from_jax(flat)
    bare = {"module." + rk[len("flow_net."):]: sd[name] * 2.0
            for name, rk in _reference_keys(flat).values()}
    path = tmp_path / "raft.pth"
    torch.save(bare, path)
    cfg = tconfig.load_yaml_config(RAFT_CTK)
    cfg.MODEL.LOAD_MODULE = str(path)
    cfg.MODEL.LOAD_MODULE_TO_BRANCH = True
    cfg.MODEL.FREEZE_MODULE = True
    _, model, _, _ = cli_train.build_model(cfg, "float32")
    cli_train.load_initial_weights(cfg, model)
    got = model.state_dict()
    for k in sd:
        assert torch.equal(got[k], sd[k] * 2.0), k
    jtree = _tree(flat)
    jcopied = jsurgery.copy_to_branch({"params": jtree["params"]})["params"]
    for k, a in traverse_util.flatten_dict(jcopied, sep="/").items():
        np.testing.assert_array_equal(np.asarray(a), flat["params/" + k])

    labels, _ = cli_train.param_labels(cfg, model)
    names = dict(zip(flat, sd))
    want = {names["params/" + k]: lbl for k, lbl in traverse_util.flatten_dict(
        jsurgery.freeze_mask_for_parallel(jtree["params"]), sep="/").items()}
    assert labels == want == surgery.freeze_mask_for_parallel(want)
    assert labels["flow_net.fnet.layer3_1.conv2.weight"] == "frozen"
    assert labels["flow_net.cnet.norm1.weight"] == "frozen"
    assert labels["flow_net.update_block.gru.convz1.weight"] == "frozen"
    assert labels["flow_net.update_block.flow_head.conv1.weight"] == "trainable"
