"""Vanilla FlowFormer in the port (`fusion=None`: plain Twins towers, no
mask read) against the JAX package's, in f32 on the CPU at 64x96, encoder
depth 1. Vanilla FlowFormer's variable tree (`jax.eval_shape` of JAX's
`init`) is the trained FF-FlowFormer fixture
(`tests/fixtures/trained_smoke_ff.npz`) without its mask towers and
fusion units, leaf for leaf.

- `TwinsSVT2Stage` (the fixture's context tower) and `MemoryEncoder` (the
  fixture's feature tower over both frames, the 1x1, the cost volume, the
  perceiver) alone: within 1e-5 of the output's scale (f32 sums in other
  orders through 4 Twins blocks and the perceiver);
- `FlowFormer` at 2 refinements on weights of that tree drawn from a
  seeded numpy generator (`test_torch_ff_flowformer.py`'s recipe): the
  test-mode flows and the train-mode flows (every refinement's) within
  1e-4 of the flow's scale, that file's bound (measured: 2e-5 of it). The
  fixture's image half is not a model (its features miss what the fusion
  units added): there the flows reach 16 px at H/8 and the decoder
  amplifies f32 rounding, so JAX's f32 flows and the port's are each 4e-3
  to 2e-2 px from the port's f64 run. JAX runs on the port's export
  (`params_to_jax`), which gives the tree back to the bit;
- one train step on the seeded weights and
  `configs/ff-flowformer/chairs.yaml`'s loss (MixLoss)
  against JAX's `make_train_step`: the loss within 1e-5 relative, the
  gradients by that file's bounds (the flat cosine >= 0.9999, each
  tensor within 3% of its norm plus 1e-6 of the largest gradient);
- the reference `.pth` layout (`context_encoder.svt.*`,
  `memory_encoder.feat_encoder.svt.*`, DDP's `module.` prefix) loads
  `strict=True`; timm Twins weights map onto a `TwinsSVT2Stage` as JAX's
  converter maps them.

JAX runs its reference-semantics decoder (`corr_impl="xla"`) with every
`FF_*` override cleared.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from focusflow_official_tpu import config as jconfig
from focusflow_official_tpu.compat.timm_twins import timm_twins_to_variables
from focusflow_official_tpu.compat.torch_import import torch_key_for_path as jax_torch_key
from focusflow_official_tpu.losses import build_sequence_loss as jax_loss
from focusflow_official_tpu.models.ff_flowformer import FlowFormer as JFlowFormer
from focusflow_official_tpu.models.ff_flowformer import FlowFormerConfig as JConfig
from focusflow_official_tpu.models.ff_flowformer import MemoryEncoder as JMemoryEncoder
from focusflow_official_tpu.nn.twins import TwinsSVT2Stage as JTwins
from focusflow_official_tpu.train.loop import TrainState, make_train_step
from focusflow_official_tpu.train.loop import build_optimizer as jax_optimizer
from focusflow_official_tpu.train.schedule import one_cycle_lr
from focusflow_official_tpu_torch import config as tconfig
from focusflow_official_tpu_torch.compat.timm_twins import timm_twins_to_state_dict
from focusflow_official_tpu_torch.compat.torch_import import load_torch_pretrained
from focusflow_official_tpu_torch.compat.weights import params_from_jax, params_to_jax
from focusflow_official_tpu_torch.data.synthetic import chairs_layout
from focusflow_official_tpu_torch.losses import build_sequence_loss
from focusflow_official_tpu_torch.models import FlowFormer, FlowFormerConfig
from focusflow_official_tpu_torch.models.ff_flowformer import MemoryEncoder
from focusflow_official_tpu_torch.nn.twins import TwinsSVT2Stage
from focusflow_official_tpu_torch.train.loop import build_optimizer, train_step
from focusflow_official_tpu_torch.train.schedule import one_cycle

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "trained_smoke_ff.npz")
CHAIRS = os.path.join(ROOT, "configs", "ff-flowformer", "chairs.yaml")
B, H, W, ITERS = 2, 64, 96, 2
LR, TOTAL, WD, EPS, CLIP = 4e-4, 103, 1e-5, 1e-8, 1.0
KEYS = ("image1", "image2", "mask1", "mask2", "flow", "valid")
_KNOBS = ("FF_DEC_CHUNK", "FF_PALLAS_LSA", "FF_PALLAS_ATTN", "FF_FAST_GELU", "FF_PE_FOLD")
JCFG = JConfig(fusion=None, encoder_depth=1, decoder_depth=ITERS, corr_impl="xla")
TCFG = FlowFormerConfig(fusion=None, encoder_depth=1, decoder_depth=ITERS)


@pytest.fixture(autouse=True, scope="module")
def _no_tpu_knobs():
    with pytest.MonkeyPatch.context() as mp:
        for knob in _KNOBS:
            mp.delenv(knob, raising=False)
        yield


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs its files in parallel worker
    processes."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _batch():
    ds = chairs_layout(0, n=B, h=H, w=W)
    return {k: np.stack([ds[i][k] for i in range(B)]).astype(np.float32) for k in KEYS}


@pytest.fixture(scope="module")
def flat():
    """Vanilla FlowFormer's flat flax variables, from the fixture."""
    x = jnp.zeros((1, H, W, 3))
    tree = jax.eval_shape(lambda: JFlowFormer(JCFG).init(jax.random.PRNGKey(0), x, x,
                                                         test_mode=True))
    want = traverse_util.flatten_dict(tree, sep="/")
    with np.load(FIXTURE) as raw:
        out = {k: raw[k].astype(np.float32) for k in sorted(want)}
        dropped = [k for k in raw.files if k not in want]
    assert all(raw_shape.shape == want[k].shape for k, raw_shape in out.items())
    assert dropped and all("/mask_" in k or "/fusion_blks" in k for k in dropped)
    return out


@pytest.fixture(scope="module")
def seeded(flat):
    """The same tree drawn from a seeded generator: kernels N(0, 1/fan_in),
    LayerNorm scales 1 + N(0, 0.1^2), every other leaf N(0, 0.1^2)."""
    rng = np.random.RandomState(7)
    out = {}
    for k, a in flat.items():
        leaf = k.rsplit("/", 1)[1]
        if leaf == "kernel":
            r = rng.randn(*a.shape) / np.sqrt(np.prod(a.shape[:-1]))
        elif leaf == "scale":
            r = 1 + 0.1 * rng.randn(*a.shape)
        else:
            r = 0.1 * rng.randn(*a.shape)
        out[k] = r.astype(np.float32)
    return out


def _tree(flat_vars):
    return traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(a)
                                         for k, a in flat_vars.items()})


def _sub(flat_vars, scope):
    """The variables under `params/<scope>/`, re-rooted at `params/`."""
    head = f"params/{scope}/"
    return {"params/" + k[len(head):]: a for k, a in flat_vars.items() if k.startswith(head)}


def _close(got, want, rel):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(np.asarray(got) - want).max()) <= rel * scale


def _port_model(flat_vars):
    model = FlowFormer(TCFG)
    model.load_state_dict(params_from_jax(flat_vars), strict=True)
    return model


def test_twins_tower_matches_jax(flat):
    x = _batch()["image1"] / 127.5 - 1.0
    sub = _sub(flat, "context_encoder_svt")
    want = jax.jit(JTwins().apply)(_tree(sub), jnp.asarray(x))
    tower = TwinsSVT2Stage().eval()
    tower.load_state_dict(params_from_jax(sub), strict=True)
    with torch.inference_mode():
        got = tower(torch.from_numpy(x))
    assert got.shape == (B, H // 8, W // 8, 256)
    _close(got.numpy(), want, 1e-5)


def test_memory_encoder_matches_jax(flat):
    batch = _batch()
    i1, i2 = (batch[k] / 127.5 - 1.0 for k in ("image1", "image2"))
    context = np.random.RandomState(2).randn(B, H // 8, W // 8, 256).astype(np.float32)
    sub = _sub(flat, "memory_encoder")
    want_mem, want_maps, _ = jax.jit(JMemoryEncoder(JCFG).apply)(
        _tree(sub), *map(jnp.asarray, (i1, i2, context)))
    enc = MemoryEncoder(TCFG).eval()
    enc.load_state_dict(params_from_jax(sub), strict=True)
    assert isinstance(enc.feat_encoder_svt, TwinsSVT2Stage)
    with torch.inference_mode():
        mem, maps = enc(*map(torch.from_numpy, (i1, i2, context)))
    q = (H // 8) * (W // 8)
    assert tuple(maps.shape) == (B, q, H // 8, W // 8) and tuple(mem.shape) == (B * q, 8, 128)
    _close(maps.numpy(), want_maps, 1e-5)
    _close(mem.numpy(), want_mem, 1e-5)


def test_forward_matches_jax(seeded):
    model = _port_model(seeded).eval()
    exported = params_to_jax(model.state_dict())
    assert set(exported) == set(seeded)
    for k in seeded:
        np.testing.assert_array_equal(exported[k], seeded[k])
    batch = _batch()
    inputs = [batch[k] for k in KEYS[:4]]
    want_up, want_lr = jax.jit(lambda v, *a: JFlowFormer(JCFG).apply(v, *a, test_mode=True))(
        _tree(exported), *map(jnp.asarray, inputs))
    with torch.inference_mode():
        got_lr, got = model(*map(torch.from_numpy, inputs))
        no_masks = model(*map(torch.from_numpy, inputs[:2]))[1]
    assert got.shape == want_up.shape == (B, H, W, 2)
    scale = float(np.abs(np.asarray(want_up)).max())
    assert scale > 5.0  # multi-pixel flow: the relative bound has force
    _close(got_lr.numpy(), want_lr, 1e-4)
    _close(got.numpy(), want_up, 1e-4)
    assert torch.equal(no_masks, got)  # the masks are not read


def test_train_forward_matches_jax(seeded):
    batch = _batch()
    inputs = [batch[k] for k in KEYS[:4]]
    want = jax.jit(lambda v, *a: JFlowFormer(JCFG).apply(v, *a, train=True))(
        _tree(seeded), *map(jnp.asarray, inputs))
    model = _port_model(seeded).train()
    with torch.no_grad():
        got = model(*map(torch.from_numpy, inputs))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (ITERS, B, H, W, 2)
    _close(got.numpy(), want, 1e-4)


def test_train_step_matches_jax(seeded):
    cfg = tconfig.load_yaml_config(CHAIRS)
    assert tconfig.config_from_yaml(cfg).fusion is None
    kw = tconfig.loss_kwargs_from_yaml(cfg)
    assert kw == jconfig.loss_kwargs_from_yaml(cfg) and kw["loss_type"] == "MixLoss"
    v = _tree(seeded)
    tx = jax_optimizer(one_cycle_lr(LR, TOTAL), weight_decay=WD, epsilon=EPS, clip=CLIP)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"], batch_stats={},
                       opt_state=tx.init(v["params"]), apply_fn=JFlowFormer(JCFG).apply, tx=tx)
    lkw = dict(kw)
    step = make_train_step(jax_loss(lkw.pop("loss_type"), **lkw), iters=ITERS, add_noise=False)
    state, m = step(state, {k: jnp.asarray(a) for k, a in _batch().items()},
                    jax.random.PRNGKey(0))
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    jg = params_from_jax({"params/" + "/".join(k): np.asarray(a) / 0.1
                          for k, a in traverse_util.flatten_dict(adam.mu).items()})
    jm = {k: float(x) for k, x in m.items()}

    model = _port_model(seeded).train()
    opt = build_optimizer(model, LR, weight_decay=WD, epsilon=EPS)
    lkw = dict(kw)
    tm = train_step(model, opt, one_cycle(opt, TOTAL),
                    build_sequence_loss(lkw.pop("loss_type"), **lkw),
                    {k: torch.from_numpy(a) for k, a in _batch().items()}, iters=ITERS,
                    clip=CLIP)
    for k in ("loss", "epe"):
        assert abs(float(tm[k]) - jm[k]) <= 1e-5 * abs(jm[k]), (k, float(tm[k]), jm[k])
    tg = {n: p.grad.clone() for n, p in model.named_parameters()}
    assert set(tg) == set(jg)
    flat_t = torch.cat([tg[n].flatten() for n in sorted(tg)]).double()
    flat_j = torch.cat([jg[n].flatten() for n in sorted(tg)]).double()
    assert float(torch.nn.functional.cosine_similarity(flat_t, flat_j, dim=0)) >= 0.9999
    top = float(flat_j.abs().max())
    for n in tg:
        err = float((tg[n] - jg[n]).norm())
        assert err <= 3e-2 * float(jg[n].norm()) + 1e-6 * top, n


def test_reference_pth_loads_strict(flat, tmp_path):
    sd = params_from_jax(flat)
    ref = {}
    for key, name in zip(flat, sd):
        coll, *path = key.split("/")
        ref["module." + jax_torch_key(tuple(path), coll)] = sd[name] * 1.5 + 0.25
    assert "module.context_encoder.svt.blocks.0.1.attn.kv.weight" in ref
    assert "module.memory_encoder.feat_encoder.svt.patch_embeds.1.proj.weight" in ref
    path = tmp_path / "flowformer-chairs.pth"
    torch.save(ref, path)
    model = FlowFormer(TCFG)
    got = load_torch_pretrained(str(path), model)  # strict
    model.load_state_dict(got, strict=True)
    for k in sd:
        assert torch.equal(got[k], sd[k] * 1.5 + 0.25), k


def test_timm_twins_onto_plain_tower_equals_jax():
    from fake_timm import create_model

    torch.manual_seed(2)
    timm_sd = create_model("twins_svt_large").state_dict()
    template = TwinsSVT2Stage().state_dict()
    got = timm_twins_to_state_dict(timm_sd, template)
    jax_template = traverse_util.unflatten_dict(
        {tuple(k.split("/")[1:]): jnp.asarray(a) for k, a in params_to_jax(template).items()})
    jv = timm_twins_to_variables({k: v.numpy() for k, v in timm_sd.items()}, jax_template)
    want = params_from_jax({"params/" + "/".join(k): np.asarray(a)
                            for k, a in traverse_util.flatten_dict(jv).items()})
    assert set(got) == set(want) == set(template)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["blocks_1_1.attn.kv.weight"], timm_sd["blocks.1.1.attn.kv.weight"])
