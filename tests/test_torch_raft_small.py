"""The small model (MODEL.SMALL: RAFT-S and FF-RAFT-S) in the port against
the JAX package, in f32 on the CPU, on JAX-initialised parameters (the
norms' scales and running statistics moved off their identity start)
converted by `params_from_jax`, and seeded numpy inputs:

- `BottleneckBlock` (every norm kind, strides 1 and 2) and `SmallEncoder`
  (instance norms: kernels C1 and C2 on the card, their plain versions
  here; no norms, the small cnet's);
- `ConvGRU`, `SmallMotionEncoder` and `SmallUpdateBlock` (JAX looks the
  radius-3 window up with its gather lookup; the port runs G's plain
  version on the same levels);
- the ops the small model and queue 1 bring: `resize_bilinear_align_corners`
  and `upflow8`, the sampler's `return_mask`, `depth_to_space_flow`;
- RAFT-S (`fusion=None`) and FF-RAFT-S (the CCE fnet, the CCE cnet with
  norm 'none') end to end at 64x96, 3 refinements, test mode and train
  mode: flows within 1e-4 x max(1, max |flow|);
- the converter's round trip (`params_to_jax` gives JAX's tree back to
  the bit) and the reference `.pth` of RAFT-S (JAX's
  `variables_to_torch_state_dict`) loaded `strict=True`.

Module bounds: 2e-5 of the output's scale, as `test_torch_encoders.py`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from focusflow_official_tpu.compat.torch_import import variables_to_torch_state_dict
from focusflow_official_tpu.models import FFRaft as JFFRaft
from focusflow_official_tpu.models import FFRaftConfig as JConfig
from focusflow_official_tpu.nn.blocks import BottleneckBlock as JBottleneck
from focusflow_official_tpu.nn.encoders import SmallEncoder as JSmallEncoder
from focusflow_official_tpu.nn.update import ConvGRU as JConvGRU
from focusflow_official_tpu.nn.update import SmallMotionEncoder as JSmallMotion
from focusflow_official_tpu.nn.update import SmallUpdateBlock as JSmallUpdate
from focusflow_official_tpu.ops import coords as jcoords
from focusflow_official_tpu.ops.corr import CorrPyramid, lookup_corr_pyramid
from focusflow_official_tpu.ops.sampler import bilinear_sample as jsample
from focusflow_official_tpu.ops.upsample import depth_to_space_flow as jd2s
from focusflow_official_tpu_torch.compat.torch_import import load_torch_pretrained
from focusflow_official_tpu_torch.compat.weights import params_from_jax, params_to_jax
from focusflow_official_tpu_torch.models import FFRaft, FFRaftConfig
from focusflow_official_tpu_torch.nn.blocks import BottleneckBlock
from focusflow_official_tpu_torch.nn.encoders import SmallEncoder
from focusflow_official_tpu_torch.nn.update import ConvGRU, SmallMotionEncoder, SmallUpdateBlock
from focusflow_official_tpu_torch.ops.coords import resize_bilinear_align_corners, upflow8
from focusflow_official_tpu_torch.ops.corr import all_pairs_corr, corr_pyramid
from focusflow_official_tpu_torch.ops.sampler import bilinear_sample
from focusflow_official_tpu_torch.ops.upsample import depth_to_space_flow

RNG = np.random.RandomState(140)
B, H, W, ITERS = 2, 64, 96, 3
VARIANTS = {"raft_s": dict(fusion=None, small=True),
            "ff_raft_s": dict(fusion="parallel", fuse_cnet=True, small=True)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _flat(variables) -> dict:
    return {"/".join(k): np.asarray(v) for k, v in
            traverse_util.flatten_dict(variables).items()}


def _randomize_norms(variables):
    flat = traverse_util.flatten_dict(variables, sep="/")
    for k, v in flat.items():
        leaf = k.rsplit("/", 1)[-1]
        if k.startswith("batch_stats") and leaf == "mean":
            flat[k] = jnp.asarray(RNG.randn(*v.shape).astype(np.float32) * 0.3)
        elif k.startswith("batch_stats") and leaf == "var":
            flat[k] = jnp.asarray(RNG.uniform(0.5, 2.0, v.shape).astype(np.float32))
        elif leaf == "scale":
            flat[k] = jnp.asarray(RNG.uniform(0.5, 1.5, v.shape).astype(np.float32))
    return traverse_util.unflatten_dict(flat, sep="/")


def _close(got, want, rel: float = 2e-5) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= rel * scale


def _load(tmod, variables):
    tmod.load_state_dict(params_from_jax(_flat(variables)), strict=True)
    return tmod.eval()


nchw = lambda a: torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)
nhwc = lambda t: t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("norm_fn", ["instance", "batch", "group", "none"])
@pytest.mark.parametrize("cin,planes,stride", [(32, 32, 1), (32, 64, 2), (64, 96, 2)])
def test_bottleneck_block_matches_jax(norm_fn, cin, planes, stride):
    x = RNG.uniform(-1, 1, (B, 24, 32, cin)).astype(np.float32)
    jmod = JBottleneck(cin, planes, norm_fn, stride)
    variables = _randomize_norms(jmod.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    want = jmod.apply(variables, jnp.asarray(x))
    tmod = _load(BottleneckBlock(cin, planes, norm_fn, stride), variables)
    with torch.no_grad():
        _close(nhwc(tmod(nchw(x))), want)
    if stride != 1 and norm_fn != "none":  # the shortcut's norm is `norm4`
        assert any(k.startswith("norm4.") for k in tmod.state_dict()) == (norm_fn != "instance")


@pytest.mark.parametrize("norm_fn,out", [("instance", 128), ("none", 160)])
def test_small_encoder_matches_jax(norm_fn, out):
    x = RNG.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    jmod = JSmallEncoder(3, output_dim=out, norm_fn=norm_fn)
    variables = jmod.init(jax.random.PRNGKey(2), jnp.asarray(x))
    want = jmod.apply(variables, jnp.asarray(x))
    tmod = _load(SmallEncoder(3, out, norm_fn), variables)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert got.shape == (B, H // 8, W // 8, out)
    _close(got.numpy(), want)
    names = {n.split(".")[0] for n in tmod.state_dict()}
    assert names == {"conv1", "conv2", *(f"layer{i}_{j}" for i in (1, 2, 3) for j in (0, 1))}


def test_conv_gru_matches_jax():
    h = RNG.uniform(-1, 1, (B, 8, 12, 96)).astype(np.float32)
    x = RNG.uniform(-1, 1, (B, 8, 12, 146)).astype(np.float32)
    jmod = JConvGRU(96, 146)
    variables = jmod.init(jax.random.PRNGKey(3), jnp.asarray(h), jnp.asarray(x))
    want = jmod.apply(variables, jnp.asarray(h), jnp.asarray(x))
    tmod = _load(ConvGRU(96, 146), variables)
    with torch.no_grad():
        _close(nhwc(tmod(nchw(h), nchw(x))), want)


def _lookup_inputs(h1=8, w1=12):
    """A radius-3 lookup's operands: the port's pyramid of two random
    feature maps, coordinates around the grid, and JAX's looked-up window
    on the same levels (its gather lookup) -> (levels, coords, window)."""
    f1, f2 = (torch.from_numpy(RNG.randn(B, h1, w1, 32).astype(np.float32)) for _ in "ab")
    levels = corr_pyramid(all_pairs_corr(f1, f2), 4)
    grid = np.stack(np.meshgrid(np.arange(w1), np.arange(h1)), -1)[None].astype(np.float32)
    coords = torch.from_numpy((grid + RNG.randn(B, h1, w1, 2) * 2).astype(np.float32))
    window = lookup_corr_pyramid(CorrPyramid(levels=tuple(jnp.asarray(lv.numpy()) for lv in levels),
                                             radius=3), jnp.asarray(coords.numpy()),
                                 impl="xla", num_levels=4)
    assert window.shape == (B, h1, w1, 196)
    return levels, coords, window


def test_small_motion_encoder_matches_jax():
    """convc1 at radius 3 (K = 196, N = 96) through G's plain version."""
    levels, coords, window = _lookup_inputs()
    flow = RNG.randn(B, 8, 12, 2).astype(np.float32)
    jmod = JSmallMotion(4, 3)
    variables = jmod.init(jax.random.PRNGKey(4), jnp.asarray(flow), window)
    want = jmod.apply(variables, jnp.asarray(flow), window)
    tmod = _load(SmallMotionEncoder(4, 3), variables)
    with torch.no_grad():
        got = tmod(torch.from_numpy(flow), levels, coords)
    assert got.shape == (B, 82, 8, 12)
    _close(nhwc(got), want)


def test_small_update_block_matches_jax():
    levels, coords, window = _lookup_inputs()
    net = np.tanh(RNG.randn(B, 8, 12, 96)).astype(np.float32)
    inp = np.maximum(RNG.randn(B, 8, 12, 64), 0).astype(np.float32)
    flow = RNG.randn(B, 8, 12, 2).astype(np.float32)
    args = [jnp.asarray(net), jnp.asarray(inp), window, jnp.asarray(flow)]
    jmod = JSmallUpdate(4, 3, 96)
    variables = jmod.init(jax.random.PRNGKey(5), *args)
    jnet, jmask, jdelta = jmod.apply(variables, *args)
    tmod = _load(SmallUpdateBlock(4, 3, 96), variables)
    with torch.no_grad():
        tnet, tmask, tdelta = tmod(nchw(net), nchw(inp), levels, coords, torch.from_numpy(flow))
    assert jmask is None and tmask is None
    _close(nhwc(tnet), jnet)
    _close(tdelta.numpy(), jdelta)


@pytest.mark.parametrize("shape,new", [((B, 8, 12, 2), (64, 96)), ((1, 7, 5, 3), (13, 1)),
                                       ((1, 1, 6, 2), (4, 11)), ((9, 10, 3), (20, 4))])
def test_resize_bilinear_align_corners_matches_jax(shape, new):
    x = RNG.randn(*shape).astype(np.float32)
    want = jcoords.resize_bilinear_align_corners(jnp.asarray(x), new)
    _close(resize_bilinear_align_corners(torch.from_numpy(x), new).numpy(), want, 1e-6)


def test_upflow8_matches_jax():
    flow = (RNG.randn(B, 8, 12, 2) * 4).astype(np.float32)
    _close(upflow8(torch.from_numpy(flow)).numpy(), jcoords.upflow8(jnp.asarray(flow)), 1e-6)


def test_bilinear_sample_return_mask_matches_jax():
    """The samples and the reference's strict-interior mask, at points inside,
    on the border and outside."""
    img = RNG.randn(B, 10, 14, 3).astype(np.float32)
    pts = np.concatenate([RNG.uniform(-2, 16, (B, 40, 2)),
                          np.array([[0, 0], [13, 9], [13, 4], [0.5, 9], [-0.5, 3], [7, 9.25]]
                                   * B).reshape(B, 6, 2)], 1).astype(np.float32)
    wout, wmask = jsample(jnp.asarray(img), jnp.asarray(pts), return_mask=True)
    tout, tmask = bilinear_sample(torch.from_numpy(img), torch.from_numpy(pts), return_mask=True)
    assert tmask.shape == (B, 46) and tmask.dtype == torch.float32
    _close(tout.numpy(), wout, 1e-6)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(wmask))
    assert 0 < float(tmask.mean()) < 1


@pytest.mark.parametrize("lead", [(), (3,), (2, 3)])
def test_depth_to_space_flow_matches_jax(lead):
    up = RNG.randn(*lead, 4, 5, 64, 2).astype(np.float32)
    got = depth_to_space_flow(torch.from_numpy(up))
    assert got.shape == (*lead, 32, 40, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jd2s(jnp.asarray(up))))


def _inputs():
    i1 = (RNG.rand(B, H, W, 3) * 255).astype(np.float32)
    i2 = np.roll(np.roll(i1, 2, 1), -3, 2)
    m1 = ((RNG.rand(B, H, W, 1) > 0.97) * 255).astype(np.float32)
    m2 = ((RNG.rand(B, H, W, 1) > 0.97) * 255).astype(np.float32)
    return i1, i2, m1, m2


@pytest.fixture(scope="module")
def small_models():
    """Each variant: JAX's model and its initialised variables, and the
    port's model loaded from them."""
    out = {}
    x, m = jnp.zeros((1, H, W, 3)), jnp.zeros((1, H, W, 1))
    for name, kw in VARIANTS.items():
        jmodel = JFFRaft(JConfig(corr_impl="xla", iters=ITERS, **kw))
        variables = jax.jit(lambda k: jmodel.init(k, x, x, m, m, iters=1, test_mode=True))(
            jax.random.PRNGKey(7))
        variables = _randomize_norms(jax.tree_util.tree_map(np.asarray, variables))
        tmodel = FFRaft(FFRaftConfig(iters=ITERS, **kw))
        tmodel.load_state_dict(params_from_jax(_flat(variables)), strict=True)
        out[name] = (jmodel, variables, tmodel)
    return out


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_small_model_matches_jax(small_models, name):
    """Test mode (flow_lr and the bilinear 8x upsample) and train mode (every
    refinement's flow; the CCE's batch norms take the batch's statistics,
    the small cnet has none) within 1e-4 x max(1, max |flow|)."""
    jmodel, variables, tmodel = small_models[name]
    inputs = _inputs()
    jargs = [jnp.asarray(a) for a in inputs]
    want_lr, want = jax.jit(lambda v, *a: jmodel.apply(v, *a, iters=ITERS, test_mode=True))(
        variables, *jargs)
    want_train = jax.jit(lambda v, *a: jmodel.apply(v, *a, iters=ITERS, train=True,
                                                    mutable=["batch_stats"])[0])(
        variables, *jargs)
    targs = [torch.from_numpy(a) for a in inputs]
    with torch.no_grad():
        got_lr, got = tmodel.eval()(*targs)
        got_train = tmodel.train()(*targs)
    tmodel.eval()
    for ours, theirs in ((got_lr, want_lr), (got, want), (got_train, want_train)):
        theirs = np.asarray(theirs)
        assert ours.shape == theirs.shape
        assert float(np.abs(ours.numpy() - theirs).max()) <= 1e-4 * max(
            1.0, float(np.abs(theirs).max()))
    assert got.shape == (B, H, W, 2) and got_train.shape == (ITERS, B, H, W, 2)
    net = tmodel.flow_net
    assert net.hdim == 96 and net.corr_radius == 3 and net.small
    assert isinstance(net.cnet, SmallEncoder) == (name == "raft_s")
    assert isinstance(net.fnet, SmallEncoder) == (name == "raft_s")


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_small_model_round_trip_and_pth(small_models, name, tmp_path):
    """`params_to_jax` gives JAX's variables back to the bit, and the
    reference `.pth` JAX exports (`variables_to_torch_state_dict`, the
    shared downsample norms under both names) loads strict into the port
    with every tensor as JAX's."""
    _, variables, tmodel = small_models[name]
    flat = _flat(variables)
    exported = params_to_jax(tmodel.state_dict())
    assert set(exported) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(exported[k], flat[k])
    path = tmp_path / "raft-small.pth"
    torch.save({k: torch.from_numpy(np.array(v))
                for k, v in variables_to_torch_state_dict(variables).items()}, path)
    got = load_torch_pretrained(str(path), FFRaft(tmodel.cfg))
    want = tmodel.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
