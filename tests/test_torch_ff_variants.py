"""FF-FlowFormer's model variants in the port against the JAX package's, in
f32 on the CPU at 64x64, encoder depth 1, 2 refinements.

- each of the eight variant forms (no GMA; MLP-Mixer latent layers;
  ConvNext vertical layers; only-global with and without GMA; patch size
  4; no encoder residual; no flow token in the decoder's query) in eval
  mode: the port's weights drawn from a seeded `torch.Generator`
  (`_seeded`), carried to JAX by `params_to_jax`, whose flat names equal
  JAX's variable tree (`jax.eval_shape` of its `init`) and which
  `params_from_jax` loads back `strict=True`; the flows within 1e-4 of the
  flow's scale, the bound of `test_torch_flowformer_vanilla.py` (f32 sums
  in other orders through the towers, the perceiver and two refinements;
  measured: up to 1.1e-5 of scales of 11.6 to 19.3 px);
- (`test_torch_train_ff_variants.py`) one train step of a combined form
  against JAX's.

ConvNext's layer scale `gamma` is drawn at 0.1 x N(0, 1) (its
initialisation, 1e-6, would make the layer the identity and the test
blind to it). JAX runs its reference-semantics decoder
(`corr_impl="xla"`) with every `FF_*` override cleared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from focusflow_official_tpu.models.ff_flowformer import FFFlowFormer as JFF
from focusflow_official_tpu.models.ff_flowformer import FlowFormerConfig as JConfig
from focusflow_official_tpu_torch.compat.weights import params_from_jax, params_to_jax
from focusflow_official_tpu_torch.data.synthetic import chairs_layout
from focusflow_official_tpu_torch.models import FFFlowFormer, FlowFormerConfig

B, H, W, ITERS = 2, 64, 64, 2
KEYS = ("image1", "image2", "mask1", "mask2", "flow", "valid")
_KNOBS = ("FF_DEC_CHUNK", "FF_PALLAS_LSA", "FF_PALLAS_ATTN", "FF_FAST_GELU", "FF_PE_FOLD")
VARIANTS = {
    "no_gma": dict(gma=False),
    "mlp": dict(use_mlp=True),
    "convnext": dict(vertical_conv=True),
    "only_global": dict(only_global=True),
    "only_global_no_gma": dict(only_global=True, gma=False),
    "patch4": dict(patch_size=4),
    "no_encoder_res": dict(cost_encoder_res=False),
    "no_flow_token": dict(add_flow_token=False),
}


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


def _configs(form: dict):
    return (FlowFormerConfig(encoder_depth=1, decoder_depth=ITERS, **form),
            JConfig(encoder_depth=1, decoder_depth=ITERS, corr_impl="xla", **form))


def _seeded(model: torch.nn.Module, seed: int = 7) -> torch.nn.Module:
    """Draw every parameter from a seeded generator: conv and dense weights
    N(0, 1/fan_in), LayerNorm scales 1 + N(0, 0.1^2), every other tensor
    (biases, latent tokens, gamma, the GMA tables) N(0, 0.1^2)."""
    g = torch.Generator().manual_seed(seed)
    norms = {n for n, m in model.named_modules() if type(m).__name__ == "LayerNorm"}
    with torch.no_grad():
        for name, p in model.named_parameters():
            r = torch.randn(p.shape, generator=g)
            owner, leaf = name.rpartition(".")[::2]
            if leaf == "weight" and owner in norms:
                p.copy_(1 + 0.1 * r)
            elif leaf == "weight" and p.dim() > 1:
                p.copy_(r / float(np.sqrt(p[0].numel())))
            else:
                p.copy_(0.1 * r)
    return model


def _tree(flat):
    return traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(a)
                                         for k, a in flat.items()})


def _batch():
    ds = chairs_layout(0, n=B, h=H, w=W)
    return {k: np.stack([ds[i][k] for i in range(B)]).astype(np.float32) for k in KEYS}


def _close(got, want, rel):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_forward_matches_jax(name):
    tcfg, jcfg = _configs(VARIANTS[name])
    model = _seeded(FFFlowFormer(tcfg)).eval()
    flat = params_to_jax(model.state_dict())
    x = jnp.zeros((1, H, W, 3))
    m = jnp.zeros((1, H, W, 1))
    tree = jax.eval_shape(lambda: JFF(jcfg).init(jax.random.PRNGKey(0), x, x, m, m,
                                                 test_mode=True))
    want_tree = traverse_util.flatten_dict(tree, sep="/")
    assert set(flat) == set(want_tree)  # JAX's flat names exactly
    assert all(flat[k].shape == want_tree[k].shape for k in flat)
    back = FFFlowFormer(tcfg)
    back.load_state_dict(params_from_jax(flat), strict=True)
    for k, t in back.state_dict().items():
        assert torch.equal(t, model.state_dict()[k]), k

    batch = _batch()
    inputs = [batch[k] for k in KEYS[:4]]
    want_up, want_lr = jax.jit(lambda v, *a: JFF(jcfg).apply(v, *a, test_mode=True))(
        _tree(flat), *map(jnp.asarray, inputs))
    with torch.inference_mode():
        got_lr, got = model(*map(torch.from_numpy, inputs))
    assert got.shape == want_up.shape == (B, H, W, 2)
    assert float(np.abs(np.asarray(want_up)).max()) > 5.0  # multi-pixel flow
    _close(got_lr.numpy(), want_lr, 1e-4)
    _close(got.numpy(), want_up, 1e-4)
