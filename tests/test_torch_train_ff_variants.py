"""One train step of FF-FlowFormer's variant forms in the port against the
JAX package's `train/loop.py::make_train_step`, in f32 on the CPU, for
each of `TRAIN_FORMS`: the combined form (MLP-Mixer latent layers,
ConvNext vertical layers, no GMA) and patch size 4 (`"patch4"` of
`test_torch_ff_variants.py`, every other field at its default); two
samples of the multi-pixel affine input (`data/synthetic.py`) at 64x64,
encoder depth 1, 2 refinements, the sequence MixLoss of
`configs/smoke_flowformer.yaml`, AdamW with global clip 1.0 under
OneCycle (4e-4 over 103 steps), no noise; the weights
`test_torch_ff_variants.py` draws, carried to JAX by `params_to_jax`.

Bounds, those of `test_torch_train_flowformer.py`: the loss and `epe`
within 1e-5 relative; the flat gradient's cosine >= 0.9999, each tensor
within 3% of its norm plus 1e-6 of the largest gradient (JAX's gradients
read from its Adam state: after one update mu = (1 - b1) x the clipped
gradient). And the trainer's body runs a YAML with every variant field
set.
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
from focusflow_official_tpu.models.ff_flowformer import FFFlowFormer as JFF
from focusflow_official_tpu.train.loop import TrainState, make_train_step
from focusflow_official_tpu.train.loop import build_optimizer as jax_optimizer
from focusflow_official_tpu.train.schedule import one_cycle_lr
from focusflow_official_tpu_torch.compat.weights import params_from_jax, params_to_jax
from focusflow_official_tpu_torch.losses import build_sequence_loss
from focusflow_official_tpu_torch.models import FFFlowFormer
from focusflow_official_tpu_torch.train.loop import build_optimizer, train_step
from focusflow_official_tpu_torch.train.schedule import one_cycle
from test_torch_ff_variants import (
    ITERS, VARIANTS, _batch, _configs, _no_tpu_knobs, _seeded, _tree)
from test_torch_ff_variants import _two_threads  # noqa: F401  (autouse fixtures)

LR, TOTAL, WD, EPS, CLIP = 4e-4, 103, 1e-5, 1e-8, 1.0
LOSS = dict(kernel_size=1, sigma=0.01, lamda=1.0)  # configs/smoke_flowformer.yaml
TRAIN_FORMS = {"combined": dict(use_mlp=True, vertical_conv=True, gma=False),
               "patch4": VARIANTS["patch4"]}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("form", list(TRAIN_FORMS))
def test_variant_train_step_matches_jax(form):
    tcfg, jcfg = _configs(TRAIN_FORMS[form])
    model = _seeded(FFFlowFormer(tcfg)).train()
    flat = params_to_jax(model.state_dict())
    v = _tree(flat)
    tx = jax_optimizer(one_cycle_lr(LR, TOTAL), weight_decay=WD, epsilon=EPS, clip=CLIP)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"], batch_stats={},
                       opt_state=tx.init(v["params"]), apply_fn=JFF(jcfg).apply, tx=tx)
    step = make_train_step(jax_loss("MixLoss", **LOSS), iters=ITERS, add_noise=False)
    state, m = step(state, {k: jnp.asarray(a) for k, a in _batch().items()},
                    jax.random.PRNGKey(0))
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    jg = params_from_jax({"params/" + "/".join(k): np.asarray(a) / 0.1
                          for k, a in traverse_util.flatten_dict(adam.mu).items()})
    jm = {k: float(x) for k, x in m.items()}

    opt = build_optimizer(model, LR, weight_decay=WD, epsilon=EPS)
    tm = train_step(model, opt, one_cycle(opt, TOTAL), build_sequence_loss("MixLoss", **LOSS),
                    {k: torch.from_numpy(a) for k, a in _batch().items()}, iters=ITERS,
                    clip=CLIP)
    for k in ("loss", "epe"):
        assert abs(float(tm[k]) - jm[k]) <= 1e-5 * abs(jm[k]), (k, float(tm[k]), jm[k])
    tg = {n: p.grad.clone() for n, p in model.named_parameters()}
    assert set(tg) == set(jg)
    if not TRAIN_FORMS[form].get("gma", True):
        assert not any(".att." in n or "aggregator" in n for n in tg)
    flat_t = torch.cat([tg[n].flatten() for n in sorted(tg)]).double()
    flat_j = torch.cat([jg[n].flatten() for n in sorted(tg)]).double()
    assert float(torch.nn.functional.cosine_similarity(flat_t, flat_j, dim=0)) >= 0.9999
    top = float(flat_j.abs().max())
    for n in tg:
        err = float((tg[n] - jg[n]).norm())
        assert err <= 3e-2 * float(jg[n].norm()) + 1e-6 * top, n


def test_trainer_runs_every_variant_field(tmp_path):
    """The trainer's body (`cli/train.py::train`) refuses none of the
    variants: `configs/smoke_flowformer.yaml` with every variant field set
    against its default (no GMA, MLP-Mixer, ConvNext, only-global, patch
    size 4, no encoder residual, no flow token) trains two f32 steps on
    the CPU from PyTorch's initialisation, every metric finite, and its
    export carries JAX's flat names for that configuration."""
    from focusflow_official_tpu.models.ff_flowformer import FlowFormerConfig as JConfig
    from focusflow_official_tpu_torch import config as tconfig
    from focusflow_official_tpu_torch.cli import train as cli_train
    from focusflow_official_tpu_torch.data.synthetic import chairs_layout

    form = dict(gma=False, use_mlp=True, vertical_conv=True, only_global=True, patch_size=4,
                cost_encoder_res=False, add_flow_token=False)
    cfg = tconfig.load_yaml_config(os.path.join(ROOT, "configs", "smoke_flowformer.yaml"))
    for k, v in form.items():
        setattr(cfg.MODEL, k, v)
    cfg.TRAIN.IMAGE_SIZE = [64, 64]
    torch.manual_seed(0)
    out = cli_train.train(cfg, chairs_layout(2, n=2, h=64, w=64), validate=lambda m: {},
                          log_dir=str(tmp_path), device="cpu", compute_dtype="float32")
    assert out["step"] == 2 and all(np.isfinite(float(v)) for v in out["metrics"].values())
    with np.load(out["export"]) as raw:
        names = set(raw.files)
    x, m = jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 64, 64, 1))
    jcfg = JConfig(encoder_depth=1, decoder_depth=2, corr_impl="xla", **form)
    tree = jax.eval_shape(lambda: JFF(jcfg).init(jax.random.PRNGKey(0), x, x, m, m,
                                                 test_mode=True))
    assert names == set(traverse_util.flatten_dict(tree, sep="/"))
