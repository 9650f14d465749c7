"""The training entry point for FF-PWCNet and FF-FlowFormer on the CPU,
and the weights and parameter groups it starts from.

- `cli.train --yaml configs/smoke_pwc.yaml` and
  `configs/smoke_flowformer.yaml` over `scripts/make_smoke_data.py`'s tree
  train their two steps and write `metrics.jsonl`, `train.log`,
  `config.yaml`, checkpoints and `<NAME>_final.npz`. The export loads into
  the JAX package's model, whose flow on a validation pair agrees with the
  port's predictor on the same export within 1e-3 px (f32 both; FF-RAFT's
  CLI bound).
- A run resumed from a checkpoint (RESTORE_CHECKPOINT) takes the same next
  step as one that did not stop, for both families.
- `build_model` picks the family, its loss and its refinement count.
- MODEL.LOAD_MODULE for PWC-Net (a vanilla PWC-Net `.pth`, over the whole
  model, what it lacks kept) and FF-FlowFormer's MODEL.load_former (a
  FlowFormer `.pth` without the mask towers) give the JAX loader's
  weights, to the bit.
- `encoder_lr_labels` equals JAX's labels; TRAINER.twins_lr_factor puts
  the Twins towers into an 'encoder' group at lr x the factor.
- `compat/timm_twins.py` maps a timm Twins state dict (`tests/fake_timm.py`)
  as JAX's converter does, to the bit.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from focusflow_official_tpu.cli.train import load_torch_pretrained as jax_load_pth
from focusflow_official_tpu.compat.timm_twins import timm_twins_to_variables
from focusflow_official_tpu.data import datasets as jds
from focusflow_official_tpu.models import FFPWCNet as JFFPWCNet
from focusflow_official_tpu.models import FFRaftConfig as JRaftConfig
from focusflow_official_tpu.models.ff_flowformer import FFFlowFormer as JFF
from focusflow_official_tpu.models.ff_flowformer import FlowFormerConfig as JFFConfig
from focusflow_official_tpu.train import surgery as jsurgery
from focusflow_official_tpu_torch.cli import train as cli_train
from focusflow_official_tpu_torch.compat.timm_twins import timm_twins_to_state_dict
from focusflow_official_tpu_torch.compat.torch_import import torch_key_for_path
from focusflow_official_tpu_torch.compat.weights import load_npz, params_from_jax, params_to_jax
from focusflow_official_tpu_torch.config import load_yaml_config
from focusflow_official_tpu_torch.data.synthetic import chairs_layout
from focusflow_official_tpu_torch.models import (FFFlowFormer, FFPWCNet, FFPWCNetConfig,
                                                 FlowFormerConfig, PWCNet)
from focusflow_official_tpu_torch.nn.twins import TwinsSVT2StageCCE
from focusflow_official_tpu_torch.predict import FlowPredictor
from focusflow_official_tpu_torch.train import surgery
from focusflow_official_tpu_torch.train.loop import build_optimizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
FAMILIES = {
    "pwc": dict(yaml=os.path.join(ROOT, "configs", "smoke_pwc.yaml"), name="smoke-pwc",
                fixture=os.path.join(FIXTURES, "trained_smoke_pwc.npz")),
    "flowformer": dict(yaml=os.path.join(ROOT, "configs", "smoke_flowformer.yaml"),
                       name="smoke-ff", fixture=os.path.join(FIXTURES, "trained_smoke_ff.npz")),
}
_KNOBS = ("FF_DEC_CHUNK", "FF_PALLAS_LSA", "FF_PALLAS_ATTN", "FF_FAST_GELU", "FF_PE_FOLD")
_LEAVES = {"weight": ("params", "kernel"), "bias": ("params", "bias")}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs its files in parallel worker
    processes, and torch's default of a thread a core in each of them
    oversubscribes the CPU many times over (these tests train on it)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def smoke_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("smoke")
    subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "make_smoke_data.py"),
                    str(root)], cwd=ROOT, check=True, timeout=300, capture_output=True)
    return root


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def cli_run(request, smoke_tree, tmp_path_factory):
    fam = FAMILIES[request.param]
    result = cli_train.main([
        "--yaml", fam["yaml"], "--data-root",
        f"chairs={smoke_tree / 'FlyingChairs_release'}", "--log-dir",
        str(tmp_path_factory.mktemp("runs")), "--compute-dtype", "float32", "--val-freq", "1",
        "--device", "cpu"])
    return request.param, result


def test_cli_trains_checkpoints_and_exports(cli_run):
    family, result = cli_run
    run, name = result["run_dir"], FAMILIES[family]["name"]
    assert result["step"] == 2
    assert sorted(os.listdir(run)) == sorted(["checkpoints", "config.yaml", "metrics.jsonl",
                                              f"{name}_final.npz", "train.log"])
    assert sorted(os.listdir(os.path.join(run, "checkpoints"))) == ["1.pt", "2.pt"]
    with open(os.path.join(run, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    val = [["step", "val/chairs", "val/chairs-orb"]] if family == "pwc" else [["step"]]
    final = [["final/chairs", "final/chairs-orb", "step"]] if family == "pwc" else [["step"]]
    assert [sorted(r) for r in recs] == val * 2 + final
    assert all(np.isfinite(v) for r in recs for v in r.values())
    want = {"loss", "epe", "grad_norm"} | ({"1px", "3px", "5px", "kpt_epe"}
                                          if family == "flowformer" else set())
    assert set(result["metrics"]) == want
    assert all(np.isfinite(v) for v in result["metrics"].values())
    ckpt = torch.load(os.path.join(run, "checkpoints", "2.pt"), weights_only=True)
    assert ckpt["step"] == 2 and ckpt["scheduler"]["last_epoch"] == 2


def test_export_loads_into_jax(cli_run, smoke_tree):
    family, result = cli_run
    with np.load(result["export"]) as raw:
        assert all(raw[k].dtype == np.float32 for k in raw.files)
        variables = traverse_util.unflatten_dict(
            {tuple(k.split("/")): jnp.asarray(raw[k]) for k in raw.files})
    chairs = str(smoke_tree / "FlyingChairs_release")
    s = jds.FlyingChairs(chairs, str(smoke_tree / "mask" / "FlyingChairs_release"),
                         split="validation", mask_type="orb")[0]
    inputs = [s[k] for k in ("image1", "image2", "mask1", "mask2")]
    if family == "pwc":
        jmodel = JFFPWCNet(JRaftConfig(fusion="parallel", fusion_type="1x1conv",
                                       corr_impl="xla"))
        jflow = jax.jit(lambda v, *a: jmodel.apply(v, *a, test_mode=True))(
            variables, *(jnp.asarray(a)[None] for a in inputs))
        cfg = FFPWCNetConfig()
    else:
        with pytest.MonkeyPatch.context() as mp:
            for knob in _KNOBS:
                mp.delenv(knob, raising=False)
            jmodel = JFF(JFFConfig(encoder_depth=1, decoder_depth=2, corr_impl="xla"))
            jflow, _ = jax.jit(lambda v, *a: jmodel.apply(v, *a, test_mode=True))(
                variables, *(jnp.asarray(a)[None] for a in inputs))
        cfg = FlowFormerConfig(encoder_depth=1, decoder_depth=2)
    p = FlowPredictor(cfg, result["export"], device="cpu", dtype=torch.float32)
    flow = p(*inputs)
    assert flow.shape == np.asarray(jflow)[0].shape
    assert float(np.abs(flow - np.asarray(jflow)[0]).max()) <= 1e-3


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_resume_takes_the_same_next_step(family, tmp_path):
    """A three-step run that checkpoints at step 2 against a run restored
    from that checkpoint, which takes step 3: the same metrics, parameters,
    optimizer state and noise generator."""
    import shutil

    fam = FAMILIES[family]

    def cfg_for(restore=None):
        cfg = load_yaml_config(fam["yaml"])
        cfg.TRAIN.NUM_STEPS = 3
        cfg.TRAIN.RESTORE_CHECKPOINT = restore
        cfg.MODEL.PRETRAIN = fam["fixture"]
        return cfg

    data = chairs_layout(3, n=4, h=64, w=96)
    run = lambda cfg, d: cli_train.train(cfg, data, validate=lambda m: {},
                                         log_dir=str(tmp_path / d), device="cpu",
                                         compute_dtype="float32", val_freq=2)
    straight = run(cfg_for(), "a")
    ckpts = os.path.join(straight["run_dir"], "checkpoints")
    assert sorted(os.listdir(ckpts)) == ["2.pt", "3.pt"]
    os.makedirs(tmp_path / "restore")
    shutil.copy(os.path.join(ckpts, "2.pt"), tmp_path / "restore" / "2.pt")
    resumed = run(cfg_for(str(tmp_path / "restore")), "b")
    assert resumed["step"] == straight["step"] == 3
    assert resumed["metrics"] == straight["metrics"]
    want = torch.load(os.path.join(ckpts, "3.pt"), weights_only=True)
    got = torch.load(os.path.join(resumed["run_dir"], "checkpoints", "3.pt"), weights_only=True)
    for k, t in want["model"].items():
        assert torch.equal(got["model"][k], t), k
    for i, st in want["optimizer"]["state"].items():
        for k, t in st.items():
            assert torch.equal(got["optimizer"]["state"][i][k], t), (i, k)
    assert torch.equal(got["generator"], want["generator"])


@pytest.mark.parametrize("path,model_type,iters,loss", [
    ("ff-pwcnet/ffpwc_chairs.yaml", FFPWCNet, None, "multiscale_mix_loss"),
    ("ff-pwcnet/pwc_chairs.yaml", PWCNet, None, "multiscale_epe_loss"),
    ("ff-pwcnet/ffpwc_kitti.yaml", FFPWCNet, None, "multiscale_mix_loss"),
    ("ff-flowformer/ff_chairs.yaml", FFFlowFormer, 12, "mix_loss"),
    ("smoke_flowformer.yaml", FFFlowFormer, 2, "mix_loss"),
])
def test_build_model_picks_the_family(path, model_type, iters, loss):
    cfg = load_yaml_config(os.path.join(ROOT, "configs", path))
    _, model, loss_fn, got_iters = cli_train.build_model(cfg, "float32")
    assert type(model) is model_type and got_iters == iters
    assert loss_fn.func.__name__ == loss
    if "weights" in loss_fn.keywords:  # the multiscale loss: sparse targets at the kitti stage
        assert loss_fn.keywords["sparse"] == (cfg.TRAIN.STAGE == "kitti")


def _reference_pth(sd, path, keep):
    """The port's state dict `sd` as a reference checkpoint (reference keys,
    DDP's `module.` prefix) of the keys `keep(reference_key)` accepts."""
    ref = {}
    for key, t in sd.items():
        *comps, leaf = key.split(".")
        coll, fl = _LEAVES.get(leaf, ("params", leaf))
        rk = torch_key_for_path(tuple(comps) + (fl,), coll)
        if keep(rk):
            ref["module." + rk] = t * 1.5 + 0.25  # not the fixture's values
    torch.save(ref, path)
    return ref


def _jax_load(path, template_sd):
    """JAX's loader on `path` into the variables of `template_sd` -> the port's names."""
    template = traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(a) for k, a in params_to_jax(template_sd).items()})
    template.setdefault("batch_stats", {})
    v = jax_load_pth(str(path), template, strict=False)
    return params_from_jax({"/".join(k): np.asarray(a)
                            for k, a in traverse_util.flatten_dict(v).items()})


def test_load_module_pwc_equals_jax(tmp_path):
    """A vanilla PWC-Net `.pth` (no mask pyramid, no fusion units) loads over
    the whole model: the decoders, the refiner and the extractor's image
    pyramid take its weights, the mask pyramid and the fusion units keep
    theirs; JAX's loader gives the same tensors."""
    path = tmp_path / "pwcnet-chairs.pth"
    _reference_pth(load_npz(FAMILIES["pwc"]["fixture"]), path,
                   lambda rk: "mask_" not in rk and "fusion" not in rk)
    torch.manual_seed(0)
    model = FFPWCNet(FFPWCNetConfig())
    fresh = {k: t.clone() for k, t in model.state_dict().items()}
    cfg = load_yaml_config(FAMILIES["pwc"]["yaml"])
    cfg.MODEL.LOAD_MODULE = str(path)
    cli_train.load_initial_weights(cfg, model)
    got = model.state_dict()
    want = _jax_load(path, fresh)
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["netSix.netOne_0.weight"], (
        load_npz(FAMILIES["pwc"]["fixture"])["netSix.netOne_0.weight"] * 1.5 + 0.25))
    assert torch.equal(got["netExtractor.fusion1.img2mask.conv.weight"],
                       fresh["netExtractor.fusion1.img2mask.conv.weight"])


def test_load_former_equals_jax(tmp_path):
    """MODEL.load_former: a FlowFormer `.pth` without the CCE mask towers
    and fusion units loads over the whole model, what it lacks kept, as
    JAX's loader loads it."""
    path = tmp_path / "chairs.pth"
    _reference_pth(load_npz(FAMILIES["flowformer"]["fixture"]), path,
                   lambda rk: "mask_svt" not in rk and "fusion_blks" not in rk)
    torch.manual_seed(0)
    model = FFFlowFormer(FlowFormerConfig(encoder_depth=1, decoder_depth=2))
    fresh = {k: t.clone() for k, t in model.state_dict().items()}
    cfg = load_yaml_config(FAMILIES["flowformer"]["yaml"])
    cfg.MODEL.load_former = str(path)
    cli_train.load_initial_weights(cfg, model)
    got = model.state_dict()
    want = _jax_load(path, fresh)
    changed = 0
    for k in got:
        assert torch.equal(got[k], want[k]), k
        changed += not torch.equal(got[k], fresh[k])
    kept = [k for k in got if torch.equal(got[k], fresh[k])]
    assert changed > 250 and kept and all("mask_" in k or "fusion_blks" in k for k in kept)


def _ff_names_and_jax_params():
    with np.load(FAMILIES["flowformer"]["fixture"]) as raw:
        flat = {k: raw[k] for k in raw.files}
    names = dict(zip(flat, params_from_jax(flat)))
    params = traverse_util.unflatten_dict(
        {tuple(k.split("/")[1:]): v for k, v in flat.items() if k.startswith("params/")})
    return names, params


def test_encoder_lr_labels_equal_jax():
    names, params = _ff_names_and_jax_params()
    want = {names["params/" + "/".join(k)]: lbl for k, lbl in
            traverse_util.flatten_dict(jsurgery.encoder_lr_labels(params)).items()}
    assert surgery.encoder_lr_labels(want) == want
    assert want["context_encoder_svt.blocks_0_0.attn.qkv.weight"] == "encoder"
    assert want["memory_encoder.feat_encoder_svt.mask_patch_embeds_0.proj.weight"] == "encoder"
    assert want["memory_encoder.channel_convertor.weight"] == "trainable"
    assert want["memory_decoder.update_block.gru.convz1.weight"] == "trainable"


def test_twins_lr_factor_groups():
    """TRAINER.twins_lr_factor: the towers' parameters in one 'encoder'
    group at lr x the factor, the rest at lr; FREEZE_MODULE over both."""
    cfg = load_yaml_config(FAMILIES["flowformer"]["yaml"])
    cfg.TRAINER.twins_lr_factor = 0.25
    model = FFFlowFormer(FlowFormerConfig(encoder_depth=1, decoder_depth=2))
    labels, factor = cli_train.param_labels(cfg, model)
    assert factor == 0.25 and labels == surgery.encoder_lr_labels(labels)
    opt = build_optimizer(model, 1e-3, labels=labels, encoder_lr_factor=factor)
    groups = {g["label"]: g for g in opt.param_groups}
    assert sorted(groups) == ["encoder", "trainable"]
    assert groups["encoder"]["lr"] == pytest.approx(2.5e-4) and groups["trainable"]["lr"] == 1e-3
    enc = {id(p) for p in groups["encoder"]["params"]}
    assert enc == {id(p) for n, p in model.named_parameters() if labels[n] == "encoder"}
    cfg.MODEL.FREEZE_MODULE = True
    frozen, _ = cli_train.param_labels(cfg, model)
    assert frozen["context_encoder_svt.blocks_0_0.attn.qkv.weight"] == "encoder"
    assert cli_train.param_labels(load_yaml_config(FAMILIES["flowformer"]["yaml"]),
                                  model) == (None, 0.1)


@pytest.mark.parametrize("mask_branch", [False, True])
def test_timm_twins_equals_jax(mask_branch):
    from fake_timm import create_model

    torch.manual_seed(1)
    timm_sd = create_model("twins_svt_large").state_dict()
    template = TwinsSVT2StageCCE().state_dict()
    got = timm_twins_to_state_dict(timm_sd, template, mask_branch=mask_branch)
    jax_template = traverse_util.unflatten_dict(
        {tuple(k.split("/")[1:]): jnp.asarray(a)
         for k, a in params_to_jax(template).items()})
    jv = timm_twins_to_variables({k: v.numpy() for k, v in timm_sd.items()}, jax_template,
                                 mask_branch=mask_branch)
    want = params_from_jax({"params/" + "/".join(k): np.asarray(a)
                            for k, a in traverse_util.flatten_dict(jv).items()})
    assert set(got) == set(want) == set(template)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["blocks_1_1.attn.kv.weight"], timm_sd["blocks.1.1.attn.kv.weight"])
    assert torch.equal(got["mask_blocks_0_0.attn.qkv.weight"],
                       timm_sd["blocks.0.0.attn.qkv.weight"]) == mask_branch
