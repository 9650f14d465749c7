"""The port's YAML readers against the JAX package's, on every YAML file
under `configs/`: where the port has the variant a file selects, its
config equals the JAX config on every field both have (exact: the same
parsed values); where it does not, the reader raises NotImplementedError
with its reason (the ROADMAP item that brings the variant, or that the JAX
package cannot run it either). Every file under
`configs/` has its variant in the port."""

import dataclasses
import glob
import os

import pytest

from focusflow_official_tpu import config as jcfg
from focusflow_official_tpu_torch import config as tcfg
from focusflow_official_tpu_torch.models import FFPWCNetConfig, FFRaftConfig, FlowFormerConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(os.path.relpath(p, ROOT)
               for p in glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True))

# the files whose variant the port lacks, and why: none
UNSUPPORTED = {}


def _jax_config(cfg, family):
    if family == "flowformer":
        return jcfg.flowformer_config_from_yaml(cfg)
    return jcfg.model_config_from_yaml(cfg)


def test_every_config_file_is_listed():
    assert len(YAMLS) == 59 and set(UNSUPPORTED) <= set(YAMLS)


@pytest.mark.parametrize("path", YAMLS)
def test_yaml_reads_as_jax_or_is_refused(path):
    cfg = tcfg.load_yaml_config(os.path.join(ROOT, path))
    family = tcfg.detect_family(cfg)
    assert family == jcfg.detect_family(jcfg.load_yaml_config(os.path.join(ROOT, path)))
    if path in UNSUPPORTED:
        with pytest.raises(NotImplementedError, match=UNSUPPORTED[path]) as e:
            tcfg.config_from_yaml(cfg)
        assert "JAX package" in str(e.value) or "ROADMAP.md" in str(e.value)
        return
    ours = tcfg.config_from_yaml(cfg)
    assert type(ours) is {"raft": FFRaftConfig, "pwcnet": FFPWCNetConfig,
                          "flowformer": FlowFormerConfig}[family]
    theirs = _jax_config(cfg, family)
    shared = ({f.name for f in dataclasses.fields(ours)}
              & {f.name for f in dataclasses.fields(theirs)})
    assert len(shared) >= 7, shared
    for name in sorted(shared):
        assert getattr(ours, name) == getattr(theirs, name), name
    model, iters = tcfg.model_from_config(ours)
    assert iters == {"raft": getattr(ours, "iters", None), "pwcnet": None,
                     "flowformer": getattr(ours, "decoder_depth", None)}[family]


@pytest.mark.parametrize("key,value", [
    ("SMALL", True), ("ALT_CORR", True), ("FUSION", "attention"), ("FUSION", "conv"),
    ("DROPOUT", 0.1)])
def test_raft_variants_are_refused(key, value):
    """A dropout above 0 is refused by the reader; the small model, ALT_CORR
    and the two front ends serve (`test_raft_variants_are_accepted`), and
    the trainer refuses them, each naming the ROADMAP item that brings it."""
    from focusflow_official_tpu_torch.cli import train as cli_train

    cfg = tcfg.load_yaml_config(os.path.join(ROOT, "configs/smoke_chairs.yaml"))
    setattr(cfg.MODEL, key, value)
    if key == "DROPOUT":
        with pytest.raises(NotImplementedError, match=key) as e:
            tcfg.config_from_yaml(cfg)
        assert "ROADMAP.md queue 1, 'Dropout'" in str(e.value)
        return
    tcfg.config_from_yaml(cfg)
    with pytest.raises(NotImplementedError, match=key) as e:
        cli_train.build_model(cfg, "float32")
    assert "ROADMAP.md queue 1, 'Training the FF-RAFT variants'" in str(e.value)


@pytest.mark.parametrize("key,value", [
    ("FUSE_CNET", False), ("FUSION", None), ("FUSION_TYPE", "SA"), ("ABANDON_FNET", True),
    ("FUSION_TYPE", "CA"), ("FUSION_TYPE", "concat"), ("SMALL", True), ("ALT_CORR", True),
    ("FUSION", "attention"), ("FUSION", "conv"), ("FUSION_CHANNEL", 64)])
def test_raft_variants_are_accepted(key, value):
    """Plain RAFT, the unfused context encoder, ChannelProject, the fusion
    ablation's units, the small model, ALT_CORR and the attention and conv
    front ends (`FUSION_CHANNEL` wide): the fields equal JAX's and the
    model builds."""
    cfg = tcfg.load_yaml_config(os.path.join(ROOT, "configs/smoke_chairs.yaml"))
    setattr(cfg.MODEL, key, value)
    ours = tcfg.config_from_yaml(cfg)
    theirs = jcfg.model_config_from_yaml(cfg)
    field = {"FUSE_CNET": "fuse_cnet", "FUSION": "fusion", "FUSION_TYPE": "fusion_type",
             "ABANDON_FNET": "abandon_fnet", "SMALL": "small", "ALT_CORR": "alt_corr",
             "FUSION_CHANNEL": "fusion_channel"}[key]
    assert getattr(ours, field) == getattr(theirs, field) == value
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    model, iters = tcfg.model_from_config(ours)
    assert type(model).__name__ == "FFRaft" and iters == ours.iters


@pytest.mark.parametrize("key,value", [
    ("use_mlp", True), ("gma", False), ("vertical_conv", True), ("only_global", True),
    ("cost_heads_num", 2), ("patch_size", 4), ("pe", "exp"), ("cost_encoder_res", False),
    ("add_flow_token", False), ("feat_cross_attn", True), ("dropout", 0.1)])
def test_flowformer_variants_are_refused(key, value):
    """The variants the JAX package runs read into a config with the field
    set, as JAX reads them, and the model builds; more than one cost head,
    `pe` other than 'linear', `feat_cross_attn` and dropout are still
    refused, each with its reason."""
    cfg = tcfg.load_yaml_config(os.path.join(ROOT, "configs/smoke_flowformer.yaml"))
    setattr(cfg.MODEL, key, value)
    reasons = {"cost_heads_num": "JAX package cannot run it either",
               "pe": "never uses it", "feat_cross_attn": "JAX package raises on it",
               "dropout": "ROADMAP.md queue 1, 'Dropout'"}
    if key in reasons:
        with pytest.raises(NotImplementedError, match=key) as e:
            tcfg.config_from_yaml(cfg)
        assert reasons[key] in str(e.value)
        return
    ours = tcfg.config_from_yaml(cfg)
    theirs = jcfg.flowformer_config_from_yaml(cfg)
    assert getattr(ours, key) == getattr(theirs, key) == value
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    model, _ = tcfg.model_from_config(ours)
    assert type(model).__name__ == "FFFlowFormer"


@pytest.mark.parametrize("key,value", [("FUSION", None)])
def test_flowformer_variants_are_accepted(key, value):
    """Vanilla FlowFormer: the fields equal JAX's and the model is
    `FlowFormer`."""
    cfg = tcfg.load_yaml_config(os.path.join(ROOT, "configs/smoke_flowformer.yaml"))
    setattr(cfg.MODEL, key, value)
    ours = tcfg.config_from_yaml(cfg)
    theirs = jcfg.flowformer_config_from_yaml(cfg)
    assert ours.fusion == theirs.fusion == value
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    model, _ = tcfg.model_from_config(ours)
    assert type(model).__name__ == "FlowFormer"


def test_compute_dtype():
    cfg = tcfg.load_yaml_config(os.path.join(ROOT, "configs/smoke_pwc.yaml"))
    assert tcfg.config_from_yaml(cfg, compute_dtype="bfloat16").compute_dtype == "bfloat16"
    assert tcfg.config_from_yaml(cfg).compute_dtype == "float32"


def test_port_imports_without_cv2_pil_yaml():
    """The card machine has no cv2 (nor, maybe, PIL or PyYAML): every module
    of the port imports with them blocked, and a YAML read then says what
    it lacks."""
    import subprocess
    import sys

    code = ("import importlib, pkgutil, sys\n"
            "for m in ('cv2', 'PIL', 'yaml'):\n"
            "    sys.modules[m] = None\n"
            "import focusflow_official_tpu_torch as pkg\n"
            "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
            "assert pkg.__name__ + '.cli.evaluate' in names, names\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "from focusflow_official_tpu_torch.config import load_yaml_config\n"
            "try:\n"
            "    load_yaml_config('configs/smoke_chairs.yaml')\n"
            "except ImportError as e:\n"
            "    print('refused', e)\n"
            "from focusflow_official_tpu_torch.data.io import write_flow_kitti\n"
            "try:\n"
            "    write_flow_kitti('x.png', None)\n"
            "except ImportError as e:\n"
            "    print('refused', e)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120,
                         capture_output=True, text=True).stdout
    assert out.count("refused") == 2 and "OpenCV" in out, out
