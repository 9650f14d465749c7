"""Reference-format `.pth` checkpoints into the port, against the `.npz`
path. For each trained fixture, the JAX package's
`variables_to_torch_state_dict` writes the reference-named state dict; the
port must load it to the same tensors as `load_npz`, bit for bit, through
`FlowPredictor(yaml, path)`: with DDP's `module.` prefix, inside a
`{"model": ...}` checkpoint, and with the shared downsample norm present
only as `downsample.1`. `drop_first_convs` must equal the JAX package's."""

import os

import numpy as np
import pytest
import torch
from flax import traverse_util

from focusflow_official_tpu.compat.torch_import import variables_to_torch_state_dict
from focusflow_official_tpu.train.surgery import drop_first_convs as jax_drop_first_convs
from focusflow_official_tpu_torch.compat.torch_import import (
    drop_first_convs, load_torch_pretrained, state_dict_from_reference)
from focusflow_official_tpu_torch.predict import FlowPredictor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")
CASES = {  # fixture -> the YAML of its configuration
    "trained_smoke.npz": "configs/smoke_chairs.yaml",
    "trained_smoke_ff.npz": "configs/smoke_flowformer.yaml",
    "trained_smoke_pwc.npz": "configs/smoke_pwc.yaml",
}


def _reference_sd(fixture: str) -> dict:
    """The fixture as the reference's state dict (numpy arrays)."""
    with np.load(os.path.join(FIX, fixture)) as raw:
        variables = traverse_util.unflatten_dict(
            {tuple(k.split("/")): raw[k] for k in raw.files})
    return variables_to_torch_state_dict(variables)


def _predictor(fixture: str, weights) -> FlowPredictor:
    return FlowPredictor(os.path.join(ROOT, CASES[fixture]), weights, device="cpu",
                         dtype=torch.float32)


def _assert_bit_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("fixture", sorted(CASES))
def test_reference_pth_loads_bit_equal_to_npz(fixture, tmp_path):
    sd = _reference_sd(fixture)
    path = tmp_path / "ref.pth"
    torch.save({"model": {f"module.{k}": torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in sd.items()}, "step": 700}, path)
    want = _predictor(fixture, os.path.join(FIX, fixture)).model.state_dict()
    _assert_bit_equal(_predictor(fixture, str(path)).model.state_dict(), want)


def test_shared_downsample_norm_read_from_its_alias():
    """`downsample.1` is the reference's name for the same norm as `norm3`:
    with the norm3 / norm4 keys gone, the port reads the alias (the
    batch-norm cnet's stride-2 blocks carry one)."""
    fixture = "trained_smoke.npz"
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in _reference_sd(fixture).items()}
    norm_keys = [k for k in sd if ".norm3." in k or ".norm4." in k]
    alias_keys = [k for k in sd if ".downsample.1." in k]
    assert norm_keys and len(alias_keys) == len(norm_keys)
    p = _predictor(fixture, os.path.join(FIX, fixture))
    for k in norm_keys:
        del sd[k]
    _assert_bit_equal(state_dict_from_reference(sd, p.model), p.model.state_dict())


def test_missing_and_misshapen_keys_raise():
    fixture = "trained_smoke.npz"
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in _reference_sd(fixture).items()}
    model = _predictor(fixture, os.path.join(FIX, fixture)).model
    key = "flow_net.update_block.encoder.convc1.weight"
    short = dict(sd)
    del short[key]
    with pytest.raises(KeyError, match="convc1"):
        state_dict_from_reference(short, model)
    loose = state_dict_from_reference(short, model, strict=False)
    assert torch.equal(loose[key], model.state_dict()[key])
    sd[key] = sd[key][:, :5]
    with pytest.raises(ValueError, match="shape mismatch"):
        state_dict_from_reference(sd, model)


def test_backend_mode_keeps_the_models_first_convs(tmp_path):
    """A bare RAFT checkpoint (keys without `flow_net.`, DDP prefixes)
    loaded into the RAFT core in 'backend' mode: the fnet and cnet conv1
    stay the model's own, every other tensor comes from the file."""
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in _reference_sd("trained_smoke.npz").items()}
    path = tmp_path / "raft.pth.tar"
    torch.save({f"module.{k[len('flow_net.'):]}": v for k, v in sd.items()}, path)
    model = _predictor("trained_smoke.npz", os.path.join(FIX, "trained_smoke.npz")).model
    from_file = {k[len("flow_net."):]: v
                 for k, v in state_dict_from_reference(sd, model).items()}
    core = model.flow_net
    with torch.no_grad():
        for name in ("fnet", "cnet"):
            getattr(core, name).conv1.weight.add_(1.0)  # differ from the file
    own = {k: v.clone() for k, v in core.state_dict().items()}
    got = load_torch_pretrained(str(path), core, backend=True)
    first = {f"{n}.conv1.{leaf}" for n in ("fnet", "cnet") for leaf in ("weight", "bias")}
    assert first <= got.keys() and got.keys() == from_file.keys()
    for k, v in got.items():
        assert torch.equal(v, own[k] if k in first else from_file[k]), k
    assert not torch.equal(own["fnet.conv1.weight"], from_file["fnet.conv1.weight"])


def test_drop_first_convs_equals_jax():
    keys = ["module.fnet.conv1.weight", "fnet.conv1.bias", "cnet.conv1.weight",
            "module.cnet.conv1.bias", "fnet.layer1.0.conv1.weight", "flow_net.fnet.conv1.weight",
            "fnet.conv2.weight", "update_block.mask.0.weight"]
    sd = {k: i for i, k in enumerate(keys)}
    assert drop_first_convs(sd) == jax_drop_first_convs(sd)
    assert set(drop_first_convs(sd)) == set(keys[4:])


def test_orbax_directory_and_unknown_files_are_refused(tmp_path):
    yaml = os.path.join(ROOT, "configs/smoke_chairs.yaml")
    with pytest.raises(ValueError, match="export_fixture.py"):
        FlowPredictor(yaml, str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match=r"\.npz"):
        FlowPredictor(yaml, str(tmp_path / "weights.ckpt"), device="cpu")
