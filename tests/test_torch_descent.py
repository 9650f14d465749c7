"""The descent gate of `chip_smoke.py`'s training phases, on the CPU at a
reduced size (`ffraft_chairs_orb.yaml`'s FF-RAFT, 2 refinements, two
64x96 pairs), with the one summation form the port keeps (every mean a
sum over a count, the batch norms' statistics as sums):

- the measure (`_fixed_batch_loss`) is the fixed batch's loss of an f32
  copy of the model in train mode, with no noise, and leaves the model's
  running statistics as they were;
- JAX's descent recipe (`_descent_recipe`: fresh weights, 16 bf16 steps at
  a constant lr of 1e-4) passes the gate: the loss after the last step
  under `DESCENT_BOUND` x the loss before the first.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from focusflow_official_tpu_torch.cli.train import build_model
from focusflow_official_tpu_torch.config import load_yaml_config
from focusflow_official_tpu_torch.data.synthetic import chairs_layout
from focusflow_official_tpu_torch.train.loop import forward_loss

KEYS = ("image1", "image2", "mask1", "mask2", "flow", "valid")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _cfg():
    cfg = load_yaml_config(chip_smoke.TRAIN_YAML)
    cfg.MODEL.ITERS = 2
    return cfg


def test_fixed_batch_loss_is_the_f32_train_mode_loss():
    cfg, data = _cfg(), chairs_layout(5, n=2, h=64, w=96)
    torch.manual_seed(0)
    _, model, loss_fn, iters = build_model(cfg, "bfloat16")
    model.train()
    before = {k: t.clone() for k, t in model.state_dict().items()}
    got = chip_smoke._fixed_batch_loss(torch, model, cfg, data)
    for k, t in model.state_dict().items():
        assert torch.equal(t, before[k]), k
    _, f32, loss_fn, iters = build_model(cfg, "float32")
    f32.load_state_dict(before)
    batch = {k: torch.as_tensor(np.stack([data[i][k] for i in range(2)])) for k in KEYS}
    with torch.no_grad():
        want, _ = forward_loss(f32.train(), loss_fn, batch, iters=iters)
    assert got == float(want)


def test_descent_recipe_passes_the_gate():
    out = chip_smoke._descent_recipe(torch, "cpu", _cfg(), chairs_layout(5, n=2, h=64, w=96),
                                     device="cpu")
    assert len(out["recipe_losses"]) == chip_smoke.TRAIN_STEPS
    assert out["ratio"] == out["loss_after"] / out["loss_before"] < chip_smoke.DESCENT_BOUND
