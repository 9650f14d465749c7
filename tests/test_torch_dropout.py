"""Dropout of the FF-RAFT family (MODEL.DROPOUT; `nn/dropout.py`), on the CPU:

- the draw: over 10^4 channels the kept share within 4 sigma of 1 - p;
  kept channels scaled by exactly 1 / (1 - p), the others 0; under data
  parallelism each rank's rows of the global batch's draw;
- no draw in eval mode (the generator untouched, the forward that of the
  model without dropout), and a train-mode forward without masks raises;
- the dropout generator's state round-tripped through a checkpoint: a
  run resumed from step 3 takes step 4's masks, as the run that did not
  stop;
- the port's train step on the JAX package's own masks against JAX's
  `make_train_step` (FF-RAFT on the trained fixture and RAFT-S on
  `variant_weights`, DROPOUT 0.2) with the first-step bounds of
  `tests/test_torch_train_step.py`: a tensor past 3% of its norm (at 0.2,
  FF-RAFT's fnet `fusion1.img2mask` bias sits 4.5% from JAX's, whose own
  f32 gradient there moves with its thread count) no farther from the
  port's f64 run than JAX's, as that file holds every tensor; and the step
  without dropout moves the encoders' gradients by more than 10%. JAX's masks are recovered from its
  train-mode forward under the step's dropout key with
  `capture_intermediates`: a channel of a sample whose `Dropout` output is
  zero everywhere while its input is not was dropped.

`tests/test_torch_distributed.py` (`raft_dropout`) holds two gloo ranks'
dropout against one process's on the global batch.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from focusflow_official_tpu.models import FFRaft as JFFRaft
from focusflow_official_tpu.models import FFRaftConfig as JConfig
from focusflow_official_tpu_torch.compat.weights import load_npz, params_to_jax
from focusflow_official_tpu_torch.models import FFRaft, FFRaftConfig
from focusflow_official_tpu_torch.nn import dropout as channel_dropout
from focusflow_official_tpu_torch.train import loop
from test_torch_train_raft_variants import (FIXTURE, ITERS, KEYS, ROOT, _tree, batch,
                                            f64_grads, hold_first_step, jax_run, port_run,
                                            variant_weights)
from test_torch_train_raft_variants import _two_threads  # noqa: F401  (autouse fixtures)

P = 0.2
CASES = {"ff_raft": dict(fusion="parallel", fuse_cnet=True, dropout=P),
         "raft_s": dict(fusion=None, small=True, dropout=P)}


def test_draw_keeps_one_minus_p_and_scales_exactly():
    gen = torch.Generator().manual_seed(0)
    keep = channel_dropout.draw(gen, P, 2, 50, 100)
    assert keep.shape == (100, 100) and keep.dtype == torch.bool
    share = float(keep.float().mean())
    sigma = (P * (1 - P) / keep.numel()) ** 0.5
    assert abs(share - (1 - P)) <= 4 * sigma, share
    x = torch.ones((100, 100, 3, 5))
    y = channel_dropout.apply(x, keep, P)
    scale = torch.tensor(1.0 / (1.0 - P), dtype=torch.float32)
    assert torch.equal(y, torch.where(keep[:, :, None, None], scale, 0.0).expand_as(y))


def test_draw_keeps_the_ranks_rows_of_the_global_batch():
    """Two ranks' draws (world 2) are the rows rank, rank + 2, ... of each
    frame of one process's draw for the global batch."""
    whole = channel_dropout.draw(torch.Generator().manual_seed(3), P, 2, 4, 16)
    for rank in range(2):
        got = channel_dropout.draw(torch.Generator().manual_seed(3), P, 2, 2, 16,
                                   world=2, rank=rank)
        want = whole.reshape(2, 4, 16)[:, rank::2].reshape(4, 16)
        assert torch.equal(got, want)


def test_no_draw_in_eval_mode():
    """Serving and evaluation never draw: in eval mode `draw_dropout` leaves
    the generator as it was and the forward is the model's without
    dropout; in train mode the model's sites are the fnet (both frames) and
    the cnet, and a forward without masks raises."""
    sd = load_npz(FIXTURE)
    models = [FFRaft(FFRaftConfig(fusion="parallel", fuse_cnet=True, iters=ITERS, dropout=p))
              for p in (P, 0.0)]
    for m in models:
        m.load_state_dict(sd, strict=True)
    model = models[0]
    gen = torch.Generator().manual_seed(1)
    state = gen.get_state()
    assert loop.draw_dropout(model.eval(), gen, 2) == {}
    assert torch.equal(gen.get_state(), state)
    b = {k: torch.from_numpy(a) for k, a in batch().items()}
    with torch.no_grad():
        got = model(*(b[k] for k in KEYS[:4]))
        want = models[1].eval()(*(b[k] for k in KEYS[:4]))
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert models[1].dropout_sites() == {}
    model.train()
    assert model.dropout_sites() == {"fnet": (2, 256), "cnet": (1, 256)}
    masks = loop.draw_dropout(model, gen, 2)
    assert {k: tuple(v.shape) for k, v in masks.items()} == {"fnet": (4, 256), "cnet": (2, 256)}
    with pytest.raises(ValueError, match="keep masks"):
        model(*(b[k] for k in KEYS[:4]))


def test_dropout_generator_round_trips_through_a_checkpoint(tmp_path):
    """A four-step run at DROPOUT 0.2 that checkpoints at step 3 against a
    run restored from that checkpoint: the same step 4 (metrics, weights)
    and the same dropout generator, which step 4 moved."""
    import shutil

    from focusflow_official_tpu_torch.cli import train as cli_train
    from focusflow_official_tpu_torch.config import load_yaml_config
    from focusflow_official_tpu_torch.data.synthetic import chairs_layout

    def cfg(restore=None):
        c = load_yaml_config(os.path.join(ROOT, "configs", "smoke_chairs.yaml"))
        c.TRAIN.NUM_STEPS, c.TRAIN.RESTORE_CHECKPOINT = 4, restore
        c.MODEL.PRETRAIN, c.MODEL.DROPOUT, c.MODEL.ITERS = FIXTURE, P, ITERS
        return c

    data = chairs_layout(3, n=4, h=64, w=96)
    run = lambda c, d: cli_train.train(c, data, validate=lambda m: {},
                                       log_dir=str(tmp_path / d), device="cpu",
                                       compute_dtype="float32", val_freq=3)
    straight = run(cfg(), "a")
    ckpts = os.path.join(straight["run_dir"], "checkpoints")
    os.makedirs(tmp_path / "restore")
    shutil.copy(os.path.join(ckpts, "3.pt"), tmp_path / "restore" / "3.pt")
    resumed = run(cfg(str(tmp_path / "restore")), "b")
    assert resumed["metrics"] == straight["metrics"]
    want = torch.load(os.path.join(ckpts, "4.pt"), weights_only=True)
    got = torch.load(os.path.join(resumed["run_dir"], "checkpoints", "4.pt"), weights_only=True)
    three = torch.load(os.path.join(ckpts, "3.pt"), weights_only=True)
    assert not torch.equal(three["dropout_generator"], want["dropout_generator"])
    assert torch.equal(got["dropout_generator"], want["dropout_generator"])
    for k, t in want["model"].items():
        assert torch.equal(got["model"][k], t), k


def _weights(name):
    return load_npz(FIXTURE) if name == "ff_raft" else variant_weights(CASES[name])


def _jax_masks(kw: dict, sd: dict, rng) -> dict:
    """JAX's dropout keep masks of its train-mode forward under `rng` (the
    step's dropout key) -> {"fnet": (2B, C), "cnet": (B, C)} bool."""
    model = JFFRaft(JConfig(iters=ITERS, corr_impl="xla", **kw))
    b = batch()
    _, inter = jax.jit(lambda v, *a: model.apply(
        v, *a, iters=ITERS, train=True, mutable=["batch_stats", "intermediates"],
        capture_intermediates=True, rngs={"dropout": rng}))(
        _tree(params_to_jax(sd)), *(jnp.asarray(b[k]) for k in KEYS[:4]))
    flat = traverse_util.flatten_dict(inter["intermediates"]["flow_net"], sep="/")
    masks = {}
    for site in ("fnet", "cnet"):
        out = np.asarray(flat[f"{site}/Dropout_0/__call__"][0])
        src = flat.get(f"{site}/conv2/__call__")
        inp = np.asarray(src[0] if src is not None else flat[f"{site}/fusion5/__call__"][0][1])
        zero_out, zero_in = (np.all(a == 0, axis=(1, 2)) for a in (out, inp))
        assert not zero_in.any()  # every channel tells its mask
        masks[site] = torch.from_numpy(~zero_out)
    return masks


@pytest.mark.parametrize("name", sorted(CASES))
def test_step_on_jax_masks_matches_jax(name, monkeypatch):
    """One step at DROPOUT 0.2: JAX's `make_train_step` under PRNGKey(0)
    against the port's `train_step` given the masks JAX drew there."""
    kw, sd = CASES[name], _weights(name)
    key = jax.random.PRNGKey(0)
    masks = _jax_masks(kw, sd, jax.random.split(key, 5)[4])  # make_train_step's rng_drop
    for site, keep in masks.items():
        share = float(keep.float().mean())
        assert 0.6 < share < 0.95, (site, share)
    jm, jg, _ = jax_run(kw, sd, 1, rngs=[key])
    drawn = []

    def jax_drawn(model, gen, n, **shard):
        drawn.append(n)
        return masks

    monkeypatch.setattr(loop, "draw_dropout", jax_drawn)
    tm, tg, _, _ = port_run(kw, sd, 1, dropout=torch.Generator())
    assert drawn == [2]
    hold_first_step(tm, tg, jm, jg, f64_grads(kw, sd, masks))
    monkeypatch.undo()
    # and the masks matter: without dropout the encoders' gradients are others
    _, tg0, _, _ = port_run({**kw, "dropout": 0.0}, sd, 1)
    moved = max(float((tg0[n] - jg[n]).norm()) / float(jg[n].norm())
                for n in jg if ".fnet." in n or ".cnet." in n)
    assert moved > 0.1, moved
