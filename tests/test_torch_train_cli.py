"""The training entry point on the CPU, and what it reads and writes.

- `scripts/make_smoke_data.py` writes a tiny FlyingChairs tree; the
  port's `cli.train --yaml configs/smoke_chairs.yaml --device cpu` trains
  its three steps and writes `metrics.jsonl` (validation and final
  entries), `train.log`, `config.yaml`, checkpoints and `smoke_final.npz`.
- The exported `.npz` goes through the port's `cli.evaluate` and into the
  JAX FF-RAFT (`validate_chairs` on the same tree), which agree within
  1e-3 px; the first pair's flow of the two within 1e-3 px.
- A run resumed from a checkpoint (RESTORE_CHECKPOINT) takes the same
  next step as a run that did not stop: the same loss and the same
  parameters, running statistics and optimizer state.
- `params_to_jax(params_from_jax(f))` is `f` on all three fixtures.
- `fetch_dataset` and the `Loader` give the JAX package's first batches,
  bit for bit, for the same seed; mixed resolutions pad as JAX pads.
- LOAD_MODULE: a bare RAFT checkpoint loads into `flow_net`; the trainer
  refuses what it does not have (`--device-aug`, `--multihost`, `no_aug`)
  and builds the other families (FF-FlowFormer from `ff_chairs.yaml`).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import traverse_util

from focusflow_official_tpu.data import datasets as jds
from focusflow_official_tpu.data.loader import Loader as JLoader
from focusflow_official_tpu.models import FFRaft as JFFRaft
from focusflow_official_tpu.models import FFRaftConfig as JConfig
from focusflow_official_tpu.train import evaluate as jev
from focusflow_official_tpu_torch.cli import evaluate as cli_evaluate
from focusflow_official_tpu_torch.cli import train as cli_train
from focusflow_official_tpu_torch.compat.torch_import import load_torch_pretrained
from focusflow_official_tpu_torch.compat.weights import load_npz, params_from_jax, params_to_jax
from focusflow_official_tpu_torch.config import load_yaml_config
from focusflow_official_tpu_torch.data import datasets as tds
from focusflow_official_tpu_torch.data.loader import Loader
from focusflow_official_tpu_torch.data.synthetic import chairs_layout
from focusflow_official_tpu_torch.models import FFRaft, FFRaftConfig
from focusflow_official_tpu_torch.predict import FlowPredictor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
YAML = os.path.join(ROOT, "configs", "smoke_chairs.yaml")


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


@pytest.fixture(scope="module")
def cli_run(smoke_tree, tmp_path_factory):
    logs = tmp_path_factory.mktemp("runs")
    result = cli_train.main([
        "--yaml", YAML, "--data-root", f"chairs={smoke_tree / 'FlyingChairs_release'}",
        "--log-dir", str(logs), "--compute-dtype", "float32", "--val-freq", "2",
        "--corr-impl", "xla", "--gpus", "0", "--profile-dir", str(logs / "trace"),
        "--profile-start", "1", "--profile-steps", "1", "--device", "cpu"])
    return result


def test_cli_trains_checkpoints_and_exports(cli_run):
    run = cli_run["run_dir"]
    assert cli_run["step"] == 3
    assert sorted(os.listdir(run)) == sorted(["checkpoints", "config.yaml", "metrics.jsonl",
                                              "smoke_final.npz", "train.log"])
    assert sorted(os.listdir(os.path.join(run, "checkpoints"))) == ["2.pt", "3.pt"]
    with open(os.path.join(run, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [sorted(r) for r in recs] == [["step", "val/chairs", "val/chairs-orb"],
                                         ["final/chairs", "final/chairs-orb", "step"]]
    assert all(np.isfinite(v) for r in recs for v in r.values())
    assert set(cli_run["metrics"]) >= {"loss", "epe", "1px", "3px", "5px", "kpt_epe",
                                       "grad_norm"}
    ckpt = torch.load(os.path.join(run, "checkpoints", "3.pt"), weights_only=True)
    assert ckpt["step"] == 3 and ckpt["scheduler"]["last_epoch"] == 3
    assert ckpt["generator"] is not None  # ADD_NOISE: the noise generator's state
    trace = os.path.join(os.path.dirname(run), "trace", "steps_1.json")
    with open(trace) as f:  # --profile-dir: a torch.profiler trace of step 1
        assert json.load(f)["traceEvents"]


def test_export_loads_into_the_port_and_jax(cli_run, smoke_tree, capsys, monkeypatch):
    for knob in ("FF_CHUNKED_FNET", "FF_PACKED_CCE", "FF_PACKED_CCE_BN", "FF_PACKED_STEM"):
        monkeypatch.setenv(knob, "0")
    export = cli_run["export"]
    chairs = str(smoke_tree / "FlyingChairs_release")
    got = cli_evaluate.main(["--yaml", YAML, "--checkpoint", export, "--datasets", "chairs",
                             "--data-root", f"chairs={chairs}", "--iters", "4",
                             "--device", "cpu"])
    capsys.readouterr()
    with np.load(export) as raw:
        assert all(raw[k].dtype == np.float32 for k in raw.files)
        variables = traverse_util.unflatten_dict(
            {tuple(k.split("/")): jnp.asarray(raw[k]) for k in raw.files})
    jmodel = JFFRaft(JConfig(fusion="parallel", fusion_type="1x1conv", fuse_cnet=True,
                             corr_impl="xla"))
    ds = jds.FlyingChairs(chairs, str(smoke_tree / "mask" / "FlyingChairs_release"),
                          split="validation", mask_type="orb")
    want = jev.validate_chairs(jmodel, variables, ds, "orb", iters=4)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])
    s = ds[0]
    _, jflow = jmodel.apply(variables, *(jnp.asarray(s[k])[None] for k in
                                         ("image1", "image2", "mask1", "mask2")),
                            iters=4, test_mode=True)
    p = FlowPredictor(FFRaftConfig(fusion="parallel", fuse_cnet=True), export, device="cpu",
                      dtype=torch.float32, iters=4)
    flow = p(s["image1"], s["image2"], s["mask1"], s["mask2"])
    assert float(np.abs(flow - np.asarray(jflow)[0]).max()) <= 1e-3


def _resume_cfg(steps, restore=None):
    cfg = load_yaml_config(YAML)
    cfg.TRAIN.NUM_STEPS = steps
    cfg.TRAIN.RESTORE_CHECKPOINT = restore
    cfg.MODEL.PRETRAIN = os.path.join(FIXTURES, "trained_smoke.npz")
    return cfg


def test_resume_takes_the_same_next_step(tmp_path):
    """A four-step run that checkpoints at step 3 (and at its end) against
    a run restored from that step-3 checkpoint, which takes step 4: the
    same metrics, parameters, running statistics, optimizer state and
    noise generator (the in-memory data has no augmentation)."""
    import shutil

    data = chairs_layout(3, n=4, h=64, w=96)
    run = lambda cfg, d: cli_train.train(cfg, data, validate=lambda m: {},
                                         log_dir=str(tmp_path / d), device="cpu",
                                         compute_dtype="float32", val_freq=3)
    straight = run(_resume_cfg(4), "a")
    ckpts = os.path.join(straight["run_dir"], "checkpoints")
    assert sorted(os.listdir(ckpts)) == ["3.pt", "4.pt"]
    os.makedirs(tmp_path / "restore")
    shutil.copy(os.path.join(ckpts, "3.pt"), tmp_path / "restore" / "3.pt")
    resumed = run(_resume_cfg(4, str(tmp_path / "restore")), "b")
    assert resumed["step"] == straight["step"] == 4
    assert resumed["metrics"] == straight["metrics"]
    want = torch.load(os.path.join(ckpts, "4.pt"), weights_only=True)
    got = torch.load(os.path.join(resumed["run_dir"], "checkpoints", "4.pt"), weights_only=True)
    for k, t in want["model"].items():
        assert torch.equal(got["model"][k], t), k
    for i, st in want["optimizer"]["state"].items():
        for k, t in st.items():
            assert torch.equal(got["optimizer"]["state"][i][k], t), (i, k)
    assert got["scheduler"] == want["scheduler"]
    assert torch.equal(got["generator"], want["generator"])


@pytest.mark.parametrize("name", ["trained_smoke", "trained_smoke_ff", "trained_smoke_pwc"])
def test_params_to_jax_inverts_params_from_jax(name):
    with np.load(os.path.join(FIXTURES, f"{name}.npz")) as raw:
        flat = {k: raw[k] for k in raw.files}
    back = params_to_jax(params_from_jax(flat))
    assert set(back) == set(flat)
    for k, a in flat.items():
        assert back[k].dtype == np.float32 and back[k].shape == a.shape, k
        np.testing.assert_array_equal(back[k], a.astype(np.float32), err_msg=k)


def test_fetch_dataset_and_loader_equal_jax(smoke_tree):
    roots = {"chairs": str(smoke_tree / "FlyingChairs_release")}
    masks = {"chairs": str(smoke_tree / "mask" / "FlyingChairs_release")}
    kw = dict(stage="chairs", image_size=(64, 96), mask_type="orb", train_ds=None, seed=1234)
    ours = Loader(tds.fetch_dataset(roots, masks, **kw), 2, seed=1234, num_workers=1)
    theirs = JLoader(jds.fetch_dataset(roots, masks, **kw), 2, seed=1234, num_workers=1)
    for step, (a, b) in enumerate(zip(ours.batches(start_step=1), theirs.batches(start_step=1))):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (step, k)
        if step == 2:
            break


def test_loader_pads_mixed_resolutions_as_jax():
    rng = np.random.RandomState(0)
    samples = [{"image1": rng.rand(h, w, 3).astype(np.float32),
                "valid": np.ones((h, w), np.float32), "recipe": np.int32(i)}
               for i, (h, w) in enumerate([(5, 7), (6, 4)])]
    ours = Loader(samples, 2)._collate(samples)
    theirs = JLoader(samples, 2)._collate(samples)
    assert sorted(ours) == sorted(theirs) == ["image1", "recipe", "sizes", "valid"]
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_load_module_fills_flow_net(tmp_path):
    """MODEL.LOAD_MODULE: a bare RAFT `.pth` (the flow_net subtree's
    reference keys, `module.`-prefixed) loads into `flow_net`."""
    from focusflow_official_tpu_torch.compat.torch_import import torch_key_for_path

    sd = load_npz(os.path.join(FIXTURES, "trained_smoke.npz"))
    bare = {}
    for key, t in sd.items():
        *comps, leaf = key.split(".")
        coll, fl = {"weight": ("params", "kernel"), "bias": ("params", "bias"),
                    "running_mean": ("batch_stats", "mean"),
                    "running_var": ("batch_stats", "var")}[leaf]
        ref = torch_key_for_path(tuple(comps) + (fl,), coll)
        bare["module." + ref[len("flow_net."):]] = t
    path = tmp_path / "raft.pth"
    torch.save(bare, path)
    model = FFRaft(FFRaftConfig(fusion="parallel", fuse_cnet=True))
    got = load_torch_pretrained(str(path), model, prefix="flow_net.", strict=False)
    for k, t in sd.items():
        assert torch.equal(got[k], t), k


def test_refusals(tmp_path):
    with pytest.raises(NotImplementedError, match="device_aug"):
        cli_train.main(["--yaml", YAML, "--device-aug", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="DDP"):
        cli_train.main(["--yaml", YAML, "--multihost", "--device", "cpu"])
    _, model, _, iters = cli_train.build_model(
        load_yaml_config(os.path.join(ROOT, "configs", "ff-flowformer", "ff_chairs.yaml")),
        "float32")
    assert type(model).__name__ == "FFFlowFormer" and iters == 12
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        tds.fetch_dataset({}, {}, stage="chairs", image_size=(64, 96), no_aug=True)


def test_metrics_logger_jsonl_and_tensorboard(tmp_path, monkeypatch):
    """Running means every SUM_FREQ steps (flushed at step 99 of 100, as
    the JAX logger flushes) and results as they come, in `metrics.jsonl`
    and, with `tensorboard=True`, as TensorBoard scalars (a stand-in
    writer: TensorBoard's own import takes seconds)."""
    import types

    from focusflow_official_tpu_torch.train.metrics import MetricsLogger

    calls = []

    class Writer:
        def __init__(self, log_dir):
            calls.append(("open", log_dir))

        def add_scalar(self, tag, value, step):
            calls.append((tag, value, step))

        def close(self):
            calls.append(("close",))

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(SummaryWriter=Writer))
    log = MetricsLogger(str(tmp_path), YAML, name="t", tensorboard=True)
    for i in range(MetricsLogger.SUM_FREQ):
        log.push({"loss": float(i)})
    log.write_dict({"chairs": 1.5}, prefix="val/")
    log.close()
    with open(os.path.join(log.log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert recs[0]["step"] == 99 and recs[0]["train/loss"] == sum(range(99)) / 100
    assert recs[1] == {"step": 100, "val/chairs": 1.5}
    assert calls[0] == ("open", log.log_dir) and calls[-1] == ("close",)
    assert ("train/loss", sum(range(99)) / 100, 99) in calls and ("val/chairs", 1.5, 100) in calls
    assert os.path.exists(os.path.join(log.log_dir, "config.yaml"))
