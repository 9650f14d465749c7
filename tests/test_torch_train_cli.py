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
- LOAD_MODULE: a bare RAFT checkpoint loads into `flow_net` (the main
  model's, RAFT-S's and a front end's); the trainer
  refuses an unknown stage and `device_aug` over samples without a recipe
  table, and builds the other families (FF-FlowFormer from
  `ff_chairs.yaml`).
- Every FF-RAFT variant trains: `configs/smoke_chairs.yaml` with SMALL,
  ALT_CORR, FUSION attention or conv, or DROPOUT set runs two f32 steps on
  in-memory pairs, every metric finite, and exports JAX's variable names
  and shapes for that configuration.
- `device_aug` on raw in-memory frames: a run resumed from a checkpoint
  takes the same next step, the augmentation's generator restored with
  the noise's.
- `--multihost --device-aug` at world size 1 over gloo (torchrun's
  variables set by the test) trains, writes its run directory and leaves
  no process group behind; the global batch rounds up to the ranks.
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
    sd = load_npz(os.path.join(FIXTURES, "trained_smoke.npz"))
    model = FFRaft(FFRaftConfig(fusion="parallel", fuse_cnet=True))
    _hold_load_module(sd, model, tmp_path)


@pytest.mark.parametrize("kw", [dict(fusion=None, small=True),
                                dict(fusion="conv", fusion_channel=16)],
                         ids=["raft_s", "conv"])
def test_load_module_fills_a_variants_flow_net(kw, tmp_path):
    """LOAD_MODULE into RAFT-S's `flow_net` and into the RAFT behind the conv
    front end: every `flow_net` tensor is the file's, `fusion_layer` keeps
    its own."""
    g = torch.Generator().manual_seed(0)
    model = FFRaft(FFRaftConfig(**kw))
    sd = {k: torch.randn(t.shape, generator=g) for k, t in model.state_dict().items()
          if k.startswith("flow_net.")}
    before = {k: t.clone() for k, t in model.state_dict().items()
              if k.startswith("fusion_layer.")}
    got = _hold_load_module(sd, model, tmp_path)
    for k, t in before.items():
        assert torch.equal(got[k], t), k


def _hold_load_module(sd, model, tmp_path):
    """`sd` (flow_net's tensors by port name) written as a bare RAFT `.pth`
    and loaded with prefix 'flow_net.': every tensor lands -> the state."""
    from focusflow_official_tpu_torch.compat.torch_import import torch_key_for_path

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
    got = load_torch_pretrained(str(path), model, prefix="flow_net.", strict=False)
    for k, t in sd.items():
        assert torch.equal(got[k], t), k
    return got


VARIANTS = {"SMALL": dict(SMALL=True), "ALT_CORR": dict(ALT_CORR=True),
            "attention": dict(FUSION="attention", FUSION_CHANNEL=16),
            "conv": dict(FUSION="conv", FUSION_CHANNEL=16, SEPARATE_LR=True),
            "DROPOUT": dict(DROPOUT=0.2)}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_trainer_trains_every_raft_variant(name, tmp_path):
    """`cli/train.py::train` refuses no FF-RAFT variant: two f32 steps from
    PyTorch's initialisation on in-memory pairs (the conv front end with
    TRAIN.SEPARATE_LR), every metric finite, and the export's flat names
    and shapes those of JAX's variables for the configuration."""
    import jax

    cfg = load_yaml_config(YAML)
    cfg.TRAIN.NUM_STEPS = 2
    cfg.MODEL.ITERS = 2
    for k, v in VARIANTS[name].items():
        setattr(cfg.TRAIN if k == "SEPARATE_LR" else cfg.MODEL, k, v)
    torch.manual_seed(0)
    out = cli_train.train(cfg, chairs_layout(2, n=2, h=64, w=96), validate=lambda m: {},
                          log_dir=str(tmp_path), device="cpu", compute_dtype="float32")
    assert out["step"] == 2 and all(np.isfinite(v) for v in out["metrics"].values())
    with np.load(out["export"]) as raw:
        got = {k: raw[k].shape for k in raw.files}
    from focusflow_official_tpu_torch.config import config_from_yaml

    mcfg = config_from_yaml(cfg)
    jcfg = JConfig(**{f: getattr(mcfg, f) for f in (
        "fusion", "fusion_type", "fusion_channel", "small", "fuse_cnet", "alt_corr",
        "alt_corr_chunk", "dropout", "mask_channel")}, iters=2, corr_impl="xla")
    x, m = jnp.zeros((1, 64, 96, 3)), jnp.zeros((1, 64, 96, 1))
    tree = jax.eval_shape(lambda: JFFRaft(jcfg).init(jax.random.PRNGKey(0), x, x, m, m,
                                                     iters=1, test_mode=True))
    want = {k: v.shape for k, v in traverse_util.flatten_dict(tree, sep="/").items()}
    assert got == want


def test_refusals(tmp_path):
    _, model, _, iters = cli_train.build_model(
        load_yaml_config(os.path.join(ROOT, "configs", "ff-flowformer", "ff_chairs.yaml")),
        "float32")
    assert type(model).__name__ == "FFFlowFormer" and iters == 12
    with pytest.raises(NotImplementedError, match="Stage"):
        tds.fetch_dataset({}, {}, stage="virtual_kitti", image_size=(64, 96), no_aug=True)
    with pytest.raises(ValueError, match="device_recipes"):
        cli_train.train(_resume_cfg(1), chairs_layout(0, n=2, h=64, w=96),
                        validate=lambda m: {}, log_dir=str(tmp_path), device="cpu",
                        compute_dtype="float32", device_aug=True)


def _raw_chairs():
    """Raw 80x112 frames tagged for the chairs recipe, as
    `fetch_dataset(stage="chairs", no_aug=True)` gives them."""
    from focusflow_official_tpu_torch.data.device_aug import dense_recipe

    ds = tds.RecipeTagged(chairs_layout(5, n=4, h=80, w=112), 0)
    ds.device_recipes = [dense_recipe(-0.1, 1.0)]
    return ds


def test_device_aug_resume_reproduces_the_augmentation(tmp_path):
    """`device_aug` on raw frames: a four-step run that checkpoints at
    step 3 against one restored from that checkpoint, which must draw the
    same augmentation (and noise) for step 4: the same metrics, parameters
    and both generators' states."""
    import shutil

    data = _raw_chairs()
    run = lambda cfg, d: cli_train.train(cfg, data, validate=lambda m: {},
                                         log_dir=str(tmp_path / d), device="cpu",
                                         compute_dtype="float32", val_freq=3, device_aug=True)
    straight = run(_resume_cfg(4), "a")
    ckpts = os.path.join(straight["run_dir"], "checkpoints")
    os.makedirs(tmp_path / "restore")
    shutil.copy(os.path.join(ckpts, "3.pt"), tmp_path / "restore" / "3.pt")
    resumed = run(_resume_cfg(4, str(tmp_path / "restore")), "b")
    assert resumed["step"] == straight["step"] == 4
    assert resumed["metrics"] == straight["metrics"]
    assert all(np.isfinite(v) for v in straight["metrics"].values())
    want = torch.load(os.path.join(ckpts, "4.pt"), weights_only=True)
    got = torch.load(os.path.join(resumed["run_dir"], "checkpoints", "4.pt"), weights_only=True)
    for k, t in want["model"].items():
        assert torch.equal(got["model"][k], t), k
    three = torch.load(os.path.join(ckpts, "3.pt"), weights_only=True)
    assert not torch.equal(three["aug_generator"], want["aug_generator"])  # step 4 drew
    for key in ("generator", "aug_generator"):
        assert torch.equal(got[key], want[key]), key


def test_multihost_world_size_one_over_gloo(smoke_tree, tmp_path, monkeypatch):
    """The launch line's path, `--multihost --device-aug`, as one process
    of torchrun's (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT set here) on
    the CPU: gloo, the raw smoke tree augmented in the step, the run
    directory written, the process group destroyed at the end."""
    import socket

    import torch.distributed as dist

    from focusflow_official_tpu_torch.train.mesh import round_batch

    assert [round_batch(b, n) for b, n in ((3, 2), (10, 4), (4, 2), (6, 1))] == [4, 12, 4, 6]
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                     MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    result = cli_train.main([
        "--yaml", YAML, "--data-root", f"chairs={smoke_tree / 'FlyingChairs_release'}",
        "--log-dir", str(tmp_path), "--compute-dtype", "float32", "--val-freq", "100",
        "--multihost", "--device-aug", "--device", "cpu"])
    assert not dist.is_initialized()
    assert result["step"] == 3 and all(np.isfinite(v) for v in result["metrics"].values())
    assert sorted(os.listdir(result["run_dir"])) == sorted(
        ["checkpoints", "config.yaml", "metrics.jsonl", "smoke_final.npz", "train.log"])
    ckpt = torch.load(os.path.join(result["run_dir"], "checkpoints", "3.pt"), weights_only=True)
    assert ckpt["aug_generator"] is not None


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
