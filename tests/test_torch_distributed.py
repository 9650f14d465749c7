"""Data parallelism (`train/mesh.py`) on the CPU: a step of two gloo
processes against one process on the global batch, and against the JAX
package's sharded step.

Two processes (this file run as a script, `_worker`) join a gloo group
through a `file://` store under the test's directory, with a timeout of
their own; the parent waits for them under a deadline and kills them
past it, so a hang fails the tests instead of stalling the suite. Each
rank takes rows rank, rank + 2, ... of the global batch (the loader's
stride), one thread each.

Against one process, on the same weights and global batch (B=4 at 64x96),
each step one `train/loop.py::train_step` with the gradients summed by
`Mesh.all_reduce_grads` and AdamW after the clip, the model in f64 (its
batch norms' statistics f32, as they ship, from sums accumulated in f64:
the one process through the identity, the ranks through the gloo sum):
- `raft`: `configs/smoke_chairs.yaml` (FF-RAFT, the cnet's batch norm in
  train mode, MixLoss, noise on), fresh weights from a seed, keypoint
  masks whose sums differ between the ranks' halves (rank 1's rows carry a
  tenth of rank 0's);
- `raft_aug`: the same on raw 80x112 frames with the on-card augmentation
  (in f32, as it ships; its output goes to the model in f64);
- `raft_dropout`: `raft` at MODEL.DROPOUT 0.2, the keep masks drawn for
  the global batch on every rank, each keeping its rows;
- `pwc`: `configs/smoke_pwc.yaml` with TRAIN.STAGE kitti, so the
  multiscale MixLoss is the sparse form (valid counts, mask mass and the
  batch as denominators), on sparse flow.
Bounds: the loss and every metric within 1e-5 relative; the flat
gradient with cosine >= 0.99999, and each tensor's max |diff| within 1e-4
of its largest magnitude (measured: 2.8e-6). A gradient that is zero but
for rounding (the biases in front of a norm, whose shift the norm takes
out: 60 tensors of FF-RAFT, at most 1.6e-8 of the model's largest
gradient, where the smallest other tensor's largest is 6.7e-6 of it) has
no largest magnitude to be relative to: such a tensor, at most `ZERO` of
the model's largest gradient, is held to `ZERO` of it. In f32 the
comparison sat up to 5.6e-3 of a cnet weight's own largest gradient
apart (with the batch norms' sums taken in f32): the backward through the
nearly constant features of the fresh mask branch amplifies f32
rounding. The parameters after the step and the running statistics
within 1e-4 of each tensor's largest magnitude, except that Adam's first
step is lr x g / (|g| + eps), about lr x sign(g): where a gradient lies
within its tensor's bound of 0 its sign is rounding, and the step may
differ by 2 x lr there; both ranks hold the same parameters. The trainer (`cli/train.py::train`) on two ranks, BATCH_SIZE
3 (rounded up to 4), takes the one-process run's losses at each step, and
only rank 0 writes a run directory.

Against JAX: the trained fixture's FF-RAFT, 2 refinements, MixLoss at
JAX's defaults, no noise; JAX's `make_train_step` on a 2-device CPU mesh
(`make_mesh`, `replicate`, `put_batch`) against the two ranks: the loss
within 1e-5 relative, the gradients (read from JAX's Adam state, as
`test_torch_train_step.py` does) with cosine >= 0.9999 and each tensor's
within 5% of its norm, the batch statistics within 1e-5 of their scale.
The f32 gradients of this network sit that far apart in either package
(`test_torch_train_step.py`'s docstring): on this batch one port process
against JAX's unsharded step differs by up to 3.5% of a tensor's norm
(the fnet's mask branch, layer 3), and the two ranks against JAX's
sharded step by as much; the 3% bound of the one-process test is set on
its own batch.
"""

import datetime
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "trained_smoke.npz")
CASES = ("raft", "raft_aug", "raft_dropout", "pwc")
B, H, W, WORLD, LR = 4, 64, 96, 2, 4e-4
ZERO = 1e-7  # a gradient this far under the model's largest is rounding
DEADLINE_S = 240


def _cfg(case):
    from focusflow_official_tpu_torch.config import load_yaml_config

    cfg = load_yaml_config(os.path.join(ROOT, "configs", "smoke_pwc.yaml" if case == "pwc"
                                        else "smoke_chairs.yaml"))
    if case == "pwc":
        cfg.TRAIN.STAGE = "kitti"
    else:
        cfg.MODEL.ITERS = 2
    if case == "raft_dropout":
        cfg.MODEL.DROPOUT = 0.2
    return cfg


def _global_batch(case):
    """The global batch as numpy: chairs-like pairs (raw 80x112 for
    `raft_aug`, sparse flow for `pwc`); the odd rows (rank 1's) keep a
    tenth of their keypoints."""
    from focusflow_official_tpu_torch.data.synthetic import chairs_layout

    h, w = (80, 112) if case == "raft_aug" else (H, W)
    ds = chairs_layout(11, n=B, h=h, w=w)
    keys = ("image1", "image2", "mask1", "mask2", "flow", "valid")
    batch = {k: np.stack([ds[i][k] for i in range(B)]).astype(np.float32) for k in keys}
    rng = np.random.RandomState(1)
    for k in ("mask1", "mask2"):
        batch[k][1::2] *= rng.rand(*batch[k][1::2].shape) < 0.1
    if case == "pwc":
        batch["valid"] = (rng.rand(B, h, w) < 0.3).astype(np.float32)
        batch["flow"] *= batch["valid"][..., None]
    if case == "raft_aug":
        batch["sizes"] = np.tile([[h, w]], (B, 1)).astype(np.int32)
        batch["recipe"] = np.zeros(B, np.int32)
    return batch


def _f64(batch):
    return {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}


def _step(case, mesh):
    """One step of `case` with the model in f64 -> metrics, the clipped
    gradients, the state after the step (parameters and running
    statistics). The augmentation (`raft_aug`) runs in f32, as it ships,
    and its output goes to the model in f64."""
    import focusflow_official_tpu_torch.models.ff_raft as ff_raft
    from focusflow_official_tpu_torch.cli.train import build_model
    from focusflow_official_tpu_torch.data.device_aug import DeviceFlowAugmentor, dense_recipe
    from focusflow_official_tpu_torch.train.loop import build_optimizer, train_step

    cfg = _cfg(case)
    torch.manual_seed(0)
    _, model, loss_fn, iters = build_model(cfg, "float32", mesh)
    model.double().train()
    opt = build_optimizer(model, LR)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda _: 1.0)
    rows = slice(None) if mesh is None else slice(mesh.rank, None, mesh.world)
    batch = {k: torch.from_numpy(v[rows]) for k, v in _global_batch(case).items()}
    aug = DeviceFlowAugmentor((H, W), recipes=[dense_recipe(-0.1, 1.0)])
    saved = ff_raft.DTYPES["float32"]
    ff_raft.DTYPES["float32"] = torch.float64
    try:
        m = train_step(model, opt, sched, loss_fn, batch if case == "raft_aug" else _f64(batch),
                       iters=iters, clip=1.0, noise=torch.Generator().manual_seed(5),
                       augment=(lambda gen, b, **kw: _f64(aug(gen, b, **kw)))
                       if case == "raft_aug" else None,
                       aug_gen=torch.Generator().manual_seed(6), mesh=mesh,
                       dropout=torch.Generator().manual_seed(7))
    finally:
        ff_raft.DTYPES["float32"] = saved
    return dict(metrics={k: float(v) for k, v in m.items()},
                grads={n: p.grad.clone() for n, p in model.named_parameters()},
                state={k: v.clone() for k, v in model.state_dict().items()})


def _trainer(mesh, log_dir):
    """Three steps of the trainer on six in-memory pairs, BATCH_SIZE 3 ->
    the metrics of each step and the run directory."""
    from focusflow_official_tpu_torch.cli.train import train
    from focusflow_official_tpu_torch.data.synthetic import chairs_layout

    cfg = _cfg("raft")
    cfg.TRAIN.BATCH_SIZE = 3 if mesh is not None else 4
    torch.manual_seed(0)
    steps = []
    out = train(cfg, chairs_layout(12, n=6, h=H, w=W), validate=lambda model: {},
                log_dir=log_dir, device="cpu", compute_dtype="float32", val_freq=2, mesh=mesh,
                on_step=lambda step, metrics: steps.append(metrics))
    return dict(steps=steps, run_dir=out["run_dir"])


def _jax_case_port(mesh):
    """The port's side of the JAX comparison -> (metrics, gradients, state)."""
    from focusflow_official_tpu_torch.compat.weights import load_npz
    from focusflow_official_tpu_torch.losses import build_sequence_loss
    from focusflow_official_tpu_torch.models import FFRaft, FFRaftConfig
    from focusflow_official_tpu_torch.train.loop import build_optimizer, train_step
    from focusflow_official_tpu_torch.train.mesh import sync_batch_norms

    model = FFRaft(FFRaftConfig(fusion="parallel", fuse_cnet=True, iters=2,
                                compute_dtype="float32"))
    model.load_state_dict(load_npz(FIXTURE), strict=True)
    sync_batch_norms(model, mesh.differentiable_sum)
    model.train()
    opt = build_optimizer(model, LR)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda _: 1.0)
    batch = {k: torch.from_numpy(v[mesh.rank::mesh.world])
             for k, v in _global_batch("raft").items()}
    m = train_step(model, opt, sched, build_sequence_loss("MixLoss", reduce=mesh.global_sum),
                   batch, iters=2, clip=1.0, mesh=mesh)
    return dict(metrics={k: float(v) for k, v in m.items()},
                grads={n: p.grad.clone() for n, p in model.named_parameters()},
                state={k: v.clone() for k, v in model.state_dict().items()})


def _worker(rank: int, store: str, out_dir: str) -> None:
    import torch.distributed as dist

    from focusflow_official_tpu_torch.train.mesh import Mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    mesh = Mesh(rank, WORLD, torch.device("cpu"))
    try:
        out = {case: _step(case, mesh) for case in CASES}
        out["jax"] = _jax_case_port(mesh)
        out["trainer"] = _trainer(mesh, os.path.join(out_dir, f"runs{rank}"))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results; the processes start before the one-process
    references are computed here and are waited for after."""
    out = tmp_path_factory.mktemp("dist")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = []
    for r in range(WORLD):
        with open(out / f"rank{r}.log", "wb") as log:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, str(r), str(out / "store"), str(out)],
                env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT))
    yield procs, out
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def one_process(ranks, tmp_path_factory):
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = {case: _step(case, None) for case in CASES}
        out["trainer"] = _trainer(None, str(tmp_path_factory.mktemp("runs")))
    finally:
        torch.set_num_threads(saved)
    return out


@pytest.fixture(scope="module")
def results(ranks, one_process):
    procs, out = ranks
    t_end = time.monotonic() + DEADLINE_S
    for p in procs:
        try:
            p.wait(timeout=max(1.0, t_end - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"the ranks did not finish within {DEADLINE_S} s")
    for r, p in enumerate(procs):
        log = (out / f"rank{r}.log").read_text()[-4000:]
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    return [torch.load(out / f"rank{r}.pt", weights_only=True) for r in range(WORLD)]


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_take_the_global_loss_and_metrics(results, one_process, case):
    want = one_process[case]["metrics"]
    for r in range(WORLD):
        got = results[r][case]["metrics"]
        assert sorted(got) == sorted(want)
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-5 * max(abs(want[k]), 1e-6), (r, k, got[k], want[k])


def _grad_bounds(grads) -> dict:
    """Each tensor's bound on its gradient's max |diff|: 1e-4 of its
    largest magnitude, or, for a gradient that is zero but for rounding
    (its largest at most `ZERO` of the model's largest), `ZERO` of the
    model's largest."""
    top = max(float(g.abs().max()) for g in grads.values())
    own = {n: float(g.abs().max()) for n, g in grads.items()}
    return {n: ZERO * top if own[n] <= ZERO * top else 1e-4 * own[n] for n in grads}


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_sum_the_global_gradient(results, one_process, case):
    want = one_process[case]["grads"]
    got = results[0][case]["grads"]
    flat_g = torch.cat([got[n].flatten() for n in sorted(want)])
    flat_w = torch.cat([want[n].flatten() for n in sorted(want)])
    assert float(torch.nn.functional.cosine_similarity(flat_g, flat_w, dim=0)) >= 0.99999
    for n, bound in _grad_bounds(want).items():
        err = float((got[n] - want[n]).abs().max())
        assert err <= bound, (n, err, bound)
        assert torch.equal(results[1][case]["grads"][n], got[n]), n


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_step_and_statistics_as_one_process(results, one_process, case):
    """Parameters after one AdamW step and the batch norms' running
    statistics; Adam's first step moves a parameter by about lr x sign(g),
    so where g is within the gradient bound of 0 the step may differ by
    2 x lr."""
    want, grads = one_process[case]["state"], one_process[case]["grads"]
    bounds = _grad_bounds(grads)
    got = results[0][case]["state"]
    assert sorted(got) == sorted(want)
    for k, t in want.items():
        assert torch.equal(results[1][case]["state"][k], got[k]), k  # the ranks agree
        diff = (got[k] - t).abs()
        tol = 1e-4 * max(float(t.abs().max()), 1e-30)
        if k in grads:
            tiny = grads[k].abs() <= bounds[k]
            diff = torch.where(tiny, torch.clamp(diff - 2 * LR, min=0.0), diff)
        assert float(diff.max()) <= tol, (k, float(diff.max()), tol)


def test_sum_form_batch_statistics_match_torch():
    """A train-mode batch norm (the one form: sum, count and centred second
    moment, through the identity on one process) against torch's
    `F.batch_norm` in training mode on one process: the output and the
    running averages within f32 rounding, on features far from zero
    mean."""
    import torch.nn.functional as F

    from focusflow_official_tpu_torch.nn.norm import Norm

    g = torch.Generator().manual_seed(0)
    x = torch.randn((4, 16, 12, 10), generator=g) * 0.3 + 50.0
    norm = Norm("batch", 16).train()
    with torch.no_grad():
        norm.weight.uniform_(0.5, 1.5, generator=g)
        norm.bias.uniform_(-0.5, 0.5, generator=g)
    run_mean, run_var = norm.running_mean.clone(), norm.running_var.clone()
    want = F.batch_norm(x, run_mean, run_var, norm.weight.detach(), norm.bias.detach(),
                        training=True, momentum=0.1, eps=norm.eps)
    got = norm(x)
    for a, b in ((got, want), (norm.running_mean, run_mean), (norm.running_var, run_var)):
        assert float((a.detach() - b).abs().max()) <= 1e-4 * max(1.0, float(b.abs().max()))


def test_trainer_on_two_ranks_takes_the_one_process_steps(results, one_process):
    want = one_process["trainer"]["steps"]
    assert len(want) == 3
    for r in range(WORLD):
        got = results[r]["trainer"]["steps"]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"]), (r, a, b)
    run0, run1 = (results[r]["trainer"]["run_dir"] for r in range(WORLD))
    assert run1 is None and os.path.isdir(run0)
    assert sorted(os.listdir(os.path.join(run0, "checkpoints"))) == ["2.pt", "3.pt"]
    assert not os.path.exists(os.path.join(os.path.dirname(os.path.dirname(run0)), "runs1"))


def test_two_ranks_equal_jax_sharded_step(results):
    """JAX's `make_train_step` over a 2-device mesh against the ranks."""
    import jax
    import jax.numpy as jnp
    import optax
    from flax import traverse_util

    from focusflow_official_tpu.losses import build_sequence_loss as jax_loss
    from focusflow_official_tpu.models import FFRaft as JFFRaft
    from focusflow_official_tpu.models import FFRaftConfig as JConfig
    from focusflow_official_tpu.train.loop import build_optimizer as jax_optimizer
    from focusflow_official_tpu.train.loop import create_train_state, make_train_step
    from focusflow_official_tpu.train.mesh import make_mesh, put_batch, replicate
    from focusflow_official_tpu_torch.compat.weights import params_from_jax

    flat = lambda tree, coll: {f"{coll}/" + "/".join(k): np.asarray(v)
                               for k, v in traverse_util.flatten_dict(tree).items()}
    with np.load(FIXTURE) as raw:
        v = traverse_util.unflatten_dict(
            {tuple(k.split("/")): jnp.asarray(raw[k], jnp.float32) for k in raw.files})
    batch = {k: a for k, a in _global_batch("raft").items()}
    model = JFFRaft(JConfig(fusion="parallel", fuse_cnet=True, iters=2,
                            compute_dtype="float32", corr_impl="xla"))
    tx = jax_optimizer(lambda _: LR, weight_decay=1e-5, clip=1.0)
    state = create_train_state(model, jax.random.PRNGKey(0),
                               {k: jnp.asarray(a) for k, a in batch.items()}, tx)
    state = state.replace(params=v["params"], batch_stats=v["batch_stats"],
                          opt_state=tx.init(v["params"]))
    mesh = make_mesh(jax.devices()[:WORLD])
    state = jax.device_put(state, replicate(mesh))
    step = make_train_step(jax_loss("MixLoss"), iters=2, add_noise=False)
    state, m = step(state, put_batch(batch, mesh), jax.random.PRNGKey(0))
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    want_g = params_from_jax({k: a / 0.1 for k, a in flat(adam.mu, "params").items()})
    want_s = params_from_jax(flat(state.batch_stats, "batch_stats"))

    got = results[0]["jax"]
    assert abs(got["metrics"]["loss"] - float(m["loss"])) <= 1e-5 * abs(float(m["loss"]))
    assert abs(got["metrics"]["epe"] - float(m["epe"])) <= 1e-5 * abs(float(m["epe"]))
    names = sorted(want_g)
    flat_g = torch.cat([got["grads"][n].flatten() for n in names]).double()
    flat_w = torch.cat([want_g[n].flatten() for n in names]).double()
    assert float(torch.nn.functional.cosine_similarity(flat_g, flat_w, dim=0)) >= 0.9999
    top = float(flat_w.abs().max())
    for n in names:
        err = float((got["grads"][n] - want_g[n]).norm())
        assert err <= 5e-2 * float(want_g[n].norm()) + 1e-6 * top, n
    for k, t in want_s.items():
        scale = max(1.0, float(t.abs().max()))
        assert float((got["state"][k] - t).abs().max()) <= 1e-5 * scale, k


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
