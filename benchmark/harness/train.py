"""The training driver: `train/loop.py::train_step`, called as
`cli/train.py::train` calls it (the YAML's model, loss, AdamW with its
parameter groups, OneCycle over NUM_STEPS + 100, the noise, on-card
augmentation and dropout generators seeded as the trainer seeds them, the
`Loader` with the YAML's NUM_WORKERS, the metrics turned into floats every
step), on raw chairs-like pairs from a pool made from the seed.

Set-up builds the step's one object (the model on seeded weights, its
optimizer and schedule, the generators, the loader) and drives it through
`warmup_steps` steps; the same object then runs the window. The first
`checked_steps` set-up steps are recorded for the check: the raw batches,
the generators' states before each, the program's augmented batch, the
losses, the first gradient as AdamW holds it after step 1 (its first
moment over 1 - beta1) and each parameter's change after the last checked
step. The window: steps until `seconds` have passed. With `--trace 1` a
slice of `trace_steps` steps follows it under the profiler.

`correct`: once the window has closed and the program is freed, the plain
reference (`reference/train_step.py`, f32, TF32 off) takes the same
initial weights and raw batches and the same generator states through
the same steps. The numbers (`compare`): `aug_gap`, the largest difference
of the augmented batches (images, masks, flow, valid) from the reference
augmentor's in f64 on the same draws (the f32 reference is a copy of the
program's augmentor and reads 0; against f64 a sound f32 augmentor reads
its rounding, so a reordering of its arithmetic does not fail the check,
and the f32 batch still feeds the reference's model); `loss_gap`, the
worst step's |loss - reference| over the reference's; for the first
gradient as AdamW holds it and for each parameter's change after the
checked steps, every parameter's |norm - reference's norm| over the larger
of the reference's norm of it and of the median parameter, taken at the
worst parameter (`grad_worst`, `update_worst`) and at the median one
(`grad_gap`, `update_gap`). Parameters whose reference gradient is under
a thousandth of the median parameter's are left out (their gradient is
rounding alone, which Adam's update magnifies). A cell compares the
numbers its limits file names (its `_not_compared` says why a number is
left out, and each run prints that number's reading on standard error
before the numbers compared).
"""

from __future__ import annotations

import contextlib
import sys
import time
import types
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import traffic as traffic_gen
from .common import Outcome
from .serve import _node, _sync
from .weights import seeded_state

BETA1 = 0.9  # AdamW's first-moment decay (`train/loop.py::build_optimizer`)


class Pool:
    """An in-memory dataset of raw pairs (host numpy), as `Loader` reads one."""

    def __init__(self, data: Dict[str, np.ndarray]):
        self.data = data

    def __len__(self) -> int:
        return len(self.data["image1"])

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        return {k: v[i] for k, v in self.data.items()}


class Recorder:
    """The augmentor, keeping a host copy of its first `n` outputs."""

    def __init__(self, augment, n: int):
        self.augment, self.n, self.outputs = augment, n, []

    def __call__(self, gen, batch, **kwargs):
        out = self.augment(gen, batch, **kwargs)
        if len(self.outputs) < self.n:
            self.outputs.append({k: v.detach().cpu() for k, v in out.items()})
        return out


def make_pool(tr: Dict[str, Any], seed: int, device) -> Pool:
    gen = torch.Generator(device=device).manual_seed(seed)
    data = traffic_gen.pool(gen, tr["pool_pairs"], tr["height"], tr["width"], device)
    return Pool({k: v.cpu().numpy() for k, v in data.items()})


class Program:
    """The step's one object, built as `cli/train.py::train` builds it."""

    def __init__(self, config: Dict[str, Any], tr: Dict[str, Any], seed: int, device,
                 pool: Pool):
        from focusflow_official_tpu_torch.cli.train import build_model, param_labels
        from focusflow_official_tpu_torch.config import optimizer_kwargs_from_yaml
        from focusflow_official_tpu_torch.data.device_aug import (DeviceFlowAugmentor,
                                                                  dense_recipe)
        from focusflow_official_tpu_torch.data.loader import Loader
        from focusflow_official_tpu_torch.models.ff_raft import DTYPES
        from focusflow_official_tpu_torch.train.loop import build_optimizer
        from focusflow_official_tpu_torch.train.schedule import one_cycle

        cfg = _node(config["yaml"])
        self.device = torch.device(device)
        torch.manual_seed(seed)
        model_cfg, model, self.loss_fn, self.iters = build_model(cfg, config["compute_dtype"])
        self.dtype = DTYPES[config["compute_dtype"]]
        self.initial = seeded_state(model.state_dict(), seed, device)
        model.load_state_dict(self.initial)
        self.initial = {k: v.cpu() for k, v in self.initial.items()}
        model.to(self.device)
        if self.device.type == "cuda":
            model.to(memory_format=torch.channels_last)
        opt = optimizer_kwargs_from_yaml(cfg)
        self.clip = opt.pop("clip")
        lr = opt.pop("lr")
        labels, factor = param_labels(cfg, model)
        self.optimizer = build_optimizer(model, lr, labels=labels, encoder_lr_factor=factor, **opt)
        self.scheduler = one_cycle(self.optimizer, int(cfg.TRAIN.NUM_STEPS) + 100)
        gseed = int(cfg.GLOBAL.get("SEED", 1234)) + seed
        gen = lambda s: torch.Generator(device=self.device).manual_seed(s)
        self.noise = gen(gseed) if cfg.TRAIN.get("ADD_NOISE", False) else None
        self.aug_gen, self.drop_gen = gen(gseed + 1), gen(gseed + 2)
        self.augment = Recorder(DeviceFlowAugmentor(tuple(cfg.TRAIN.IMAGE_SIZE),
                                                    recipes=[dense_recipe(*tr["recipe"])]),
                                tr["checked_steps"])
        self.model, self.freeze_bn = model, getattr(model_cfg, "freeze_bn", False)
        self.batch_size = int(cfg.TRAIN.BATCH_SIZE)
        self.loader = Loader(pool, self.batch_size, seed=seed % 2 ** 31,
                             num_workers=int(cfg.GLOBAL.get("NUM_WORKERS", 4)))
        self.batches = self.loader.batches()
        model.train()
        if self.freeze_bn:
            model.freeze_bn()

    def step(self, fault: Optional[str] = None):
        """One step as `cli/train.py::train` runs it -> (the raw batch, the
        loader's wait in seconds, the float metrics). `fault` 'half_batch'
        takes the loss's mean over the first half of the batch alone."""
        from focusflow_official_tpu_torch.cli.train import _to_device
        from focusflow_official_tpu_torch.train.loop import train_step

        t = time.perf_counter()
        raw = next(self.batches)
        wait = time.perf_counter() - t
        batch = _to_device(raw, self.device)
        loss_fn = self.loss_fn
        if fault == "half_batch":
            half = self.batch_size // 2
            loss_fn = lambda flows, flow, valid, mask: self.loss_fn(
                flows[:, :half], flow[:half], valid[:half], mask[:half])
        metrics = train_step(self.model, self.optimizer, self.scheduler, loss_fn, batch,
                             iters=self.iters, dtype=self.dtype, clip=self.clip,
                             noise=self.noise, augment=self.augment, aug_gen=self.aug_gen,
                             dropout=self.drop_gen)
        return raw, wait, {k: float(v) for k, v in metrics.items()}

    def first_moment_norms(self) -> Dict[str, float]:
        """Each parameter's first gradient as AdamW holds it after one step."""
        st = self.optimizer.state
        return {n: float(st[p]["exp_avg"].norm()) / (1 - BETA1)
                for n, p in self.model.named_parameters() if p in st}

    def change_norms(self) -> Dict[str, float]:
        return {n: float((p.detach().cpu() - self.initial[n]).norm())
                for n, p in self.model.named_parameters()}


def _states(p: Program):
    return (p.aug_gen.get_state(), None if p.noise is None else p.noise.get_state())


def _set(gen_state, device) -> Optional[torch.Generator]:
    if gen_state is None:
        return None
    g = torch.Generator(device=device)
    g.set_state(gen_state)
    return g


def step_flops(config: Dict[str, Any], tr: Dict[str, Any], batch: int) -> float:
    """Model FLOPs of one step: the reference's train-mode forward, loss and
    backward at the crop and batch, counted on the meta device."""
    from reference.train_step import loss_function

    from .cells import reference_family
    from .roofline import count_flops

    yaml = config["yaml"]
    h, w = yaml["TRAIN"]["IMAGE_SIZE"]
    with torch.device("meta"):
        model = reference_family(config["family"]).build(yaml).train()
        img, mask = torch.empty(batch, h, w, 3), torch.empty(batch, h, w, 1)
        flow, valid = torch.empty(batch, h, w, 2), torch.empty(batch, h, w)
    loss_fn = loss_function(yaml)

    def step():
        loss, _ = loss_fn(model(img, img, mask, mask), flow, valid, mask)
        loss.backward()

    return count_flops(step)


def exact_augmentation(trainer, raw, aug_state, device) -> Dict[str, torch.Tensor]:
    """The reference augmentor on the raw batch in f64, from the generator
    state the step drew from (host tensors)."""
    t = {key: torch.as_tensor(v, device=device) for key, v in raw.items()}
    t = {key: v.double() if v.is_floating_point() else v for key, v in t.items()}
    out = trainer.augment(_set(aug_state, device), t)
    return {key: v.detach().cpu() for key, v in out.items()}


def reference_steps(config, tr, record, device, lower: bool = False, steps: bool = True):
    """The reference through the checked steps -> (augmented batches,
    losses, first-gradient norms, change norms, the batches augmented in
    f64). `steps` False: the f64 batches alone (the others None)."""
    from reference.frozen.precision import no_tf32
    from reference.lowp import fp8
    from reference.train_step import Trainer

    from .cells import reference_family

    yaml = config["yaml"]
    model = reference_family(config["family"]).build(yaml)
    model.load_state_dict(record["initial"])
    model.to(device).train()
    if getattr(model.cfg, "freeze_bn", False):
        model.freeze_bn()
    initial = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = Trainer(model, yaml, tuple(tr["recipe"]))
    exact = [exact_augmentation(trainer, raw, aug_state, device)
             for raw, (aug_state, _) in zip(record["raw"], record["states"])]
    if not steps:
        return None, None, None, None, exact
    batches, losses, grads = [], [], None
    with no_tf32(), (fp8() if lower else contextlib.nullcontext()):
        for k, (raw, (aug_state, noise_state)) in enumerate(zip(record["raw"], record["states"])):
            t = {key: torch.as_tensor(v, device=device) for key, v in raw.items()}
            batch, loss = trainer.step(t, _set(aug_state, device), _set(noise_state, device),
                                       record["iters"])
            batches.append({key: v.detach().cpu() for key, v in batch.items()})
            losses.append(loss)
            if k == 0:
                st = trainer.optimizer.state
                grads = {n: float(st[p]["exp_avg"].norm()) / (1 - BETA1)
                         for n, p in model.named_parameters()}
    changes = {n: float((p.detach() - initial[n]).norm()) for n, p in model.named_parameters()}
    del model, trainer
    return batches, losses, grads, changes, exact


def norm_gaps(program: Dict[str, float], reference: Dict[str, float],
              kept: List[str]) -> Dict[str, float]:
    """Each kept parameter's |norm - reference's| over the larger of the
    reference's norm of it and of the median kept parameter."""
    med = float(np.median([reference[n] for n in kept]))
    return {n: abs(program.get(n, 0.0) - reference[n]) / max(reference[n], med) for n in kept}


def kept_leaves(grads: Dict[str, float]) -> List[str]:
    """The parameters whose reference gradient is at least a thousandth of
    the median parameter's."""
    med = float(np.median(list(grads.values())))
    return [n for n, g in grads.items() if g >= 1e-3 * med]


def compare_augmented(program: List[Dict], exact: List[Dict]) -> float:
    """`aug_gap`: the largest difference of the augmented batches, in f64."""
    return max(float((a[k].double() - b[k].double()).abs().max())
               for a, b in zip(program, exact) for k in b if k in a)


def compare(record, ref) -> Dict[str, float]:
    """The numbers `correct` compares (the module docstring)."""
    _, losses, grads, changes, exact = ref
    aug = compare_augmented(record["augmented"], exact)
    loss = max(abs(p - r) / abs(r) for p, r in zip(record["losses"], losses))
    kept = kept_leaves(grads)
    g = list(norm_gaps(record["grads"], grads, kept).values())
    u = list(norm_gaps(record["changes"], changes, kept).values())
    return dict(aug_gap=aug, loss_gap=loss, grad_gap=float(np.median(g)),
                update_gap=float(np.median(u)), grad_worst=max(g), update_worst=max(u))


def compared(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, float]:
    """The numbers a cell compares: those its limits file names."""
    return {k: v for k, v in numbers.items() if k in limits}


def setup(config, tr, seed: int, device, fault: Optional[str] = None):
    """The program built and driven through its warm-up -> (program, the
    check's record)."""
    p = Program(config, tr, seed, device, make_pool(tr, seed, device))
    if fault == "unchanged":  # the optimizer's step leaves the state as it was
        p.optimizer.step = lambda closure=None: None
    rec = dict(raw=[], states=[], losses=[], grads=None, changes=None, iters=p.iters,
               initial=p.initial)
    n_check = tr["checked_steps"]
    for k in range(max(tr["warmup_steps"], n_check)):
        states = _states(p)
        raw, _, metrics = p.step(fault)
        if k < n_check:
            rec["raw"].append(raw)
            rec["states"].append(states)
            rec["losses"].append(metrics["loss"])
        if k == 0:
            rec["grads"] = p.first_moment_norms()
        if k == n_check - 1:
            rec["changes"] = p.change_norms()
    rec["augmented"] = p.augment.outputs
    _sync(device)
    return p, rec


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        fault: Optional[str] = None) -> Outcome:
    tr, config = cell.traffic, cell.config
    p, rec = setup(config, tr, seed, device, fault)
    setup_s = time.perf_counter() - t_start
    cuda = p.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(p.device)
    waits, failed, steps = [], 0, 0
    t0 = time.perf_counter()
    while True:
        _, wait, metrics = p.step(fault)
        waits.append(wait)
        steps += 1
        failed += not np.isfinite(metrics["loss"])
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(p.device) if cuda else 0
    e2e = dict(train_samples_per_s=steps * p.batch_size / window_s,
               peak_mem_gib=peak / 2 ** 30, setup_s=setup_s)
    out = Outcome(attempted=steps, failed=failed, end_to_end=e2e, layer_ctx=None, checks={},
                  memory_peak_bytes=int(peak))
    if trace:
        out.layer_ctx = _traced_slice(p, tr["trace_steps"], fault)
        out.layer_ctx.window_s, out.layer_ctx.window_steps = window_s, steps
        out.layer_ctx.host_s = {"loader_wait": waits}
    batch_size = p.batch_size
    p.loader = p.batches = None
    del p
    if cuda:
        torch.cuda.empty_cache()
    numbers = compare(rec, reference_steps(config, tr, rec, device))
    for name in sorted(set(numbers) - set(cell.limits)):
        print(f"reading {name} = {numbers[name]!r} (not compared)", file=sys.stderr)
    out.checks = compared(numbers, cell.limits)
    if trace:
        from .trace import busy_s, idle_gaps, top_kernels

        sl = out.layer_ctx.trace
        out.layer_ctx.flops_per_step = step_flops(config, tr, batch_size)
        out.busy_s, out.window_s = busy_s(sl), sl.window_s
        out.breakdown = dict(device_ops=top_kernels(sl), idle_gaps=idle_gaps(sl))
    return out


def _traced_slice(p: Program, n: int, fault):
    from torch.profiler import ProfilerActivity, profile, record_function

    from focusflow_official_tpu_torch import kernels

    from .trace import read_profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if p.device.type == "cuda" else [])
    _sync(p.device)
    kernels.reset_launch_counts()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            with record_function("bench.step"):
                p.step(fault)
        _sync(p.device)
        window = time.perf_counter() - t0
    return types.SimpleNamespace(mode="train", trace=read_profile(prof, window),
                                 launch_shapes=dict(kernels.launch_shapes), slice_steps=n,
                                 samples_per_step=p.batch_size)
