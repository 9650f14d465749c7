"""Training CLI: `python -m focusflow_official_tpu_torch.cli.train`.

    python -m focusflow_official_tpu_torch.cli.train --yaml <config> \\
        [--data-root chairs=<dir> ...] [--log-dir runs] \\
        [--compute-dtype bfloat16|float32] [--val-freq 5000] [--device-aug] \\
        [--profile-dir <dir> --profile-start 10 --profile-steps 5] \\
        [--tensorboard] [--device cuda|cpu]
    torchrun --nproc_per_node N -m focusflow_official_tpu_torch.cli.train \\
        --yaml <config> --multihost [--device-aug] ...

The reference's training interface on the reference YAML schema, one
trainer for the three families (FF-RAFT with plain RAFT, the fusion
ablation and every variant: SMALL, ALT_CORR, the attention and conv front
ends, MODEL.DROPOUT; FF-PWCNet with the vanilla PWC-Net, FF-FlowFormer with
vanilla FlowFormer), picked from the file's shape as
`config.py::detect_family` picks it, every YAML under `configs/` among
them. TRAIN picks the stage's dataset curriculum
(`data/datasets.py::fetch_dataset`, with the host augmentation), the
batch, the steps, the noise augmentation and the loss: the sequence loss
for FF-RAFT and FF-FlowFormer, the multiscale loss
(`losses/multiscale.py`, sparse targets at the kitti stage) for PWC-Net.
OPTIMIZER and SCHEDULER (FF-FlowFormer: TRAINER) give the AdamW step and
its OneCycle schedule over NUM_STEPS + 100 steps; MODEL the weights to
start from (PRETRAIN, the whole model; LOAD_MODULE, a reference `.pth`,
into `flow_net` for every RAFT variant and over the whole model for
PWC-Net, keeping what the file lacks; LOAD_MODULE_TO_BRANCH, which changes
nothing on a model without mask branches; FF-FlowFormer's load_former,
a reference `.pth` over the whole model, keeping what it lacks) and the
parameter groups (FREEZE_MODULE over TRAIN.SEPARATE_LR's `flow_net` at lr
/ 10, or FF-FlowFormer's TRAINER.twins_lr_factor on its Twins towers).
FlowFormer's MODEL.pretrain (timm ImageNet weights for the towers, which
vanilla FlowFormer's `chairs.yaml` sets) is ignored, as the JAX trainer
ignores it: `compat/timm_twins.py` maps such
weights, but nothing here downloads them. Each step is
`train/loop.py::train_step`. Every `--val-freq` steps a checkpoint is
written and the CRITERION.VAL_DATASET validation runs
(`train/evaluate.py`); at the end the final validation, a last checkpoint
and the weights as a flat `.npz` of flax variables (`<NAME>_final.npz`,
which the port's `--checkpoint`, `FlowPredictor` and the JAX package
load). The run directory `<log-dir>/<time>_<NAME>/` holds `metrics.jsonl`,
`train.log`, `config.yaml`, `checkpoints/` and the export.

`--device-aug` reads raw full-size frames (`fetch_dataset(no_aug=True)`)
and augments them on the card inside each step (`data/device_aug.py`,
from a generator of its own that checkpoints save); the host augmentation
(`data/augment.py`, which needs cv2 and PIL) is the default. Dropout's
keep masks come from a generator of their own, which checkpoints save too.
`--multihost` trains data-parallel, one process a card under torchrun
(`train/mesh.py`): the global batch (TRAIN.BATCH_SIZE rounded up to a
multiple of the processes) split over the ranks by the loader, each step
the global batch's (its loss, the batch norms' statistics, the noise and
augmentation draws, the summed gradients), rank 0 alone logging,
checkpointing, validating and exporting while the others wait. The loss
stays the global batch's mean, not scaled by the world size.

`--gpus` is accepted and ignored (the cards are torchrun's processes), as
is `--corr-impl` (the port has one lookup). File datasets need cv2 and
PIL, the YAML needs PyYAML.
"""

from __future__ import annotations

import argparse
import copy
import os
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from ..compat.torch_import import load_torch_pretrained
from ..config import (ConfigNode, config_from_yaml, detect_family, load_yaml_config,
                      loss_kwargs_from_yaml, model_from_config,
                      multiscale_loss_kwargs_from_yaml, optimizer_kwargs_from_yaml)
from ..data.datasets import KITTI, FlyingChairs, MpiSintel, fetch_dataset
from ..data.device_aug import DeviceFlowAugmentor
from ..data.loader import Loader
from ..losses import build_multiscale_loss, build_sequence_loss
from ..models.ff_raft import DTYPES
from ..predict import for_inference, load_weights
from ..train import evaluate as eval_mod
from ..train.checkpoints import CheckpointManager, save_params_only
from ..train.loop import build_optimizer, train_step
from ..train.mesh import Mesh, init_from_env, round_batch, sync_batch_norms
from ..train.metrics import MetricsLogger
from ..train.schedule import one_cycle
from ..train.surgery import (copy_to_branch, encoder_lr_labels, flow_net_lr_labels,
                             freeze_mask_for_parallel)
from .evaluate import DEFAULT_DATA_ROOT, mask_roots

# raw batches (--device-aug) may lack `valid` and carry `sizes` and `recipe`
_BATCH_KEYS = ("image1", "image2", "mask1", "mask2", "flow", "valid", "sizes", "recipe")
def build_model(cfg: ConfigNode, compute_dtype: str, mesh: Optional[Mesh] = None):
    """The YAML's model (f32 parameters) -> (its config, the model, its
    loss, its refinements a step: FF-RAFT's ITERS, FF-FlowFormer's
    decoder_depth, None for PWC-Net, which has no refinement loop). Under
    `mesh` the loss's denominators are the global batch's
    (`mesh.global_sum`) and the batch norms' statistics too (a conv front
    end's among them)."""
    model_cfg = config_from_yaml(cfg, compute_dtype=compute_dtype)
    model, iters = model_from_config(model_cfg)
    reduce = {}
    if mesh is not None:
        sync_batch_norms(model, mesh.differentiable_sum)
        reduce = {"reduce": mesh.global_sum}
    if detect_family(cfg) == "pwcnet":
        kw = multiscale_loss_kwargs_from_yaml(cfg, sparse=cfg.TRAIN.get("STAGE") == "kitti")
        return model_cfg, model, build_multiscale_loss(kw.pop("loss_type"), **kw, **reduce), iters
    kw = loss_kwargs_from_yaml(cfg)
    return model_cfg, model, build_sequence_loss(kw.pop("loss_type"), **kw, **reduce), iters


def load_initial_weights(cfg: ConfigNode, model: nn.Module) -> None:
    """MODEL.PRETRAIN (the whole model: the port's `.npz` or a reference
    `.pth`), then MODEL.LOAD_MODULE (a reference `.pth`: FF-RAFT's bare
    RAFT into `flow_net`, PWC-Net's over the whole model; what the file
    lacks keeps its weights) and LOAD_MODULE_TO_BRANCH (the CCE mask
    branches start from the image branches), then FF-FlowFormer's
    MODEL.load_former (a reference `.pth` over the whole model, what it
    lacks kept)."""
    m = cfg.MODEL
    if m.get("PRETRAIN"):
        model.load_state_dict(load_weights(m.PRETRAIN, model), strict=True)
    if m.get("LOAD_MODULE"):
        prefix = "flow_net." if detect_family(cfg) == "raft" else ""
        model.load_state_dict(load_torch_pretrained(m.LOAD_MODULE, model, prefix=prefix,
                                                    strict=False), strict=True)
        if m.get("LOAD_MODULE_TO_BRANCH"):
            model.load_state_dict(copy_to_branch(model.state_dict()), strict=True)
    if m.get("load_former"):
        model.load_state_dict(load_torch_pretrained(m.load_former, model, strict=False),
                              strict=True)


def param_labels(cfg: ConfigNode, model: nn.Module) -> tuple[Optional[Dict[str, str]], float]:
    """Each parameter's group and the 'encoder' group's learning-rate
    factor: 'frozen' (MODEL.FREEZE_MODULE) over 'encoder' (TRAIN.SEPARATE_LR:
    `flow_net` at lr / 10, a front end's `fusion_layer` at lr; else
    FF-FlowFormer's TRAINER.twins_lr_factor: the Twins towers at lr x that
    factor) over 'trainable'; None where none of these is set."""
    names = [n for n, _ in model.named_parameters()]
    freeze = bool(cfg.MODEL.get("FREEZE_MODULE", False))
    separate = bool(cfg.TRAIN.get("SEPARATE_LR", False))
    trainer = cfg.get("TRAINER")
    twins = trainer.get("twins_lr_factor") if trainer is not None else None
    if separate:
        labels, factor = flow_net_lr_labels(names), 0.1
    elif twins:
        labels, factor = encoder_lr_labels(names), float(twins)
    elif freeze:
        labels, factor = {n: "trainable" for n in names}, 0.1
    else:
        return None, 0.1
    if freeze:
        for n, lbl in freeze_mask_for_parallel(names).items():
            if lbl == "frozen":
                labels[n] = "frozen"
    return labels, factor


def run_validation(cfg: ConfigNode, model: nn.Module, data_root: Dict[str, str],
                   mask_root: Dict[str, str], dtype: torch.dtype, device) -> Dict:
    """CRITERION.VAL_DATASET's validation (`train/evaluate.py`) on a copy of
    the model prepared as the predictor prepares it. A dataset whose files
    are missing or broken is reported (printed, and NaN under
    '<name>-error'), not raised: it must not end a long run."""
    eval_model = for_inference(copy.deepcopy(model), dtype, device)
    mask_type = cfg.TRAIN.MASK_TYPE
    results: Dict = {}
    for name in cfg.CRITERION.VAL_DATASET:
        try:
            if name == "chairs":
                ds = FlyingChairs(data_root["chairs"], mask_root["chairs"],
                                  split="validation", mask_type=mask_type)
                results.update(eval_mod.validate_chairs(eval_model, ds, mask_type))
            elif name == "sintel":
                dss = {t: MpiSintel(data_root["sintel"], mask_root["sintel"], split="val",
                                    dstype=t, mask_type=mask_type)
                       for t in ("clean", "final")}
                results.update(eval_mod.validate_sintel(eval_model, dss, mask_type))
            elif name == "kitti":
                ds = KITTI(data_root["kitti"], mask_root["kitti"], split="val",
                           mask_type=mask_type)
                results.update(eval_mod.validate_kitti(eval_model, ds, mask_type))
        except (FileNotFoundError, AssertionError, IndexError) as e:
            print(f"validation on '{name}' failed: {type(e).__name__}: {e}")
            results[f"{name}-error"] = float("nan")
    return results


def _to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(batch[k], device=device) for k in _BATCH_KEYS if k in batch}


def train(cfg: ConfigNode, dataset, *, validate: Callable[[nn.Module], Dict],
          log_dir: str = "runs", device="cuda", compute_dtype: str = "bfloat16",
          val_freq: int = 5000, config_path: Optional[str] = None,
          profile_dir: Optional[str] = None, profile_start: int = 10,
          profile_steps: int = 5, tensorboard: bool = False,
          on_step: Optional[Callable[[int, Dict], None]] = None,
          device_aug: bool = False, mesh: Optional[Mesh] = None) -> Dict:
    """The trainer: TRAIN.NUM_STEPS steps of the YAML's model over
    `dataset` (samples as `data/datasets.py` gives them, batched by the
    `Loader`), from RESTORE_CHECKPOINT's step where set. `validate(model)`
    -> metrics runs every `val_freq` steps (after a checkpoint) and at the
    end; `on_step(step, metrics)` is called after each step. `device_aug`:
    the samples are raw frames (`fetch_dataset(no_aug=True)`, whose
    `device_recipes` the dataset must carry) and each step augments them on
    the card. `mesh`: this rank under data parallelism (`train/mesh.py`;
    `device` is then the mesh's); rank 0 alone logs, checkpoints, validates
    and exports. Returns the run directory (None on the other ranks), the
    last step, its metrics (the global batch's), the final validation and
    the exported `.npz`."""
    main = mesh is None or mesh.is_main
    device = mesh.device if mesh is not None else torch.device(device)
    model_cfg, model, loss_fn, iters = build_model(cfg, compute_dtype, mesh)
    dtype = DTYPES[compute_dtype]
    name = cfg.GLOBAL.get("NAME", "run")
    seed = int(cfg.GLOBAL.get("SEED", 1234))
    logger = MetricsLogger(log_dir, config_path, name, tensorboard=tensorboard) if main else None
    log = logger.info if main else (lambda msg: None)
    log(f"experiment: {name}  device: {device}  dtype: {compute_dtype}"
        + (f"  ranks: {mesh.world}" if mesh is not None else ""))

    load_initial_weights(cfg, model)
    model.to(device)
    if device.type == "cuda":  # the instance-norm kernels read NHWC without a copy
        model.to(memory_format=torch.channels_last)
    opt = optimizer_kwargs_from_yaml(cfg)
    clip = opt.pop("clip")
    lr = opt.pop("lr")
    labels, encoder_factor = param_labels(cfg, model)
    optimizer = build_optimizer(model, lr, labels=labels, encoder_lr_factor=encoder_factor,
                                **opt)
    num_steps = int(cfg.TRAIN.NUM_STEPS)
    scheduler = one_cycle(optimizer, num_steps + 100)
    noise = None
    if cfg.TRAIN.get("ADD_NOISE", False):
        noise = torch.Generator(device=device).manual_seed(seed)
    augmentor = aug_gen = None
    if device_aug:
        recipes = getattr(dataset, "device_recipes", None)
        if not recipes:
            raise ValueError(f"stage {cfg.TRAIN.STAGE}: --device-aug needs raw samples with "
                             "device_recipes (fetch_dataset(no_aug=True))")
        augmentor = DeviceFlowAugmentor(tuple(cfg.TRAIN.IMAGE_SIZE), recipes=recipes)
        aug_gen = torch.Generator(device=device).manual_seed(seed + 1)
    drop_gen = torch.Generator(device=device).manual_seed(seed + 2)  # dropout's masks

    ckpt = CheckpointManager(os.path.join(logger.log_dir, "checkpoints")) if main else None
    step = 0
    if cfg.TRAIN.get("RESTORE_CHECKPOINT"):
        step = CheckpointManager(cfg.TRAIN.RESTORE_CHECKPOINT).restore(
            model, optimizer, scheduler, noise, aug_gen, drop_gen)
        log(f"restored checkpoint step {step} from {cfg.TRAIN.RESTORE_CHECKPOINT}")
    if mesh is not None:  # every rank starts from rank 0's weights
        mesh.broadcast_state(model)

    def train_mode():
        model.train()
        if getattr(model_cfg, "freeze_bn", False):  # FF-RAFT's core past the chairs stage
            model.freeze_bn()

    def save():
        ckpt.save(step, model, optimizer, scheduler, noise, aug_gen, drop_gen)

    world, rank = (1, 0) if mesh is None else (mesh.world, mesh.rank)
    batch_size = round_batch(cfg.TRAIN.BATCH_SIZE, world)
    if batch_size != int(cfg.TRAIN.BATCH_SIZE):
        log(f"batch size {cfg.TRAIN.BATCH_SIZE} -> {batch_size} (a multiple of {world} ranks)")
    loader = Loader(dataset, batch_size, seed=seed,
                    num_workers=int(cfg.GLOBAL.get("NUM_WORKERS", 4)),
                    process_index=rank, process_count=world)
    log(f"training with {len(dataset)} image pairs")
    train_mode()
    prof, metrics = None, {}
    for batch in loader.batches(start_step=step):
        if step >= num_steps:
            break
        if main and profile_dir and step == profile_start:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]
                                          + ([torch.profiler.ProfilerActivity.CUDA]
                                             if device.type == "cuda" else []))
            prof.start()
        metrics = train_step(model, optimizer, scheduler, loss_fn, _to_device(batch, device),
                             iters=iters, dtype=dtype, clip=clip, noise=noise,
                             augment=augmentor, aug_gen=aug_gen, mesh=mesh, dropout=drop_gen)
        metrics = {k: float(v) for k, v in metrics.items()}
        if main:
            logger.push(metrics)
        if prof is not None and step >= profile_start + profile_steps - 1:
            prof.stop()
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir, f"steps_{profile_start}.json"))
            log(f"profiler trace written to {profile_dir}")
            prof = None
        step += 1
        if on_step is not None:
            on_step(step, metrics)
        if step % val_freq == 0:
            if main:
                save()
                logger.write_dict(validate(model), prefix="val/")
                train_mode()
            if mesh is not None:
                mesh.barrier()

    final, export = {}, None
    if main:
        final = validate(model)
        logger.write_dict(final, prefix="final/")
        save()
        export = save_params_only(os.path.join(logger.log_dir, f"{name}_final.npz"), model)
        logger.close()
    if mesh is not None:
        mesh.barrier()
    return dict(run_dir=logger.log_dir if main else None, step=step, metrics=metrics,
                final=final, export=export)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--yaml", required=True, help="experiment config")
    parser.add_argument("--gpus", default=None, nargs="*",
                        help="accepted for the reference CLI's sake; unused (the cards are "
                             "torchrun's processes)")
    parser.add_argument("--data-root", nargs="*", default=None, metavar="NAME=DIR")
    parser.add_argument("--log-dir", default="runs")
    parser.add_argument("--compute-dtype", default="bfloat16", choices=sorted(DTYPES))
    parser.add_argument("--corr-impl", default="auto",
                        help="accepted and unused: the port has one lookup")
    parser.add_argument("--val-freq", type=int, default=5000)
    parser.add_argument("--device-aug", action="store_true",
                        help="raw frames, augmented on the card inside each step")
    parser.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler trace of some steps here")
    parser.add_argument("--profile-start", type=int, default=10)
    parser.add_argument("--profile-steps", type=int, default=5)
    parser.add_argument("--multihost", action="store_true",
                        help="data-parallel over torchrun's processes (one a card)")
    parser.add_argument("--tensorboard", action="store_true",
                        help="also write TensorBoard scalars")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    cfg = load_yaml_config(args.yaml)
    data_root = dict(DEFAULT_DATA_ROOT)
    for kv in args.data_root or ():
        k, v = kv.split("=", 1)
        data_root[k] = v
    mask_root = mask_roots(data_root)
    seed = int(cfg.GLOBAL.get("SEED", 1234))
    stage = cfg.TRAIN.STAGE
    dataset = fetch_dataset(data_root, mask_root, stage=stage,
                            image_size=tuple(cfg.TRAIN.IMAGE_SIZE),
                            mask_type=cfg.TRAIN.MASK_TYPE,
                            train_ds="C+T+S" if stage == "sintel" else None, seed=seed,
                            no_aug=args.device_aug)
    dtype = DTYPES[args.compute_dtype]
    mesh = init_from_env(args.device) if args.multihost else None
    device = mesh.device if mesh is not None else torch.device(args.device)
    try:
        result = train(
            cfg, dataset,
            validate=lambda model: run_validation(cfg, model, data_root, mask_root, dtype,
                                                  device),
            log_dir=args.log_dir, device=device, compute_dtype=args.compute_dtype,
            val_freq=args.val_freq, config_path=args.yaml, profile_dir=args.profile_dir,
            profile_start=args.profile_start, profile_steps=args.profile_steps,
            tensorboard=args.tensorboard, device_aug=args.device_aug, mesh=mesh)
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    if result["run_dir"] is not None:
        print(result["run_dir"])
    return result


if __name__ == "__main__":
    main()
