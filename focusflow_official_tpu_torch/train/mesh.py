"""Data parallelism over processes with torch.distributed: one process a
card, the batch split over them, the model replicated (the counterpart of
the JAX package's `train/mesh.py`, whose 1-D `data` mesh shards the batch
and lets XLA insert the gradient psum).

The step computes what one process computes on the global batch. Each
rank's loss is its share of the global-batch loss: every denominator of
the losses and metrics (mask sums, valid counts, pixel counts of means,
the batch) is a `global_sum`, so the ranks' losses add up to the global
loss and their summed gradients are its gradient. The batch norms take
global statistics through `differentiable_sum` (a synchronised batch
norm, as flax's mean over the sharded batch is), and the random draws of
the step (noise, augmentation) are the global batch's on every rank, each
keeping its rows. The gradients are summed by an explicit bucketed
all-reduce after the backward (`all_reduce_grads`), not by a
`DistributedDataParallel` wrapper: the step calls the model through
`torch.func.functional_call` with bf16 weights cast at use, which DDP's
hooks do not see, and the explicit sum is JAX's psum exactly.

Launch: `torchrun --nproc_per_node N -m focusflow_official_tpu_torch.cli.train
--yaml <config> --multihost`. `init_from_env` reads torchrun's variables
(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), the only
environment the port reads. NCCL on cards, gloo on the CPU; a `Mesh` over
a process group initialised some other way (a file store, gloo on
cards) works the same.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Callable, Iterable, List, Optional

import torch
import torch.distributed as dist
from torch import nn

BUCKET_BYTES = 25 * 2 ** 20  # the gradient all-reduce's bucket size
# bounds every collective, the barrier at which the other ranks wait out
# rank 0's validation among them
TIMEOUT = datetime.timedelta(minutes=30)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the default process group: its `rank` of
    `world` and its device."""

    rank: int
    world: int
    device: torch.device

    @property
    def is_main(self) -> bool:
        """Rank 0: the process that logs, checkpoints, validates and exports."""
        return self.rank == 0

    def global_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the ranks, detached (a denominator)."""
        out = t.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out

    def differentiable_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the ranks, whose backward sums the incoming
        gradients over the ranks (the batch norms' statistics)."""
        return _AllReduceSum.apply(t)

    def all_reduce_grads(self, grads: Iterable[torch.Tensor]) -> None:
        """Sum the gradients over the ranks in place: one all-reduce for
        each run of gradients of one dtype up to about `BUCKET_BYTES`."""
        bucket: List[torch.Tensor] = []
        nbytes = 0
        for g in grads:
            if bucket and (g.dtype != bucket[0].dtype or nbytes >= BUCKET_BYTES):
                _all_reduce_bucket(bucket)
                bucket, nbytes = [], 0
            bucket.append(g)
            nbytes += g.numel() * g.element_size()
        if bucket:
            _all_reduce_bucket(bucket)

    def broadcast_state(self, model: nn.Module) -> None:
        """Every parameter and buffer of `model` from rank 0."""
        with torch.no_grad():
            for t in model.state_dict().values():
                buf = t if t.is_contiguous() else t.contiguous()  # channels_last weights
                dist.broadcast(buf, 0)
                if buf is not t:
                    t.copy_(buf)

    def barrier(self) -> None:
        dist.barrier()


def _all_reduce_bucket(bucket: List[torch.Tensor]) -> None:
    flat = torch.cat([g.reshape(-1) for g in bucket])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    for g, part in zip(bucket, flat.split([g.numel() for g in bucket])):
        g.copy_(part.view_as(g))


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM)
        return g


def sync_batch_norms(model: nn.Module, reduce: Optional[Callable]) -> None:
    """Every batch norm of `model` takes its train-mode statistics as sums
    passed through `reduce` (`Mesh.differentiable_sum`: the global batch's);
    None puts back torch's mean and variance of the local batch."""
    from ..nn.norm import Norm

    for m in model.modules():
        if isinstance(m, Norm) and m.kind == "batch":
            m.reduce = reduce


def round_batch(batch_size: int, world: int) -> int:
    """The global batch rounded up to a multiple of the ranks, so that
    every rank takes the same number of samples (the reference's
    BATCH_SIZE // world_size drops the remainder instead)."""
    return -(-int(batch_size) // world) * world


def init_from_env(device: str = "cuda") -> Mesh:
    """Join the process group from torchrun's environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT; init_method
    "env://") -> the `Mesh`. On "cuda" the process takes card LOCAL_RANK
    and NCCL; on "cpu", gloo; every collective within `TIMEOUT`."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if torch.device(device).type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        dev, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                            timeout=TIMEOUT)
    return Mesh(rank, world, dev)

