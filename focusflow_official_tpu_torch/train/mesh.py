"""Data parallelism over processes with torch.distributed: one process a
card, the batch split over them, the model replicated (the counterpart of
the JAX package's `train/mesh.py`, whose `data` mesh axis shards the batch
and lets XLA insert the gradient psum); and query sharding of FF-RAFT's
correlation volume over a second, `model` axis in serving.

The ranks form a (data, model) grid with the model axis the fastest, as
JAX's `make_mesh` reshapes its devices to (n / model, model): rank r sits
at data index r // model and model index r % model, so ranks r and r'
take the same samples exactly when r // model == r' // model. The batch
split, `global_sum`, `differentiable_sum` and `all_reduce_grads` run over
the data axis (the ranks of one model index); at a model extent of 1 that
is every rank. Inside `spatial_sharding(mesh)` with a model extent above
1, FF-RAFT's serving forward builds only this rank's block of the level-0
queries' rows of the volume (`shard_queries`, `ops/corr.py::ShardedCorr`)
and gathers the looked-up features over its model group
(`gather_rows`); the encoders, the GRU and the upsampling stay replicated
in the group. Outside the context, or at a model extent of 1, nothing
changes.

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
environment the port reads; its `model_axis` sets the model extent (a
serving script under torchrun: `FlowPredictor(..., mesh=init_from_env(
"cuda", model_axis=M))`). NCCL on cards, gloo on the CPU; `make_mesh`
over a process group initialised some other way (a file store, gloo on
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
    `world`, its device, the model extent, and the process groups of its
    model group and of its data group (None: the default group, where the
    axis spans every rank). `make_mesh` builds one."""

    rank: int
    world: int
    device: torch.device
    model: int = 1
    model_group: Optional[dist.ProcessGroup] = None
    data_group: Optional[dist.ProcessGroup] = None

    @property
    def is_main(self) -> bool:
        """Rank 0: the process that logs, checkpoints, validates and exports."""
        return self.rank == 0

    @property
    def data(self) -> int:
        """The data extent: how many ways the batch is split."""
        return self.world // self.model

    @property
    def data_rank(self) -> int:
        """This rank's index on the data axis: its rows of the batch are
        data_rank, data_rank + data, ..."""
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        """This rank's index in its model group: its block of the queries."""
        return self.rank % self.model

    def global_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the data axis, detached (a denominator)."""
        out = t.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.data_group)
        return out

    def differentiable_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the data axis, whose backward sums the
        incoming gradients over it (the batch norms' statistics)."""
        return _AllReduceSum.apply(t, self.data_group)

    def all_reduce_grads(self, grads: Iterable[torch.Tensor]) -> None:
        """Sum the gradients over the data axis in place: one all-reduce for
        each run of gradients of one dtype up to about `BUCKET_BYTES`."""
        bucket: List[torch.Tensor] = []
        nbytes = 0
        for g in grads:
            if bucket and (g.dtype != bucket[0].dtype or nbytes >= BUCKET_BYTES):
                _all_reduce_bucket(bucket, self.data_group)
                bucket, nbytes = [], 0
            bucket.append(g)
            nbytes += g.numel() * g.element_size()
        if bucket:
            _all_reduce_bucket(bucket, self.data_group)

    def broadcast_state(self, model: nn.Module) -> None:
        """Every parameter and buffer of `model` from rank 0."""
        with torch.no_grad():
            for t in model.state_dict().values():
                buf = t if t.is_contiguous() else t.contiguous()  # channels_last weights
                dist.broadcast(buf, 0)
                if buf is not t:
                    t.copy_(buf)

    def gather_batch(self, part: torch.Tensor, batch: int) -> torch.Tensor:
        """This rank's rows of a batch of `batch` samples (data_rank,
        data_rank + data, ...) -> the whole batch, on every rank."""
        if self.data == 1:
            return part
        return gather_rows(part, batch, slice(self.data_rank, None, self.data), 0,
                           self.data_group)

    def barrier(self) -> None:
        dist.barrier()


def gather_rows(part: torch.Tensor, total: int, rows: slice, dim: int,
                group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Each rank's `rows` of an axis of length `total` (dimension `dim`),
    the ranks' rows disjoint and together the whole axis -> the whole
    tensor on every rank of `group`, in `part`'s type. One form for every
    backend: each rank writes its rows into a zeroed f32 buffer and the
    buffers are summed (a value plus zeros is exact, and f32 holds bf16
    exactly), so no backend needs an all-gather or a bf16 sum."""
    shape = list(part.shape)
    shape[dim] = total
    buf = torch.zeros(shape, dtype=torch.float32, device=part.device)
    buf[(slice(None),) * dim + (rows,)] = part.float()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(part.dtype)


def _all_reduce_bucket(bucket: List[torch.Tensor], group) -> None:
    flat = torch.cat([g.reshape(-1) for g in bucket])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    for g, part in zip(bucket, flat.split([g.numel() for g in bucket])):
        g.copy_(part.view_as(g))


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def sync_batch_norms(model: nn.Module, reduce: Callable) -> None:
    """Every batch norm of `model` takes its train-mode statistics as sums
    passed through `reduce` (`Mesh.differentiable_sum`: the global batch's;
    a new `Norm` takes the identity, the local batch's)."""
    from ..nn.norm import Norm

    for m in model.modules():
        if isinstance(m, Norm) and m.kind == "batch":
            m.reduce = reduce


def round_batch(batch_size: int, world: int) -> int:
    """The global batch rounded up to a multiple of the ranks, so that
    every rank takes the same number of samples (the reference's
    BATCH_SIZE // world_size drops the remainder instead)."""
    return -(-int(batch_size) // world) * world


def make_mesh(device, model_axis: int = 1) -> Mesh:
    """This process's `Mesh` in the initialised default process group,
    with a model extent of `model_axis` (dividing the world size). Every
    rank must call it, with the same extent: the groups of each model
    index (the data axis) and of each data index (a model group) are made
    with `dist.new_group` on every rank in the same order."""
    rank, world = dist.get_rank(), dist.get_world_size()
    if model_axis < 1 or world % model_axis:
        raise ValueError(f"model_axis {model_axis} must divide the world size {world}")
    if model_axis == 1:
        return Mesh(rank, world, torch.device(device))
    data = world // model_axis
    data_groups = [dist.new_group([d * model_axis + m for d in range(data)])
                   for m in range(model_axis)]
    model_groups = [dist.new_group([d * model_axis + m for m in range(model_axis)])
                    for d in range(data)]
    return Mesh(rank, world, torch.device(device), model_axis,
                model_groups[rank // model_axis],
                None if data == world else data_groups[rank % model_axis])


def init_from_env(device: str = "cuda", model_axis: int = 1) -> Mesh:
    """Join the process group from torchrun's environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT; init_method
    "env://") -> the `Mesh` (`make_mesh`, model extent `model_axis`). On
    "cuda" the process takes card LOCAL_RANK and NCCL; on "cpu", gloo;
    every collective within `TIMEOUT`."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if torch.device(device).type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        dev, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                            timeout=TIMEOUT)
    return make_mesh(dev, model_axis)


# ---- query sharding of the correlation volume over the model axis ----------
#
# The counterpart of the JAX package's `spatial_sharding` and
# `shard_queries`: there a sharding constraint on the volume's query axis,
# and GSPMD places the exchanges; here the same split by hand. Each rank
# of a model group keeps the contiguous block `query_block` of the level-0
# queries (`torch.tensor_split`'s blocks: they differ in size by at most
# one, so any H/8 x W/8 grid splits), and the lookup's features are
# gathered back into query order (`ops/corr.py::lookup_convc1`).

_SPATIAL_MESH: Optional[Mesh] = None


class spatial_sharding:
    """Context manager: shard the correlation volume's queries over the
    `model` axis of `mesh` (FF-RAFT's materialized path, test mode)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def __enter__(self):
        global _SPATIAL_MESH
        self._prev = _SPATIAL_MESH
        _SPATIAL_MESH = self.mesh
        return self.mesh

    def __exit__(self, *exc):
        global _SPATIAL_MESH
        _SPATIAL_MESH = self._prev
        return False


def sharded_mesh() -> Optional[Mesh]:
    """The mesh whose queries are sharded: the innermost `spatial_sharding`
    mesh with a model extent above 1, else None."""
    mesh = _SPATIAL_MESH
    return mesh if mesh is not None and mesh.model > 1 else None


def query_block(n: int, mesh: Mesh) -> slice:
    """This rank's block of `n` queries: block `model_rank` of
    `torch.tensor_split` into `model` blocks (the first n % model blocks
    one longer)."""
    size, extra = divmod(n, mesh.model)
    i = mesh.model_rank
    start = i * size + min(i, extra)
    return slice(start, start + size + (i < extra))


def shard_queries(x: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """This rank's block of `x` along `axis` (the flattened H*W query
    axis). No-op unless inside `spatial_sharding` with a model extent
    above 1, so single-mesh code paths are unaffected."""
    mesh = sharded_mesh()
    if mesh is None:
        return x
    return torch.tensor_split(x, mesh.model, dim=axis)[mesh.model_rank]
