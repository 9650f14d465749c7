"""Profiler ranges at the port's own layer boundaries.

`span(name)` is a `torch.profiler.record_function` range while a profiler
records (`torch.profiler.profile`, `cli/train.py --profile-dir`), so the
range and the kernels launched inside it sit on the profiler's one clock:
the range as a host event, and as a device span from its first kernel to
its last. With no profiler it is one check that returns a shared null
context, so an untraced step or request pays nothing for it. A span never
synchronizes and never launches work; none opens inside a per-iteration
loop or a kernel wrapper, with one exception: ALT_CORR's chunk walk
(`ops/corr.py::_AltCorrFold.forward`) opens the two `ff.corr.*` spans in
every chunk it walks. A chunk carries under a millisecond of device work
at 3840x2160 (64 chunks of 2048 queries, 12 refinements), and the walk's
stages are invisible without them; untraced, the 1,536 checks of a 4K
request cost about 1 ms of it.

`SPANS`, where each opens:
- `ff.step.forward`: the noise, the dropout draw, the weights' casts, the
  train-mode forward and the loss (`train/loop.py::forward_backward`);
- `ff.step.backward`: the loss's backward (same);
- `ff.step.optimizer`: the zero gradients of unreached parameters, the
  all-reduce under a mesh, the clip, AdamW and the schedule
  (`train/loop.py::train_step`);
- `device_aug`: the on-card augmentation (same);
- `ff.model.encode`: the encoders (FF-RAFT: the masks and a front end, the
  fnet, the cnet; FF-FlowFormer: the masks and the context tower, the
  memory's feature tower), more than once a forward;
- `ff.model.cost`: the volume and its pyramid, or the latent cost memory;
- `ff.model.refine`: the refinements and the upsampling;
- `ff.corr.product`, `ff.corr.lookup`: in each chunk of ALT_CORR's forward
  walk, the chunk's levels (`ops/corr.py::chunk_levels`: the matrix product
  and its pooling, one launch of the chunk-levels kernel in bf16) and
  kernel G on them. The materialized volume opens none of them.

The model spans nest in `ff.step.forward` in training and in the caller's
range in serving; the walk's nest in `ff.model.refine`.
"""

from __future__ import annotations

import contextlib

import torch

SPANS = ("ff.step.forward", "ff.step.backward", "ff.step.optimizer", "device_aug",
         "ff.model.encode", "ff.model.cost", "ff.model.refine",
         "ff.corr.product", "ff.corr.lookup")

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named `name` while a profiler records, else the
    shared null context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
