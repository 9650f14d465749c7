#!/usr/bin/env python3
"""The descent gate of `chip_smoke.py`'s training phases under two f32
summation forms, on one NVIDIA card:

    python3 scripts/descent_forms.py [path ...]

For each training path (default: all five of phases 9-12), the path's
descent run (`chip_smoke.py::descent_run`: the trainer's 16 steps, or the
fresh-weight recipe) and its measure, the fixed batch's f32 loss after the
last step over the loss before the first, twice:

- "global count", the port's one form: every mean a sum over a count (the
  losses' `_mean`, the batch norms' train-mode statistics), each through
  the identity `reduce`;
- "one card", the form the port kept for one card before: torch's `mean`
  in the losses and torch's mean and variance in the batch norms, patched
  in here for the run.

The two differ only in the order of f32 sums, so their ratios' difference
is the rounding the gate has to stand. Prints one JSON line a path (both
ratios, their difference, and the least bound that keeps each ratio at
least twice that difference inside it), then one with the largest such
bound over the paths, the card's name and power limit beside them.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

PATHS = ("ff_raft_train", "ff_pwcnet_train", "ff_flowformer_train", "raft_train",
         "flowformer_train")


@contextlib.contextmanager
def one_card_form():
    """The losses' means as torch's `mean` (and counts as numbers), the
    batch norms' statistics as torch's mean and biased variance, for the
    duration of the block."""
    import torch

    from focusflow_official_tpu_torch.losses import multiscale, sequence
    from focusflow_official_tpu_torch.nn import norm

    def mean(x, dims, reduce):
        return x.mean(dim=dims)

    def count(n, like, reduce):
        return n

    def batch_stats(self, x):
        xf = x.float()
        n = xf.numel() // xf.shape[1]
        m = xf.mean(dim=(0, 2, 3))
        var = xf.var(dim=(0, 2, 3), unbiased=False)
        with torch.no_grad():
            for run, new in ((self.running_mean, m), (self.running_var, var * n / max(n - 1, 1))):
                run.copy_((1 - norm.MOMENTUM) * run + norm.MOMENTUM * new)
        return m, var

    saved = [(sequence, "_mean", sequence._mean), (multiscale, "_mean", multiscale._mean),
             (multiscale, "_global_count", multiscale._global_count),
             (norm.Norm, "_batch_stats", norm.Norm._batch_stats)]
    sequence._mean = multiscale._mean = mean
    multiscale._global_count = count
    norm.Norm._batch_stats = batch_stats
    try:
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def main(paths) -> int:
    import torch

    if not torch.cuda.is_available():
        print("descent_forms: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke._card_line()
    print(card, flush=True)
    chip_smoke.DESCENT_BOUND = math.inf  # measure, do not gate
    least = []
    for path in paths:
        got = {}
        for form, ctx in (("global count", contextlib.nullcontext), ("one card", one_card_form)):
            with ctx():
                got[form] = chip_smoke.descent_run(torch, path)
            torch.cuda.empty_cache()
        ratios = [got[f]["ratio"] for f in got]
        diff = abs(ratios[0] - ratios[1])
        least.append(max(ratios) + 2 * diff)
        print(json.dumps(dict(path=path, card=card, forms={f: {k: v for k, v in d.items()
                                                                if k != "bound"}
                                                            for f, d in got.items()},
                              ratio_difference=diff, least_bound=least[-1])), flush=True)
    print(json.dumps(dict(card=card, paths=list(paths), least_bound=max(least))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or PATHS))
