"""Model step (`train/loop.py::train_step`): device ms a step of the
optimizer's part (zero gradients, clip, AdamW, schedule): the kernel time
from the first kernel of `ff.step.optimizer` and the ranges inside it
(AdamW's own) to the last (`harness/spans.py`), over the traced slice's
steps."""

from harness.spans import busy_us, step_phases


def read(ctx):
    steps = step_phases(ctx.trace) if ctx.mode == "train" else []
    if not steps:
        return None
    return sum(busy_us(ctx.trace, *o) for _, o in steps) / len(steps) / 1e3
