"""Model step (`train/loop.py::train_step`): device ms a step of the
backward: the kernel time from the end of the forward's device interval to
the start of the optimizer's (`harness/spans.py`). Autograd launches the
backward from a thread that holds no range, and the one stream runs
forward, backward and optimizer in that order."""

from harness.spans import busy_us, step_phases


def read(ctx):
    steps = step_phases(ctx.trace) if ctx.mode == "train" else []
    if not steps:
        return None
    return sum(busy_us(ctx.trace, f[1], o[0]) for f, o in steps) / len(steps) / 1e3
