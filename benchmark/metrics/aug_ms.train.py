"""Device data layer (`data/device_aug.py`): device ms a step of the
kernels inside the `device_aug` range (`train/loop.py::train_step`), over
the traced slice."""

from harness.trace import kernel_seconds_in


def read(ctx):
    if ctx.mode != "train":
        return None
    s = kernel_seconds_in(ctx.trace, "device_aug")
    return 1e3 * s / ctx.slice_steps if s > 0 else None
