"""Kernels layer (`kernels/csrc/*.cu`): for every launch of the port's
kernels in the traced slice, the least time the chip could take
(`harness/roofline.py`, from the launch's shape in `launch_shapes`),
summed, over the device time of those kernels, in %."""

from harness.roofline import least_total
from harness.trace import PORT, by_category


def read(ctx):
    if ctx.mode != "serve":
        return None
    spent = by_category(ctx.trace).get(PORT, 0.0)
    if spent <= 0 or not ctx.launch_shapes:
        return None
    return 100.0 * least_total(ctx.launch_shapes) / spent
