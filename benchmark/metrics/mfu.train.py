"""Model step (`models/ff_raft.py`, `models/ff_flowformer.py`, with
`train/loop.py`): the model FLOPs of a step (forward and backward),
counted on the frozen reference at the cell's shapes, times the window's
steps, over the window's host-clock seconds, over the bf16 peak
(989 TFLOP/s), in %. The window is the traced run's unprofiled one."""

from harness.roofline import BF16_FLOPS


def read(ctx):
    if ctx.mode != "train" or not ctx.flops_per_step:
        return None
    return 100.0 * ctx.flops_per_step * ctx.window_steps / ctx.window_s / BF16_FLOPS
