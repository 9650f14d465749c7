"""PWC decoders (`nn/pwc.py::PWCDecoder`, inside `ff.model.refine`): device
ms a request of the cost volumes, the kernel time inside the device spans
of `ff.pwc.corr` (each level's local correlation: kernel D with its leaky
ReLU, five a pair) over the traced slice. A program without the span reads
nothing."""

from harness.sweep import kernel_seconds_within


def read(ctx):
    if ctx.mode != "serve":
        return None
    s = kernel_seconds_within(ctx.trace, "ff.pwc.corr")
    return 1e3 * s / ctx.slice_steps if s > 0 else None
