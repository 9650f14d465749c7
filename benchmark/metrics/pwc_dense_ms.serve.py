"""PWC decoders (`nn/pwc.py::PWCDecoder`, inside `ff.model.refine`): device
ms a request of the DenseNet stacks, the kernel time inside the device
spans of `ff.pwc.dense` (each level's concatenation of volume and features,
its five convs with their leaky ReLUs and concatenations, and the flow
conv; five a pair) over the traced slice. A program without the span reads
nothing."""

from harness.sweep import kernel_seconds_within


def read(ctx):
    if ctx.mode != "serve":
        return None
    s = kernel_seconds_within(ctx.trace, "ff.pwc.dense")
    return 1e3 * s / ctx.slice_steps if s > 0 else None
