"""PWC decoders (`nn/pwc.py::PWCDecoder`, inside `ff.model.refine`): device
ms a request of the up-sampling and the warp, the kernel time inside the
device spans of `ff.pwc.warp` (in each decoder below level 6, four a pair:
the transposed convs of the flow and the features, the backward warp of
the second frame's features) over the traced slice. A program without the
span reads nothing."""

from harness.sweep import kernel_seconds_within


def read(ctx):
    if ctx.mode != "serve":
        return None
    s = kernel_seconds_within(ctx.trace, "ff.pwc.warp")
    return 1e3 * s / ctx.slice_steps if s > 0 else None
