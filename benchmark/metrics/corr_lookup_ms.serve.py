"""ALT_CORR walk (`ops/corr.py::_AltCorrFold.forward`): device ms a request
of kernel G (the window lookup with convc1, one launch a chunk) on the
chunks' levels, the kernel time inside the device spans of
`ff.corr.lookup` (one a chunk walked, 64 a refinement at 3840x2160) over
the traced slice. A program without the span reads nothing."""

from harness.sweep import kernel_seconds_within


def read(ctx):
    if ctx.mode != "serve":
        return None
    s = kernel_seconds_within(ctx.trace, "ff.corr.lookup")
    return 1e3 * s / ctx.slice_steps if s > 0 else None
