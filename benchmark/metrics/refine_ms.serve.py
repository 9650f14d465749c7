"""Model step (`models/ff_raft.py`, `models/ff_flowformer.py`): device ms a
request of the refinements, the kernel time inside the device spans of
`ff.model.refine` (FF-RAFT's update loop and upsampling; FF-FlowFormer's
decoder) over the traced slice. Only kernel time counts: the spans' idle
follows the profiled host's pace."""

from harness.trace import kernel_seconds_in


def read(ctx):
    if ctx.mode != "serve":
        return None
    s = kernel_seconds_in(ctx.trace, "ff.model.refine")
    return 1e3 * s / ctx.slice_steps if s > 0 else None
