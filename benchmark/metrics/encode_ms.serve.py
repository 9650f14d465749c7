"""Model step (`models/ff_raft.py`, `models/ff_flowformer.py`): device ms a
request of the encoders, the kernel time inside the device spans of
`ff.model.encode` (FF-RAFT's masks, fnet and cnet; FF-FlowFormer's two
towers) over the traced slice. Only kernel time counts: the spans' idle
follows the profiled host's pace."""

from harness.trace import kernel_seconds_in


def read(ctx):
    if ctx.mode != "serve":
        return None
    s = kernel_seconds_in(ctx.trace, "ff.model.encode")
    return 1e3 * s / ctx.slice_steps if s > 0 else None
