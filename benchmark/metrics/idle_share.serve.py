"""Device: the share of a request's time in which no kernel ran, in %: one
minus the busy seconds a request of the traced slice (the union of kernel
intervals) over the seconds a request of the unprofiled window (host clock),
so that the profiler's own host time does not count as idle."""

from harness.trace import busy_s


def read(ctx):
    if ctx.mode != "serve" or not ctx.trace.kernels:
        return None
    return 100.0 * (1.0 - (busy_s(ctx.trace) / ctx.slice_steps)
                    / (ctx.window_s / ctx.window_steps))
