"""Entry layer: device ms of the host<->device copies (Memcpy HtoD and
DtoH) a request, over the traced slice."""


def read(ctx):
    if ctx.mode != "serve":
        return None
    s = sum(e - b for name, b, e in ctx.trace.kernels
            if name.startswith(("Memcpy HtoD", "Memcpy DtoH"))) / 1e6
    return 1e3 * s / ctx.slice_steps if s > 0 else None
