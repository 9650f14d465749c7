"""Host data layer (`data/loader.py::Loader`): host ms a step waits for the
loader's next batch, over the window's steps (timed by the harness around
`next()`)."""


def read(ctx):
    waits = ctx.host_s.get("loader_wait") if ctx.mode == "train" else None
    return 1e3 * sum(waits) / len(waits) if waits else None
