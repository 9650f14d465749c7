"""Entry layer (`predict.py::FlowPredictor`): host ms from the call until
`forward` returns its device tensor (`prepare`, then `forward`), a
request, over the traced run's requests timed without the profiler (its
host time on every launch would count in them). At or above the device's
busy ms a request, the host sets the pace."""


def read(ctx):
    if ctx.mode != "serve" or not ctx.host_s.get("enqueue"):
        return None
    return 1e3 * sum(ctx.host_s["enqueue"]) / len(ctx.host_s["enqueue"])
