"""The model modules' own PyTorch ops (`nn/`, `ops/`, `losses/`): device
ms a request of the kernels in the category "elementwise, softmax,
reductions" (`harness/trace.py::category`), over the traced slice."""

from harness.trace import ELEMENTWISE, by_category


def read(ctx):
    if ctx.mode != "serve":
        return None
    s = by_category(ctx.trace).get(ELEMENTWISE, 0.0)
    return 1e3 * s / ctx.slice_steps if s > 0 else None
