"""An f32 `FlowPredictor` is full f32: its forward runs with TF32 off in
matmuls and convolutions (as the JAX package's f32 path asks for `HIGHEST`
precision), whatever the caller's flags, and puts the caller's flags back
after the call, also after a call that raises. A bf16 predictor leaves the
flags alone. The flags are global, so this runs on the CPU too; the card
test of the same predictor under the default flags is in
`test_torch_cuda.py`."""

import os

import numpy as np
import pytest
import torch

from focusflow_official_tpu_torch.models import FFRaftConfig
from focusflow_official_tpu_torch.predict import FlowPredictor

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "trained_smoke.npz")
CFG = FFRaftConfig(fusion="parallel", fusion_type="1x1conv", fuse_cnet=True, iters=2)


BACKENDS = (torch.backends.cuda.matmul, torch.backends.cudnn.conv)


def _flags():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


def _precisions():
    """What decides TF32 in matmuls and convolutions: each backend's own
    `fp32_precision` ("ieee" is full f32)."""
    return tuple(b.fp32_precision for b in BACKENDS)


@pytest.fixture
def restore_precision():
    """The process's precision settings put back after the test."""
    legacy = torch.get_float32_matmul_precision()
    saved = _precisions()
    yield
    torch.set_float32_matmul_precision(legacy)
    for b, precision in zip(BACKENDS, saved):
        b.fp32_precision = precision


@pytest.fixture
def tf32_on(restore_precision):
    """Both TF32 flags True for the test."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True


def _inputs(h=64, w=64):
    rng = np.random.RandomState(0)
    i1 = (rng.rand(h, w, 3) * 255).astype(np.float32)
    i2 = np.roll(i1, 2, 1)
    return i1, i2


def _recording(dtype):
    """A CPU predictor whose model records the backends' precision at each
    forward."""
    p = FlowPredictor(CFG, FIXTURE, device="cpu", dtype=dtype)
    seen = []
    p.model.register_forward_hook(lambda *_: seen.append(_precisions()))
    return p, seen


def test_f32_forward_runs_without_tf32(tf32_on):
    p, seen = _recording(torch.float32)
    flow = p(*_inputs())
    assert flow.shape == (64, 64, 2) and np.isfinite(flow).all()
    assert seen == [("ieee", "ieee")]
    assert _flags() == (True, True)


def test_f32_flags_restored_after_a_raise(tf32_on):
    p, seen = _recording(torch.float32)

    def fail(*_):
        raise RuntimeError("inside the forward")

    p.model.register_forward_hook(fail)
    with pytest.raises(RuntimeError, match="inside the forward"):
        p(*_inputs())
    assert seen == [("ieee", "ieee")]
    assert _flags() == (True, True)


def test_bf16_forward_keeps_the_callers_flags(tf32_on):
    p, seen = _recording(torch.bfloat16)
    p(*_inputs())
    assert seen == [("tf32", "tf32")]
    assert _flags() == (True, True)


@pytest.mark.parametrize("matmul", ["medium", "high"])
def test_f32_keeps_the_callers_matmul_precision(restore_precision, matmul):
    """A caller's `set_float32_matmul_precision` comes back as it was, not
    as the nearest boolean ("medium" is not "high")."""
    torch.set_float32_matmul_precision(matmul)
    p, seen = _recording(torch.float32)
    p(*_inputs())
    assert seen == [("ieee", "ieee")]
    assert torch.get_float32_matmul_precision() == matmul


def test_f32_keeps_the_callers_backend_precision(restore_precision):
    """A caller who set the backends' own `fp32_precision` (where PyTorch
    refuses the boolean flags) gets those settings back."""
    for b in BACKENDS:
        b.fp32_precision = "tf32"
    p, seen = _recording(torch.float32)
    p(*_inputs())
    assert seen == [("ieee", "ieee")]
    assert _precisions() == ("tf32", "tf32")
