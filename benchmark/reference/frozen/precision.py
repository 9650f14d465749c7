"""TF32 off in cuBLAS matmuls and cuDNN convolutions inside a block, the
caller's settings put back after it (frozen from the port's
`predict.py::_no_tf32`)."""

from __future__ import annotations

import contextlib

import torch

_TF32_BACKENDS = (torch.backends.cuda.matmul, torch.backends.cudnn.conv)


@contextlib.contextmanager
def no_tf32():
    saved = [b.fp32_precision for b in _TF32_BACKENDS]
    try:
        for b in _TF32_BACKENDS:
            b.fp32_precision = "ieee"
        yield
    finally:
        for b, precision in zip(_TF32_BACKENDS, saved):
            b.fp32_precision = precision
