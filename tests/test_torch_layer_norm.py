"""The port's LayerNorm (`kernels/layer_norm.py`) on the CPU: the module's
output equals the former forward (a cast to f32, `F.layer_norm`, a cast
back) bit for bit, the Function's forward and its plain backward equal
autograd through the plain version, the launch counter, the entries, and
the LayerNorm calls of an FF-FlowFormer forward against the counts that
`chip_smoke.py` holds the card's launches to. The kernel itself runs on
the card only (`tests/test_torch_cuda.py`)."""

import itertools

import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from focusflow_official_tpu_torch import kernels
from focusflow_official_tpu_torch.config import model_from_config
from focusflow_official_tpu_torch.kernels import layer_norm as kln
from focusflow_official_tpu_torch.models import FlowFormerConfig
from focusflow_official_tpu_torch.nn.twins import LayerNorm

WIDTHS = (64, 128, 256, 37)
DTYPES = (torch.bfloat16, torch.float32)


def _former_forward(m: LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """`LayerNorm.forward` as it was before the kernel."""
    y = F.layer_norm(x.float(), x.shape[-1:], m.weight.float(), m.bias.float(), m.eps)
    return y.to(x.dtype)


def _inputs(c: int, dtype, wdtype=torch.float32, rows=(3, 50), seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(*rows, c, generator=g) * 3 + 1).to(dtype)
    w = (1 + 0.1 * torch.randn(c, generator=g)).to(wdtype)
    b = (0.1 * torch.randn(c, generator=g)).to(wdtype)
    return x, w, b


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", WIDTHS)
def test_module_equals_the_former_forward(dtype, c):
    m = LayerNorm(c, eps=1e-5)
    x, w, b = _inputs(c, dtype)
    with torch.no_grad():
        m.weight.copy_(w)
        m.bias.copy_(b)
    got = m(x)
    assert got.dtype == dtype
    assert torch.equal(got, _former_forward(m, x))
    # the Function's forward on the CPU (`native_layer_norm`, what F.layer_norm runs)
    y, mean, rstd = kln._rows(x, m.weight, m.bias, m.eps, stats=True)
    assert torch.equal(y, got)
    assert mean.shape == rstd.shape == x.shape[:-1] + (1,)
    assert mean.dtype == rstd.dtype == torch.float32


@pytest.mark.parametrize("dtype,wdtype", [(torch.bfloat16, torch.float32),
                                          (torch.float32, torch.float32),
                                          (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("c", WIDTHS)
def test_function_equals_autograd_through_the_plain_version(dtype, wdtype, c):
    """The Function (forward on the CPU, `layer_norm_vjp` backward) against
    autograd through `layer_norm_plain`: the same output and gradients for
    x, weight and bias, bit for bit."""
    x, w, b = _inputs(c, dtype, wdtype)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(1)).to(dtype)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    y = kln._LayerNorm.apply(*leaves, 1e-6)
    got = torch.autograd.grad(y, leaves, g)
    ref = [t.clone().requires_grad_(True) for t in (x, w, b)]
    y_ref = kln.layer_norm_plain(*ref, 1e-6)
    want = torch.autograd.grad(y_ref, ref, g)
    assert torch.equal(y, y_ref)
    for a, e in zip(got, want):
        assert a.dtype == e.dtype and torch.equal(a, e)


@pytest.mark.parametrize("needs", list(itertools.product((True, False), repeat=3)))
def test_vjp_given_the_aten_statistics(needs):
    """`layer_norm_vjp` with the mean and rstd that `F.layer_norm`'s aten op
    returns equals autograd through the plain version for each gradient
    asked, and gives None for the others."""
    x, w, b = _inputs(128, torch.bfloat16)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(2)).to(x.dtype)
    _, mean, rstd = torch.ops.aten.native_layer_norm(x.float(), [128], w, b, 1e-5)
    got = kln.layer_norm_vjp(g, x, mean, rstd, w, b, needs)
    ref = [t.clone().requires_grad_(True) for t in (x, w, b)]
    want = torch.autograd.grad(kln.layer_norm_plain(*ref, 1e-5), ref, g)
    for need, a, e in zip(needs, got, want):
        if need:
            assert a.dtype == e.dtype and torch.equal(a, e)
        else:
            assert a is None


def test_wrapper_on_the_cpu_takes_the_plain_version_with_autograd():
    x, w, b = _inputs(64, torch.bfloat16)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    y = kln.layer_norm(*leaves, 1e-5)
    assert y.grad_fn is not None and "LayerNorm" not in type(y.grad_fn).__name__
    assert torch.equal(y, kln.layer_norm_plain(x, w, b, 1e-5))


def test_launch_counter_has_the_key_and_no_shapes():
    assert "layer_norm" in kernels.launch_counts
    kernels.launch_counts["layer_norm"] = 5
    kernels.reset_launch_counts()
    assert kernels.launch_counts["layer_norm"] == 0
    x, w, b = _inputs(128, torch.bfloat16)
    kln.layer_norm(x, w, b, 1e-5)  # the CPU launches nothing
    assert kernels.launch_counts["layer_norm"] == 0
    assert not any(k[0] == "layer_norm" for k in kernels.launch_shapes)


@pytest.mark.parametrize("c,dtype,offset,entry", [
    (64, torch.bfloat16, 0, "vector"), (128, torch.bfloat16, 0, "vector"),
    (256, torch.bfloat16, 0, "vector"), (128, torch.float32, 0, "vector"),
    (1024, torch.bfloat16, 0, "vector"),   # 128 vectors: 4 a lane
    (1032, torch.bfloat16, 0, "scalar"),   # 129 vectors: past the vector entry
    (100, torch.bfloat16, 0, "scalar"),    # 200-byte rows
    (37, torch.float32, 0, "scalar"),
    (64, torch.bfloat16, 1, "scalar"),     # a view 2 bytes past a 16-byte boundary
    (64, torch.bfloat16, 8, "vector"),     # 16 bytes past
])
def test_design(c, dtype, offset, entry):
    flat = torch.empty(4 * c + 16, dtype=dtype)
    base = (-flat.data_ptr() % 16) // flat.element_size()  # the first 16-byte boundary
    x = flat[base + offset:base + offset + 4 * c].view(4, c)
    assert kln.design(x) == entry


def test_other_devices_raise():
    x = torch.empty((2, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kln.layer_norm(x, torch.ones(64, device="meta"), torch.zeros(64, device="meta"), 1e-5)


def _count_calls(cfg) -> int:
    """LayerNorm module calls of one test-mode forward of `cfg`'s model on
    the CPU at 64x96, fresh weights."""
    torch.manual_seed(0)
    model, iters = model_from_config(cfg)
    model.eval()
    calls = []
    for m in model.modules():
        if isinstance(m, LayerNorm):
            m.register_forward_hook(lambda *_: calls.append(1))
    g = torch.Generator().manual_seed(0)
    img = [torch.rand((1, 64, 96, 3), generator=g) * 255 for _ in range(2)]
    masks = [torch.zeros((1, 64, 96, 1)) for _ in range(2)]
    with torch.inference_mode():
        model(*img, *masks, iters=iters)
    return len(calls)


@pytest.mark.parametrize("fields", [
    dict(),  # the shipped model: 48 in the towers, 27 in the perceiver, 24 in the decoder
    dict(fusion=None, decoder_depth=2),
    dict(use_mlp=True, gma=False, decoder_depth=2),
    dict(vertical_conv=True, decoder_depth=2),
    dict(add_flow_token=False, encoder_depth=1, decoder_depth=2),
    dict(patch_size=4, encoder_depth=2, decoder_depth=3),
])
def test_flowformer_layer_norm_calls_are_chip_smokes_count(fields):
    """Each LayerNorm call is one launch on the card: the calls of a
    forward equal the count `chip_smoke.py` holds every FF-FlowFormer path
    to (99 for the shipped depth 3 and 12 refinements). The variants run 2
    or 3 refinements: the count's decoder term is linear in the depth, so
    two depths besides the shipped one hold it."""
    cfg = FlowFormerConfig(**fields)
    want = chip_smoke._ff_variant_launches(cfg)["layer_norm"]
    if not fields:
        assert want == 99
    assert _count_calls(cfg) == want
