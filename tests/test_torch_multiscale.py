"""FF-PWCNet's multiscale losses (`losses/multiscale.py`) against the JAX
package's `build_multiscale_loss`, and at the published crops.

- Every loss type x mode x sparse, at integer factors (a 64x128 ground
  truth under the five levels of a 64x128 input): the loss, the `epe`
  metric and the loss's gradient in each level within 1e-6 relative (f32
  sums in another order).
- At a 368x496 ground truth (`ffpwc_chairs.yaml`'s crop, which the model
  resizes to 384x512, so the finest level is 96x128 and no factor is an
  integer): the targets are `F.interpolate(mode="area")` of the ground
  truth, and the sparse targets the area's largest positive value minus
  its largest negative magnitude, each area as `F.adaptive_avg_pool2d`
  cuts it (rows floor(i H / h) to ceil((i + 1) H / h)). JAX's loss asserts
  integer factors there.
- `multiscale_loss_kwargs_from_yaml` reads every PWC config as JAX's does.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from focusflow_official_tpu.config import load_yaml_config as jax_yaml
from focusflow_official_tpu.config import multiscale_loss_kwargs_from_yaml as jax_kwargs
from focusflow_official_tpu.losses import build_multiscale_loss as jax_loss
from focusflow_official_tpu_torch.config import load_yaml_config, multiscale_loss_kwargs_from_yaml
from focusflow_official_tpu_torch.losses import build_multiscale_loss
from focusflow_official_tpu_torch.losses.multiscale import area_downsample, sparse_max_pool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = [0.005, 0.01, 0.02, 0.08, 0.32]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs its files in parallel worker
    processes, and torch's default of a thread a core in each of them
    oversubscribes the CPU many times over."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _case(seed, gt_hw, finest_hw, b=2, sparse=False):
    rng = np.random.RandomState(seed)
    h, w = finest_hw
    preds = [(rng.randn(b, h >> i, w >> i, 2) * 3).astype(np.float32) for i in range(5)]
    gt = (rng.randn(b, *gt_hw, 2) * 3).astype(np.float32)
    if sparse:  # a third of the pixels invalid: exactly (0, 0)
        gt *= (rng.rand(b, *gt_hw, 1) > 0.33)
    valid = np.ones((b, *gt_hw), np.float32)
    mask = ((rng.rand(b, *gt_hw, 1) > 0.9) * 255).astype(np.float32)
    return preds, gt, valid, mask


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("mode", ["pretrain", "finetune"])
@pytest.mark.parametrize("loss_type", ["EPELoss", "CPCL", "MixLoss"])
def test_matches_jax_at_integer_factors(loss_type, mode, sparse):
    preds, gt, valid, mask = _case(0, (64, 128), (16, 32), sparse=sparse)
    kw = dict(weights=WEIGHTS, mode=mode, q=0.4, eps=0.01, kernel_size=5, sigma=1.7, lamda=0.8,
              sparse=sparse)
    if loss_type == "EPELoss":
        for k in ("kernel_size", "sigma", "lamda"):
            kw.pop(k)
    elif loss_type == "CPCL":
        kw.pop("lamda")
    jfn = jax_loss(loss_type, **kw)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jfn(p, jnp.asarray(gt), jnp.asarray(valid), jnp.asarray(mask)),
        has_aux=True)([jnp.asarray(p) for p in preds])
    tp = [torch.from_numpy(p).requires_grad_(True) for p in preds]
    tl, tm = build_multiscale_loss(loss_type, **kw)(
        tp, torch.from_numpy(gt), torch.from_numpy(valid), torch.from_numpy(mask))
    tl.backward()
    assert tl.dim() == 0 and set(tm) == set(jm) == {"epe", "loss"}
    assert all(v.dim() == 0 and not v.requires_grad for v in tm.values())
    assert abs(float(tl.detach()) - float(jl)) <= 1e-6 * abs(float(jl))
    assert abs(float(tm["epe"]) - float(jm["epe"])) <= 1e-6 * abs(float(jm["epe"]))
    for i, (p, g) in enumerate(zip(tp, jg)):
        g = np.asarray(g)
        assert float(np.abs(p.grad.numpy() - g).max()) <= 1e-6 * float(np.abs(g).max()), i


def _adaptive_areas(size: int, out: int):
    return [(i * size // out, -(-(i + 1) * size // out)) for i in range(out)]


def test_targets_at_the_published_crop():
    """A 368x496 ground truth under 96x128 .. 6x8 levels: area
    interpolation and the sparse block max, area by area."""
    _, gt, _, _ = _case(1, (368, 496), (96, 128), b=1, sparse=True)
    t = torch.from_numpy(gt)
    for hw in ((96, 128), (12, 16), (6, 8)):
        dense = area_downsample(t, hw)
        want = F.interpolate(t.permute(0, 3, 1, 2), size=hw, mode="area").permute(0, 2, 3, 1)
        assert torch.equal(dense, want)
        got = sparse_max_pool(t, hw)[0].numpy()
        for i, (y0, y1) in enumerate(_adaptive_areas(368, hw[0])):
            for j, (x0, x1) in enumerate(_adaptive_areas(496, hw[1])):
                area = gt[0, y0:y1, x0:x1].reshape(-1, 2)
                want = np.maximum(area, 0).max(0) - np.maximum(-area, 0).max(0)
                np.testing.assert_array_equal(got[i, j], want)


@pytest.mark.parametrize("sparse", [False, True])
def test_loss_at_the_published_crop(sparse):
    """MixLoss of `ffpwc_chairs.yaml` at 368x496 against a direct sum over
    the area targets; JAX's asserts integer factors and stops."""
    preds, gt, valid, mask = _case(2, (368, 496), (96, 128), sparse=sparse)
    kw = multiscale_loss_kwargs_from_yaml(
        load_yaml_config(os.path.join(ROOT, "configs", "ff-pwcnet", "ffpwc_chairs.yaml")),
        sparse=sparse)
    kw.pop("loss_type")
    tp = [torch.from_numpy(p) for p in preds]
    loss, metrics = build_multiscale_loss("MixLoss", **kw)(
        tp, torch.from_numpy(gt), torch.from_numpy(valid), torch.from_numpy(mask))
    t = torch.from_numpy(gt)
    want = 0.0
    for p, wgt in zip(tp, kw["weights"]):
        hw = p.shape[1:3]
        target = sparse_max_pool(t, hw) if sparse else F.interpolate(
            t.permute(0, 3, 1, 2), size=tuple(hw), mode="area").permute(0, 2, 3, 1)
        m = torch.sqrt(((target - p) ** 2).sum(-1))
        small = F.interpolate(torch.from_numpy(mask).permute(0, 3, 1, 2), size=tuple(hw),
                              mode="bilinear", align_corners=False)
        mk = (small > 0).float()  # LOSS_KERNEL_SIZE 1: the smear is the identity
        weighted = m * mk[:, 0]
        if sparse:
            weighted = weighted * ~((target[..., 0] == 0) & (target[..., 1] == 0))
        term = weighted.sum() / mk.sum() * (hw[0] * hw[1]) if mk.sum() > 0 else 0.0
        want += wgt * (m.sum() + kw["lamda"] * term)
    assert torch.isfinite(loss) and abs(float(loss) - float(want)) <= 1e-5 * float(want)
    assert torch.isfinite(metrics["epe"])
    with pytest.raises(AssertionError):
        jax_loss("MixLoss", weights=kw["weights"], sparse=sparse)(
            [jnp.asarray(p) for p in preds], jnp.asarray(gt), jnp.asarray(valid),
            jnp.asarray(mask))


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(ROOT, "configs", "ff-pwcnet",
                                                               "*.yaml"))
                                        + glob.glob(os.path.join(ROOT, "configs",
                                                                 "smoke_pwc*.yaml"))),
                         ids=os.path.basename)
def test_loss_kwargs_equal_jax(path):
    for sparse in (False, True):
        assert multiscale_loss_kwargs_from_yaml(load_yaml_config(path), sparse) == \
            jax_kwargs(jax_yaml(path), sparse)
