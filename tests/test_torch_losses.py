"""The port's sequence losses (`losses/sequence.py`) against the JAX
package's on the same numpy inputs, f32 on the CPU: EPE, CPCL and Mix,
their values, their gradients with respect to every flow of the sequence
(`jax.grad`), and the metrics both have (`epe`, `loss`) within 1e-5
relative; the port's further metrics (`1px`, `3px`, `5px`, the keypoint EPE
`kpt_epe`) against numpy; `smear_mask` against JAX's; the loss builder
against the YAML reader (`config.py::loss_kwargs_from_yaml`)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from focusflow_official_tpu import config as jcfg
from focusflow_official_tpu.losses import build_sequence_loss as jax_build
from focusflow_official_tpu.losses.sequence import smear_mask as jax_smear
from focusflow_official_tpu_torch import config as tcfg
from focusflow_official_tpu_torch.losses import build_sequence_loss, smear_mask

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, B, H, W = 3, 2, 24, 32


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    preds = (rng.randn(N, B, H, W, 2) * 3).astype(np.float32)
    gt = (rng.randn(B, H, W, 2) * 3).astype(np.float32)
    gt[0, :2, :3] = 500.0  # past max_flow
    valid = (rng.rand(B, H, W) > 0.2).astype(np.float32)
    mask = ((rng.rand(B, H, W, 1) > 0.9) * 255).astype(np.float32)
    return preds, gt, valid, mask


KINDS = [("EPELoss", {}), ("CPCL", {}), ("MixLoss", {}),
         ("MixLoss", dict(kernel_size=1, sigma=0.01, lamda=1.0)),  # the chairs YAMLs'
         ("CPCL", dict(gamma=0.85, max_flow=10.0, kernel_size=7, sigma=2.0))]


@pytest.mark.parametrize("kind,kw", KINDS)
def test_loss_value_metrics_and_gradient_match_jax(kind, kw):
    preds, gt, valid, mask = _inputs()
    jfn = jax_build(kind, **kw)
    (jl, jm), jg = jax.value_and_grad(lambda p: jfn(p, jnp.asarray(gt), jnp.asarray(valid),
                                                    jnp.asarray(mask)), has_aux=True)(
        jnp.asarray(preds))
    p = torch.from_numpy(preds).requires_grad_(True)
    loss, metrics = build_sequence_loss(kind, **kw)(p, torch.from_numpy(gt),
                                                   torch.from_numpy(valid),
                                                   torch.from_numpy(mask))
    (g,) = torch.autograd.grad(loss, p)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for k in ("epe", "loss"):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]), rtol=1e-5)
    gj = np.asarray(jg)
    assert float(np.abs(g.numpy() - gj).max()) <= 1e-5 * float(np.abs(gj).max())
    assert ("kpt_epe" in metrics) == (kind != "EPELoss")


def test_threshold_and_keypoint_metrics():
    preds, gt, valid, mask = _inputs(1)
    _, m = build_sequence_loss("MixLoss")(*map(torch.from_numpy, (preds, gt, valid, mask)))
    epe = np.sqrt(((preds[-1] - gt) ** 2).sum(-1))
    v = (valid >= 0.5) & (np.sqrt((gt ** 2).sum(-1)) < 400)
    for px in (1, 3, 5):
        np.testing.assert_allclose(float(m[f"{px}px"]), (epe[v] < px).mean(), rtol=1e-6)
    sel = v & (mask[..., 0] > 0)
    np.testing.assert_allclose(float(m["kpt_epe"]), epe[sel].mean(), rtol=1e-5)


@pytest.mark.parametrize("k,sigma", [(1, 0.01), (5, 1.7), (7, 2.5)])
def test_smear_mask_matches_jax(k, sigma):
    _, _, _, mask = _inputs(2)
    got = smear_mask(torch.from_numpy(mask), k, sigma).numpy()
    want = np.asarray(jax_smear(jnp.asarray(mask), k, sigma))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("path", ["configs/smoke_chairs.yaml",
                                  "configs/ff-raft/experiment/ffraft_chairs_orb.yaml",
                                  "configs/ff-flowformer/ff_chairs.yaml"])
def test_loss_and_optimizer_readers_match_jax(path):
    full = os.path.join(ROOT, path)
    ours, theirs = tcfg.load_yaml_config(full), jcfg.load_yaml_config(full)
    assert tcfg.loss_kwargs_from_yaml(ours) == jcfg.loss_kwargs_from_yaml(theirs)
    assert tcfg.optimizer_kwargs_from_yaml(ours) == jcfg.optimizer_kwargs_from_yaml(theirs)


def test_unknown_loss_refused():
    with pytest.raises(ValueError, match="not supported"):
        build_sequence_loss("L2Loss")
