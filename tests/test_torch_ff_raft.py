"""The port's FF-RAFT end to end against the JAX package, on the trained
fixture weights (`tests/fixtures/trained_smoke.npz`, the main-path config
at full width), in f32 at 96x128."""

import os
import subprocess
import sys

import numpy as np
import torch

import jax.numpy as jnp
from flax import traverse_util

from focusflow_official_tpu.models import FFRaft as JFFRaft
from focusflow_official_tpu.models import FFRaftConfig as JConfig
from focusflow_official_tpu_torch.compat.weights import load_npz
from focusflow_official_tpu_torch.models import FFRaft, FFRaftConfig
from focusflow_official_tpu_torch.predict import FlowPredictor

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "trained_smoke.npz")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = FFRaftConfig(fusion="parallel", fusion_type="1x1conv", fuse_cnet=True)


def _shift_inputs(seed=0, h=96, w=128):
    """White-noise frame and its copy shifted by (3, -2), sparse masks."""
    rng = np.random.RandomState(seed)
    i1 = (rng.rand(1, h, w, 3) * 255).astype(np.float32)
    dx, dy = 3, -2
    i2 = np.roll(np.roll(i1, dy, 1), dx, 2)
    m1 = ((rng.rand(1, h, w, 1) > 0.97) * 255).astype(np.float32)
    m2 = ((rng.rand(1, h, w, 1) > 0.97) * 255).astype(np.float32)
    return i1, i2, m1, m2, (dx, dy)


def test_params_from_jax_loads_fixture_strict():
    sd = load_npz(FIXTURE)
    with np.load(FIXTURE) as raw:
        assert len(sd) == len(raw.files) == 314
    model = FFRaft(CFG)
    model.load_state_dict(sd, strict=True)  # raises on any missing/extra key
    w = model.flow_net.update_block.encoder.convc1.weight
    assert tuple(w.shape) == (256, 324, 1, 1)
    with np.load(FIXTURE) as raw:
        k = raw["params/flow_net/update_step/update_block/encoder/convc1/kernel"]
    np.testing.assert_array_equal(w[:, :, 0, 0].detach().numpy(),
                                  k[0, 0].T.astype(np.float32))


def test_flow_matches_jax(monkeypatch):
    for knob in ("FF_CHUNKED_FNET", "FF_PACKED_CCE", "FF_PACKED_CCE_BN",
                 "FF_PACKED_STEM"):
        monkeypatch.setenv(knob, "0")
    i1, i2, m1, m2, _ = _shift_inputs(seed=1)
    iters = 4
    with np.load(FIXTURE) as raw:
        v = traverse_util.unflatten_dict(
            {tuple(k.split("/")): jnp.asarray(raw[k], jnp.float32)
             for k in raw.files})
    jcfg = JConfig(fusion="parallel", fusion_type="1x1conv", fuse_cnet=True,
                   corr_impl="xla")
    want_lr, want = JFFRaft(jcfg).apply(
        v, *map(jnp.asarray, (i1, i2, m1, m2)), iters=iters, test_mode=True)

    model = FFRaft(CFG).eval()
    model.load_state_dict(load_npz(FIXTURE), strict=True)
    with torch.inference_mode():
        got_lr, got = model(*map(torch.from_numpy, (i1, i2, m1, m2)),
                            iters=iters)
    assert got.shape == want.shape == (1, 96, 128, 2)
    # the README's stated parity with the reference: 1e-2 px
    assert float(np.abs(got_lr.numpy() - np.asarray(want_lr)).max()) <= 1e-2
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= 1e-2


def test_predictor_recovers_shift():
    """The trained weights solve the constant-shift probe through the
    port's entry point: interior EPE well below the ~40 px of chaos."""
    i1, i2, m1, m2, (dx, dy) = _shift_inputs(seed=0)
    p = FlowPredictor(CFG, FIXTURE, device="cpu")
    flow = p(i1[0], i2[0], m1[0], m2[0])
    assert flow.shape == (96, 128, 2) and np.isfinite(flow).all()
    epe = np.sqrt(((flow[8:-8, 8:-8] - np.array([dx, dy])) ** 2).sum(-1))
    assert float(epe.mean()) < 6.0, float(epe.mean())


def test_port_imports_no_jax():
    """Every module of the port, found by walking the package, imports
    without pulling in jax, flax or the JAX package."""
    code = ("import importlib, pkgutil, sys\n"
            "import focusflow_official_tpu_torch as pkg\n"
            "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
            "pkg.__name__ + '.', onerror=lambda name: (_ for _ in ()).throw("
            "ImportError(name)))]\n"
            "assert len(names) >= 30 and pkg.__name__ + '.predict' in names, names\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'focusflow_official_tpu'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
