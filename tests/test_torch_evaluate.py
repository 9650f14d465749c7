"""The port's validation protocol and submission writers against the JAX
package's.

- The protocol alone: the same deterministic stand-in flow model in both
  packages (a flax module and an `nn.Module`; its flow depends on both
  frames, the mask, the padding and the refinement count) through
  `validate_chairs`, `validate_sintel` and `validate_kitti` on mixed-shape
  data, KITTI sparse and held against JAX's `canonical=None` (the
  reference's per-shape padding). Tolerance: 1e-5 relative (f32 sums in
  another order).
- The submission writers on the same stand-in: the same `.flo` values
  (1e-5) and the same KITTI PNGs, Sintel with its warm start.
- The slice as a whole: `cli.evaluate.main --device cpu` on an on-disk
  FlyingChairs tree at 96x128 with the trained FF-RAFT fixture and 4
  refinements, against JAX `validate_chairs` on the same files and
  weights. Tolerance: 1e-3 px.
"""

import json
import os

import numpy as np
import pytest
import torch

import cv2
import flax.linen as fnn
import jax.numpy as jnp
from flax import traverse_util
from PIL import Image

from focusflow_official_tpu.data.datasets import FlyingChairs as JFlyingChairs
from focusflow_official_tpu.models import FFRaft as JFFRaft
from focusflow_official_tpu.models import FFRaftConfig as JConfig
from focusflow_official_tpu.train import evaluate as jev
from focusflow_official_tpu.train import submission as jsub
from focusflow_official_tpu_torch.cli import evaluate as cli
from focusflow_official_tpu_torch.data import io as tio
from focusflow_official_tpu_torch.data import synthetic
from focusflow_official_tpu_torch.train import evaluate as tev
from focusflow_official_tpu_torch.train import submission as tsub

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "trained_smoke.npz")


def _stub_flow(xp, roll, image1, image2, mask1, iters, flow_init):
    """A flow that reads both frames (one rolled: the padding changes it),
    the keypoint mask and the refinement count, and the warm start."""
    d = image1[..., :2] - roll(image2[..., 1:], 1, 2)
    flow = d / 30.0 + mask1 / 255.0 * 2.0 + 0.05 * iters
    return flow if flow_init is None else flow + 0.5 * flow_init


class JStub(fnn.Module):
    @fnn.compact
    def __call__(self, image1, image2, mask1=None, mask2=None, iters=12, flow_init=None,
                 test_mode=False):
        return _stub_flow(jnp, lambda x, s, a: jnp.roll(x, s, a), image1, image2, mask1,
                          iters, flow_init)


class TStub(torch.nn.Module):
    def forward(self, image1, image2, mask1, mask2, iters=12, flow_init=None):
        return _stub_flow(torch, lambda x, s, a: torch.roll(x, s, a), image1, image2, mask1,
                          iters, flow_init)


def _samples(seed, shapes, sparse, extra=None, no_keypoints=()):
    rng = np.random.RandomState(seed)
    out = []
    for i, (h, w) in enumerate(shapes):
        s = dict(image1=(rng.rand(h, w, 3) * 255).astype(np.float32),
                 image2=(rng.rand(h, w, 3) * 255).astype(np.float32),
                 flow=(rng.randn(h, w, 2) * 6).astype(np.float32),
                 mask1=((rng.rand(h, w, 1) > 0.9) * 255).astype(np.float32),
                 mask2=((rng.rand(h, w, 1) > 0.9) * 255).astype(np.float32),
                 valid=((rng.rand(h, w) < 0.3) if sparse else np.ones((h, w))).astype(np.float32))
        if i in no_keypoints:
            s["mask1"][:] = 0  # this frame's keypoint EPE is NaN
        if extra is not None:
            s["extra_info"] = extra[i]
        out.append(s)
    return synthetic.InMemoryDataset(out)


def _close(got: dict, want: dict, rel: float):
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= rel * max(1.0, abs(want[k])), (k, got[k], want[k])


def test_validate_chairs_equals_jax():
    ds = _samples(0, [(32, 48)] * 3, sparse=False, no_keypoints=(1,))
    want = jev.validate_chairs(JStub(), {}, ds, "orb", iters=5)
    got = tev.validate_chairs(TStub(), ds, "orb", iters=5)
    _close(got, want, 1e-5)
    assert np.isfinite(list(got.values())).all()


def test_validate_sintel_equals_jax():
    """Sizes that are not a multiple of 8: the centred 'sintel' pad."""
    dss = {"clean": _samples(1, [(30, 44), (30, 44)], sparse=False),
           "final": _samples(2, [(30, 44), (30, 44)], sparse=False)}
    want = jev.validate_sintel(JStub(), {}, dss, "gf", iters=7)
    got = tev.validate_sintel(TStub(), dss, "gf", iters=7)
    _close(got, want, 1e-5)
    assert len(got) == 4


def test_validate_kitti_equals_jax_per_shape():
    """Mixed shapes, sparse valid, held against the per-shape padding."""
    ds = _samples(3, [(27, 45), (30, 50), (27, 45)], sparse=True)
    want = jev.validate_kitti(JStub(), {}, ds, "orb", iters=3, canonical=None)
    got = tev.validate_kitti(TStub(), ds, "orb", iters=3)
    _close(got, want, 1e-5)
    assert 0 < got["kitti-f1"] < 100


def test_frame_metrics_by_hand():
    """One 1x3 frame: EPEs 0, 5 and 1; only the middle pixel valid and an
    outlier; a keypoint on the first."""
    flow = torch.tensor([[[0.0, 0.0], [3.0, 4.0], [1.0, 0.0]]])
    gt = torch.zeros_like(flow)
    gt[0, 1] = torch.tensor([0.0, 0.5])  # |gt| 0.5: epe/mag > 0.05
    valid = torch.tensor([[0.0, 1.0, 0.0]])
    mask1 = torch.tensor([[[255.0], [0.0], [0.0]]])
    epe1 = float(np.hypot(3.0, 3.5))
    dense = tev.frame_metrics(flow, gt, valid, mask1, sparse=False).numpy()
    np.testing.assert_allclose(dense, [epe1 + 1, 3, 0, (epe1 + 1) / 3, 1, 3], rtol=1e-6)
    sparse = tev.frame_metrics(flow, gt, valid, mask1, sparse=True).numpy()
    assert np.isnan(sparse[2])
    np.testing.assert_allclose(sparse[[0, 1, 3, 4, 5]], [epe1, 1, epe1, 1, 1], rtol=1e-6)


def test_sintel_submission_equals_jax(tmp_path):
    """Two scenes, warm start within each: the same .flo files."""
    extra = [("alley_1", 0), ("alley_1", 1), ("cave_2", 0)]
    dss = {"clean": _samples(4, [(30, 44)] * 3, sparse=False, extra=extra)}
    for s in (dss["clean"].samples):
        del s["flow"], s["valid"]
    jsub.create_sintel_submission(JStub(), {}, dss, str(tmp_path / "jax"), iters=2,
                                  warm_start=True)
    tsub.create_sintel_submission(TStub(), dss, str(tmp_path / "port"), iters=2,
                                  warm_start=True)
    for scene, frame in extra:
        name = os.path.join("clean", scene, f"frame{frame + 1:04d}.flo")
        want = tio.read_flo(str(tmp_path / "jax" / name))
        got = tio.read_flo(str(tmp_path / "port" / name))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the warm start reaches the second pair of a scene, not the next scene
    tsub.create_sintel_submission(TStub(), dss, str(tmp_path / "cold"), iters=2)
    for (scene, frame), warm in zip(extra, (False, True, False)):
        name = os.path.join("clean", scene, f"frame{frame + 1:04d}.flo")
        same = np.array_equal(tio.read_flo(str(tmp_path / "port" / name)),
                              tio.read_flo(str(tmp_path / "cold" / name)))
        assert same != warm, name


def test_kitti_submission_equals_jax(tmp_path):
    extra = [["000000_10.png"], ["000001_10.png"]]
    ds = _samples(5, [(27, 45), (30, 50)], sparse=True, extra=extra)
    jsub.create_kitti_submission(JStub(), {}, ds, str(tmp_path / "jax"), iters=4)
    tsub.create_kitti_submission(TStub(), ds, str(tmp_path / "port"), iters=4)
    for (name,) in extra:
        want = cv2.imread(str(tmp_path / "jax" / name), cv2.IMREAD_UNCHANGED)
        got = cv2.imread(str(tmp_path / "port" / name), cv2.IMREAD_UNCHANGED)
        assert got.dtype == np.uint16
        # u16 codes of 64 flow + 2^15: equal up to one code where f32 sums differ
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


@pytest.fixture(scope="module")
def chairs_tree(tmp_path_factory):
    """A FlyingChairs tree at 96x128: 2 training and 2 validation pairs of
    the multi-pixel affine input, with orb-style keypoint masks."""
    root = tmp_path_factory.mktemp("eval")
    data = root / "FlyingChairs_release" / "data"
    mdir = root / "mask" / "FlyingChairs_release" / "orb"
    data.mkdir(parents=True)
    mdir.mkdir(parents=True)
    rng = np.random.RandomState(7)
    for i in range(1, 5):
        (f1, f2), (flow,) = synthetic.affine_clip(rng, 96, 128, 2)
        Image.fromarray(f1.astype(np.uint8)).save(data / f"{i:05d}_img1.ppm")
        Image.fromarray(f2.astype(np.uint8)).save(data / f"{i:05d}_img2.ppm")
        tio.write_flo(str(data / f"{i:05d}_flow.flo"), flow)
        for j in (1, 2):
            m = synthetic.keypoint_mask(rng, 96, 128)[..., 0].astype(np.uint8)
            cv2.imwrite(str(mdir / f"{i:05d}_img{j}.png"), m)
    np.savetxt(root / "FlyingChairs_release" / "FlyingChairs_train_val.txt",
               np.array([1, 2, 1, 2], np.int32), fmt="%d")
    return root


def test_cli_evaluate_equals_jax_validate_chairs(chairs_tree, capsys, monkeypatch):
    for knob in ("FF_CHUNKED_FNET", "FF_PACKED_CCE", "FF_PACKED_CCE_BN", "FF_PACKED_STEM"):
        monkeypatch.setenv(knob, "0")
    chairs = str(chairs_tree / "FlyingChairs_release")
    got = cli.main(["--yaml", os.path.join(ROOT, "configs", "smoke_chairs.yaml"),
                    "--checkpoint", FIXTURE, "--datasets", "chairs",
                    "--data-root", f"chairs={chairs}", "--iters", "4", "--device", "cpu"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == 1 and json.loads(printed[0]) == got
    assert set(got) == {"chairs", "chairs-orb"}

    with np.load(FIXTURE) as raw:
        variables = traverse_util.unflatten_dict(
            {tuple(k.split("/")): jnp.asarray(raw[k], jnp.float32) for k in raw.files})
    model = JFFRaft(JConfig(fusion="parallel", fusion_type="1x1conv", fuse_cnet=True,
                            corr_impl="xla"))
    ds = JFlyingChairs(chairs, str(chairs_tree / "mask" / "FlyingChairs_release"),
                       split="validation", mask_type="orb")
    want = jev.validate_chairs(model, variables, ds, "orb", iters=4)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])
    assert got["chairs"] > 1.0  # multi-pixel motion


@pytest.mark.parametrize("key,value", [("ALT_CORR", True), ("SMALL", True),
                                       ("FUSION", "attention"), ("FUSION", "conv")])
def test_cli_evaluate_runs_the_variants(chairs_tree, tmp_path, capsys, key, value):
    """`cli.evaluate` on a YAML that sets a variant (`smoke_chairs.yaml` with
    MODEL.<key>; the front ends at FUSION_CHANNEL 16): finite chairs
    metrics. ALT_CORR runs the fixture and equals the materialized run
    within 1e-4 px; the others run weights drawn for their model (the
    fixture's tensors where the names and shapes carry over)."""
    import yaml

    from focusflow_official_tpu_torch.compat.weights import load_npz, params_to_jax
    from focusflow_official_tpu_torch.config import config_from_yaml, load_yaml_config
    from focusflow_official_tpu_torch.models import FFRaft

    with open(os.path.join(ROOT, "configs", "smoke_chairs.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["MODEL"].update({key: value}, **({"FUSION_CHANNEL": 16} if key == "FUSION" else {}))
    path = tmp_path / "variant.yaml"
    path.write_text(yaml.safe_dump(raw))
    weights = FIXTURE
    if key != "ALT_CORR":
        model = FFRaft(config_from_yaml(load_yaml_config(str(path))))
        src, g = load_npz(FIXTURE), torch.Generator().manual_seed(8)
        sd = {k: src[k] if k in src and src[k].shape == t.shape else
              t if k.endswith(("running_mean", "running_var", "temperature"))
              or (t.dim() == 1 and k.endswith("weight"))
              else torch.randn(t.shape, generator=g) * (t[0].numel() ** -0.5 if t.dim() > 1
                                                         else 0.01)
              for k, t in model.state_dict().items()}
        weights = str(tmp_path / "variant.npz")
        np.savez(weights, **params_to_jax(sd))
    chairs = str(chairs_tree / "FlyingChairs_release")
    argv = ["--checkpoint", weights, "--datasets", "chairs", "--data-root",
            f"chairs={chairs}", "--iters", "2", "--device", "cpu"]
    got = cli.main(["--yaml", str(path)] + argv)
    assert set(got) == {"chairs", "chairs-orb"} and np.isfinite(list(got.values())).all()
    if key == "ALT_CORR":
        want = cli.main(["--yaml", os.path.join(ROOT, "configs", "smoke_chairs.yaml")] + argv)
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])
    capsys.readouterr()
