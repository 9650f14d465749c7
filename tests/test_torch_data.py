"""The port's host data path against the JAX package's, on the same files
and seeds (every comparison exact: the same numpy, cv2 and PIL calls in
the same order): the codecs (`data/io.py`) read and written by both, the
keypoint masks, the flow colour wheel, both augmentors, and each dataset
class over tiny FlyingChairs, Sintel-custom and KITTI-custom trees written
here."""

import os

import numpy as np
import pytest

import cv2
from PIL import Image

from focusflow_official_tpu.data import augment as jaug
from focusflow_official_tpu.data import datasets as jds
from focusflow_official_tpu.data import flow_viz as jviz
from focusflow_official_tpu.data import io as jio
from focusflow_official_tpu.data import masks as jmasks
from focusflow_official_tpu_torch.data import augment as taug
from focusflow_official_tpu_torch.data import datasets as tds
from focusflow_official_tpu_torch.data import flow_viz as tviz
from focusflow_official_tpu_torch.data import io as tio
from focusflow_official_tpu_torch.data import masks as tmasks
from focusflow_official_tpu_torch.data import synthetic


def _assert_same(a, b):
    """Equal dicts, tuples or arrays: same keys, dtypes, shapes and values."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _textured(seed, h, w):
    return synthetic.textured(np.random.RandomState(seed), h, w).astype(np.uint8)


# ---- codecs -----------------------------------------------------------------

@pytest.mark.parametrize("writer", [tio, jio], ids=["port_writes", "jax_writes"])
def test_flo_round_trip(tmp_path, writer):
    flow = np.random.RandomState(0).randn(13, 17, 2).astype(np.float32) * 20
    path = str(tmp_path / "f.flo")
    writer.write_flo(path, flow)
    _assert_same(tio.read_flo(path), flow)
    _assert_same(tio.read_flo(path), jio.read_flo(path))
    _assert_same(tio.read_gen(path), jio.read_gen(path))


@pytest.mark.parametrize("color", [True, False])
def test_pfm_read(tmp_path, color):
    """PFM as FlyingThings3D writes it: bottom row first, little-endian
    (negative scale); read_gen drops the third flow channel."""
    rng = np.random.RandomState(1)
    data = rng.randn(*((9, 11, 3) if color else (9, 11))).astype("<f4")
    path = str(tmp_path / "f.pfm")
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(b"11 9\n-1.0\n")
        f.write(np.flipud(data).tobytes())
    _assert_same(tio.read_pfm(path), np.asarray(data, np.float32))
    _assert_same(tio.read_pfm(path), jio.read_pfm(path))
    _assert_same(tio.read_gen(path), jio.read_gen(path))


@pytest.mark.parametrize("writer", [tio, jio], ids=["port_writes", "jax_writes"])
def test_kitti_png_round_trip(tmp_path, writer):
    flow = np.round(np.random.RandomState(2).randn(10, 14, 2) * 30 * 64) / 64
    path = str(tmp_path / "k.png")
    writer.write_flow_kitti(path, flow.astype(np.float32))
    got = tio.read_flow_kitti(path)
    _assert_same(got, jio.read_flow_kitti(path))
    np.testing.assert_array_equal(got[0], flow.astype(np.float32))
    assert (got[1] == 1).all()


@pytest.mark.parametrize("ext", [".png", ".ppm", ".jpg"])
def test_read_image_and_gen(tmp_path, ext):
    path = str(tmp_path / f"im{ext}")
    Image.fromarray(_textured(3, 20, 24)).save(path)
    _assert_same(tio.read_gen(path), jio.read_gen(path))
    _assert_same(tio.read_image(path), jio.read_image(path))


def test_read_gen_refuses_unknown_extension():
    with pytest.raises(ValueError, match="unsupported"):
        tio.read_gen("x.tiff")


# ---- masks and the colour wheel ---------------------------------------------------

@pytest.mark.parametrize("kind", ["gf", "sift", "orb"])
def test_keypoint_masks_equal(kind):
    img = _textured(4, 96, 128)
    got = tmasks.MASK_CREATORS[kind](img)
    _assert_same(got, jmasks.MASK_CREATORS[kind](img))
    assert got.shape == (96, 128) and got.max() == 255


@pytest.mark.parametrize("threshold", [None, 0.9])
def test_silk_from_scores_equal(threshold):
    scores = np.random.RandomState(5).rand(30, 40)
    _assert_same(tmasks.silk_from_scores(scores, top_k=50, threshold=threshold),
                 jmasks.silk_from_scores(scores, top_k=50, threshold=threshold))


@pytest.mark.parametrize("bgr", [False, True])
def test_flow_to_image_equal(bgr):
    flow = np.random.RandomState(6).randn(21, 33, 2).astype(np.float32) * 5
    _assert_same(tviz.make_colorwheel(), jviz.make_colorwheel())
    _assert_same(tviz.flow_to_image(flow, convert_to_bgr=bgr),
                 jviz.flow_to_image(flow, convert_to_bgr=bgr))


# ---- augmentors -------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flow_augmentor_equal(seed):
    rng = np.random.RandomState(10 + seed)
    img1, img2 = _textured(seed, 80, 112), _textured(seed + 50, 80, 112)
    flow = rng.randn(80, 112, 2).astype(np.float32) * 3
    m1, m2 = ((rng.rand(2, 80, 112, 1) > 0.97) * 255).astype(np.uint8)
    kw = dict(crop_size=(48, 64), min_scale=-0.1, max_scale=1.0, do_flip=True, seed=seed)
    ours, theirs = taug.FlowAugmentor(**kw), jaug.FlowAugmentor(**kw)
    for _ in range(3):  # the generator carries on across calls
        _assert_same(ours(img1, img2, flow, m1, m2), theirs(img1, img2, flow, m1, m2))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sparse_flow_augmentor_equal(seed):
    rng = np.random.RandomState(20 + seed)
    img1, img2 = _textured(seed, 80, 112), _textured(seed + 50, 80, 112)
    flow = rng.randn(80, 112, 2).astype(np.float32) * 3
    valid = (rng.rand(80, 112) < 0.3).astype(np.float32)
    m1, m2 = ((rng.rand(2, 80, 112, 1) > 0.97) * 255).astype(np.uint8)
    kw = dict(crop_size=(48, 64), min_scale=-0.3, max_scale=0.5, do_flip=True, seed=seed)
    ours, theirs = taug.SparseFlowAugmentor(**kw), jaug.SparseFlowAugmentor(**kw)
    for _ in range(3):
        _assert_same(ours(img1, img2, flow, valid, m1, m2),
                     theirs(img1, img2, flow, valid, m1, m2))


# ---- datasets over on-disk trees ---------------------------------------------------

def _mask(rng, h, w):
    return ((rng.rand(h, w) > 0.97) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Tiny FlyingChairs (6 pairs: 4 training, 2 validation), Sintel-custom
    (one scene of 3 frames, clean and final, training and testing) and
    KITTI-custom (2 sparse pairs, training and testing) trees with their
    orb mask trees."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.RandomState(0)
    data = root / "FlyingChairs_release" / "data"
    cmask = root / "mask" / "FlyingChairs_release" / "orb"
    data.mkdir(parents=True)
    cmask.mkdir(parents=True)
    h, w = 72, 96
    for i in range(1, 7):
        (f1, f2), (flow,) = synthetic.affine_clip(rng, h, w, 2)
        Image.fromarray(f1.astype(np.uint8)).save(data / f"{i:05d}_img1.ppm")
        Image.fromarray(f2.astype(np.uint8)).save(data / f"{i:05d}_img2.ppm")
        tio.write_flo(str(data / f"{i:05d}_flow.flo"), flow)
        for j in (1, 2):
            cv2.imwrite(str(cmask / f"{i:05d}_img{j}.png"), _mask(rng, h, w))
    np.savetxt(root / "FlyingChairs_release" / "FlyingChairs_train_val.txt",
               np.array([1, 1, 2, 1, 2, 1], np.int32), fmt="%d")

    sh, sw = 40, 56
    frames, flows = synthetic.affine_clip(rng, sh, sw, 3)
    for split in ("training", "testing"):
        for dstype in ("clean", "final"):
            idir = root / "Sintel-custom" / split / dstype / "alley_9"
            mdir = root / "mask" / "Sintel-custom" / "orb" / split / dstype / "alley_9"
            idir.mkdir(parents=True)
            mdir.mkdir(parents=True)
            for i, fr in enumerate(frames, start=1):
                out = fr if dstype == "clean" else synthetic.degrade(rng, fr)
                Image.fromarray(out.astype(np.uint8)).save(idir / f"frame_{i:04d}.png")
                cv2.imwrite(str(mdir / f"frame_{i:04d}.png"), _mask(rng, sh, sw))
        fdir = root / "Sintel-custom" / split / "flow" / "alley_9"
        fdir.mkdir(parents=True)
        for i, fl in enumerate(flows, start=1):
            tio.write_flo(str(fdir / f"frame_{i:04d}.flo"), fl)

    kh, kw = 40, 64
    for split in ("training", "testing"):
        kimg = root / "KITTI-custom" / split / "image_2"
        kflo = root / "KITTI-custom" / split / "flow_occ"
        kmask = root / "mask" / "KITTI-custom" / "orb" / split
        for d in (kimg, kflo, kmask):
            d.mkdir(parents=True)
        for i in range(2):
            (a, b), (fl,) = synthetic.affine_clip(rng, kh, kw, 2)
            cv2.imwrite(str(kimg / f"{i:06d}_10.png"), a.astype(np.uint8))
            cv2.imwrite(str(kimg / f"{i:06d}_11.png"), b.astype(np.uint8))
            valid = rng.rand(kh, kw) < 0.25
            uv = 64.0 * np.where(valid[..., None], fl, 0.0) + 2 ** 15
            out = np.concatenate([uv, valid[..., None]], -1).astype(np.uint16)
            cv2.imwrite(str(kflo / f"{i:06d}_10.png"), out[..., ::-1])
            for suf in ("10", "11"):
                cv2.imwrite(str(kmask / f"{i:06d}_{suf}.png"), _mask(rng, kh, kw))
    return root


def _pair(tree, name, **kw):
    """The same dataset class from both packages."""
    root = str(tree)
    args = {
        "chairs": (os.path.join(root, "FlyingChairs_release"),
                   os.path.join(root, "mask", "FlyingChairs_release")),
        "sintel": (os.path.join(root, "Sintel-custom"),
                   os.path.join(root, "mask", "Sintel-custom")),
        "kitti": (os.path.join(root, "KITTI-custom"),
                  os.path.join(root, "mask", "KITTI-custom")),
    }[name]
    cls = {"chairs": "FlyingChairs", "sintel": "MpiSintel", "kitti": "KITTI"}[name]
    return getattr(tds, cls)(*args, **kw), getattr(jds, cls)(*args, **kw)


CASES = [
    ("chairs", dict(split="training"), 4),
    ("chairs", dict(split="validation"), 2),
    ("chairs", dict(split="training", seed=3, aug_params=dict(
        crop_size=(48, 64), min_scale=-0.1, max_scale=1.0, do_flip=True)), 4),
    ("sintel", dict(split="training", dstype="clean"), 2),
    ("sintel", dict(split="training", dstype="final"), 2),
    ("sintel", dict(split="testing", dstype="clean"), 2),
    ("kitti", dict(split="training"), 2),
    ("kitti", dict(split="testing"), 2),
    ("kitti", dict(split="training", seed=4, aug_params=dict(
        crop_size=(32, 48), min_scale=-0.3, max_scale=0.5, do_flip=True)), 2),
]


@pytest.mark.parametrize("name,kw,n", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_dataset_samples_equal(tree, name, kw, n):
    ours, theirs = _pair(tree, name, **kw)
    assert len(ours) == len(theirs) == n
    for i in range(n):
        a, b = ours[i], theirs[i]
        _assert_same(a, b)
        assert a["image1"].dtype == np.float32 and a["mask1"].shape[-1] == 1
        if "flow" in a:
            assert a["valid"].shape == a["flow"].shape[:2]
        else:
            assert "extra_info" in a


def test_weighted_concat_and_recipe_tag_equal(tree):
    (c1, j1), (c2, j2) = _pair(tree, "chairs", split="validation"), _pair(
        tree, "kitti", split="training")
    ours = tds.WeightedConcat([(tds.RecipeTagged(c1, 0), 3), (tds.RecipeTagged(c2, 1), 2)])
    theirs = jds.WeightedConcat([(jds.RecipeTagged(j1, 0), 3), (jds.RecipeTagged(j2, 1), 2)])
    assert len(ours) == len(theirs) == 10
    for i in (0, 5, 6, 9, 13):
        _assert_same(ours[i], theirs[i])


# ---- the synthetic multi-pixel input ------------------------------------------------

def test_synthetic_clip_flow_is_exact():
    """Frame k at p is frame k+1 at p + flow(p): bilinear resampling of the
    next frame along the flow gives the frame back to within the rounding of
    both frames to integers and the interpolation of a smooth texture (mean
    |residual| < 2 grey levels, against > 20 for the frames unaligned), and
    the motion is multi-pixel (mean |flow| > 4 px)."""
    from scipy.ndimage import map_coordinates

    h, w = 96, 128
    frames, flows = synthetic.affine_clip(np.random.RandomState(0), h, w, 3)
    ys, xs = np.mgrid[0:h, 0:w]
    for k, flow in enumerate(flows):
        assert float(np.abs(flow).mean()) > 4.0
        tx, ty = xs + flow[..., 0], ys + flow[..., 1]
        inside = (tx >= 0) & (tx <= w - 1) & (ty >= 0) & (ty <= h - 1)
        back = np.stack([map_coordinates(frames[k + 1][..., c], [ty, tx], order=1)
                         for c in range(3)], -1)
        assert float(np.abs(back - frames[k])[inside].mean()) < 2.0
        assert float(np.abs(frames[k + 1] - frames[k]).mean()) > 20.0


def test_synthetic_layouts():
    kitti = synthetic.kitti_layout(0, shapes=((45, 70), (40, 64)))
    assert [kitti[i]["image1"].shape for i in range(2)] == [(45, 70, 3), (40, 64, 3)]
    s = kitti[0]
    share = float(s["valid"].mean())
    assert 0.15 < share < 0.25 and (s["flow"][s["valid"] == 0] == 0).all()
    assert set(np.unique(s["mask1"])) == {0.0, 255.0}
    sets, seq = synthetic.sintel_layout(1, n_frames=4, h=40, w=56)
    assert len(sets["clean"]) == len(sets["final"]) == 3 and len(seq["flows"]) == 3
    np.testing.assert_array_equal(sets["final"][1]["flow"], seq["flows"][1])
    assert not np.array_equal(sets["final"][0]["image1"], sets["clean"][0]["image1"])
    chairs = synthetic.chairs_layout(2, n=2, h=48, w=64)
    assert len(chairs) == 2 and (chairs[1]["valid"] == 1).all()
