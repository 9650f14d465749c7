"""The port's on-card augmentation (`data/device_aug.py`) against the JAX
package's `data/device_aug.py`, on the CPU, on numpy inputs from a seed.

- Op by op: the four photometric ops (gray pixels, ties between channels
  and all six hue sectors among the inputs), `_axis_weights` (up, down,
  flipped, padded columns), `warp_resize_crop`, `_scatter_axis_matrix`
  with `strict` on and off, `sparse_scatter_crop` with colliding points,
  and the eraser on the rectangles JAX's key draws.
- The whole augmentor: `_jax_draws` replays `DeviceFlowAugmentor._one`'s
  key schedule with `jax.random` (`split(rng, 13)`, the jitter's and the
  eraser's own splits) into the port's draws; the port's `apply` on them
  must give JAX's `DeviceFlowAugmentor(rng, batch)` on a dense chairs-like
  batch and on a mixed dense + sparse batch of two sizes with `sizes` and
  `recipe`.
- The port's own draws: over 4096 samples every probability of the
  recipes (flips, stretch, spatial, asym, eraser, one or two rectangles,
  each op at each place of the order) lies within 4 sigma, every range
  holds, and a rank's draws are its rows of the global batch's.
- `fetch_dataset(no_aug=True)`: the same recipe tables, part weights and
  recipe rows as JAX's for every stage, on stand-in dataset classes.

Tolerances. The ops and the warp run the same f32 arithmetic as JAX, only
sums in another order (the contrast and eraser means, the products' zero
terms), so: images and masks within 1e-3 on the 0-255 scale (measured up
to 3e-4, from XLA's fused arithmetic); flow within 1e-4 of max(1, its
largest magnitude) (measured 1e-7 relative); `valid`, the 0/1 scatter
matrices and the tent weights exact (the weights within 1e-6). No hue
sector flips on these inputs: a flip would show as an error above the
image bound, and none does.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from focusflow_official_tpu.data import datasets as jds
from focusflow_official_tpu.data import device_aug as J
from focusflow_official_tpu_torch.data import datasets as tds
from focusflow_official_tpu_torch.data import device_aug as T

IMG_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _images(seed=0, n=2, h=12, w=18):
    """Random 0..255 pixels, with gray ones, channel ties, and every hue
    sector among them."""
    rng = np.random.RandomState(seed)
    img = rng.uniform(0, 255, (n, h, w, 3)).astype(np.float32)
    img[:, 0, :4] = rng.uniform(0, 255, (n, 4, 1))  # gray: chroma 0
    a, b = np.float32(200.0), np.float32(60.0)
    img[:, 1, :6] = [[a, a, b], [a, b, a], [b, a, a], [a, b, b], [b, a, b], [b, b, a]]
    x = img / 255.0
    mx, mn = x.max(-1), x.min(-1)
    c = mx - mn
    r, g, bl = x[..., 0], x[..., 1], x[..., 2]
    sc = np.where(c > 0, c, 1)
    hue = np.where(mx == r, (g - bl) / sc, np.where(mx == g, 2 + (bl - r) / sc, 4 + (r - g) / sc))
    sectors = np.floor((np.where(c > 0, hue / 6, 0) % 1.0) * 6)[c > 0]
    assert set(sectors.astype(int)) == set(range(6)) and (c == 0).any()
    return img


@pytest.mark.parametrize("op,factor", [
    ("brightness", 0.63), ("brightness", 1.4), ("contrast", 0.7), ("contrast", 1.37),
    ("saturation", 0.0), ("saturation", 1.4), ("hue", -0.159), ("hue", 0.05),
    ("hue", 0.159), ("hue", 0.5)])
def test_photometric_op_matches_jax(op, factor):
    img = _images()
    mean_ = np.float32((0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]).mean())
    want = getattr(J, f"adjust_{op}")(jnp.asarray(img), factor, mean_)
    got = getattr(T, f"adjust_{op}")(torch.from_numpy(img), factor, torch.tensor(mean_))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=IMG_TOL)


# (static length, true length, offset, flip, resized length, out length)
AXIS_CASES = {"up": (20, 20, 3, False, 31, 16), "down": (20, 20, 0, False, 13, 12),
              "flipped": (20, 20, 5, True, 27, 16), "padded": (24, 17, 2, False, 22, 16),
              "padded_flipped": (24, 17, 1, True, 15, 12)}


@pytest.mark.parametrize("case", sorted(AXIS_CASES))
def test_axis_weights_match_jax(case):
    static, true, off, flip, resized, out = AXIS_CASES[case]
    want = J._axis_weights(out, static, jnp.int32(true), jnp.int32(off), jnp.asarray(flip),
                           jnp.int32(resized))
    t = lambda v, dt=torch.long: torch.tensor([v], dtype=dt)
    got = T._axis_weights(out, static, t(true), t(off), t(flip, torch.bool), t(resized))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert float(got[:, true:].abs().sum()) == 0.0  # padding weighs nothing


def _spatial_args(seed, n, h, w, crop):
    """Per-sample true sizes (the last sample padded), resized sizes,
    flips and crop offsets."""
    rng = np.random.RandomState(seed)
    sizes = np.tile([[h, w]], (n, 1)).astype(np.int32)
    sizes[-1] = [h - 3, w - 5]
    resized = np.stack([rng.randint(crop[0] + 1, 2 * h, n),
                        rng.randint(crop[1] + 1, 2 * w, n)], -1).astype(np.int32)
    resized[0] = [crop[0] + 2, crop[1] + 1]  # one downscale
    flips = rng.rand(n, 2) < 0.5
    flips[0] = [True, True]
    offs = np.stack([rng.randint(0, resized[:, 0] - crop[0]),
                     rng.randint(0, resized[:, 1] - crop[1])], -1).astype(np.int32)
    return sizes, resized, flips, offs


def test_warp_resize_crop_matches_jax():
    n, h, w, crop = 3, 20, 30, (12, 16)
    img = np.random.RandomState(1).uniform(0, 255, (n, h, w, 3)).astype(np.float32)
    sizes, resized, flips, offs = _spatial_args(1, n, h, w, crop)
    got = T.warp_resize_crop(torch.from_numpy(img), *(torch.from_numpy(offs[:, k]).long()
                                                      for k in (0, 1)),
                             torch.from_numpy(flips[:, 1]), torch.from_numpy(flips[:, 0]),
                             torch.from_numpy(sizes).long(), torch.from_numpy(resized).long(),
                             crop)
    for i in range(n):
        want = J.warp_resize_crop(jnp.asarray(img[i]), 1.0, 1.0, offs[i, 0], offs[i, 1],
                                  flips[i, 1], flips[i, 0], jnp.asarray(sizes[i]),
                                  tuple(jnp.int32(v) for v in resized[i]), crop)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), rtol=0, atol=IMG_TOL)


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("flip", [False, True])
def test_scatter_axis_matrix_matches_jax(strict, flip):
    for scale, resized in ((0.61, 15), (1.37, 33), (1.0, 24)):
        want = J._scatter_axis_matrix(12, 26, jnp.int32(24), jnp.int32(2), jnp.asarray(flip),
                                      jnp.int32(resized), jnp.float32(scale), jnp.asarray(strict))
        t = lambda v, dt=torch.long: torch.tensor([v], dtype=dt)
        got = T._scatter_axis_matrix(12, 26, t(24), t(2), t(flip, torch.bool), t(resized),
                                     t(scale, torch.float32), t(strict, torch.bool))[0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sparse_scatter_crop_averages_colliding_points_as_jax():
    n, h, w, crop = 3, 30, 40, (12, 16)
    rng = np.random.RandomState(2)
    valid = (rng.rand(n, h, w) < 0.6).astype(np.float32)
    flow = (rng.normal(0, 8, (n, h, w, 2)) * valid[..., None]).astype(np.float32)
    sizes, _, flips, _ = _spatial_args(2, n, h, w, crop)
    scale = np.array([[0.55, 0.45], [1.3, 1.2], [0.8, 1.0]], np.float32)  # (sy, sx)
    resized = np.round(sizes * scale).astype(np.int32)
    offs = np.stack([rng.randint(0, np.maximum(resized[:, 0] - crop[0], 1)),
                     rng.randint(0, np.maximum(resized[:, 1] - crop[1], 1))], -1)
    strict = np.array([True, True, False])
    tt = lambda a, dt=None: torch.from_numpy(np.ascontiguousarray(a)).to(dt or torch.long)
    args = (tt(scale[:, 0], torch.float32), tt(scale[:, 1], torch.float32), tt(offs[:, 0]),
            tt(offs[:, 1]), tt(flips[:, 0], torch.bool), tt(sizes), tt(resized), crop,
            tt(strict, torch.bool))
    got_flow, got_valid = T.sparse_scatter_crop(torch.from_numpy(flow), torch.from_numpy(valid),
                                                *args)
    # the first sample's downscale sends several points to one pixel
    my = T._scatter_axis_matrix(crop[0], h, args[5][:, 0], args[2], torch.zeros(n, dtype=bool),
                                args[6][:, 0], args[0], args[8])
    mx = T._scatter_axis_matrix(crop[1], w, args[5][:, 1], args[3], args[4], args[6][:, 1],
                                args[1], args[8])
    assert float(T._separable(my, torch.from_numpy(valid)[..., None], mx)[0].max()) > 1
    for i in range(n):
        wf, wv = J.sparse_scatter_crop(
            jnp.asarray(flow[i]), jnp.asarray(valid[i]), jnp.float32(scale[i, 0]),
            jnp.float32(scale[i, 1]), offs[i, 0], offs[i, 1], jnp.asarray(flips[i, 0]),
            jnp.asarray(sizes[i]), tuple(jnp.int32(v) for v in resized[i]), crop,
            jnp.asarray(strict[i]))
        np.testing.assert_array_equal(got_valid[i].numpy(), np.asarray(wv))
        np.testing.assert_allclose(got_flow[i].numpy(), np.asarray(wf), rtol=0,
                                   atol=1e-4 * max(1.0, float(np.abs(wf).max())))


# ---- replaying JAX's key schedule into the port's draws


def _jax_eraser_draws(key, size_hw):
    """`_eraser`'s own split: gate, count, two rectangles (x0, y0, dx, dy)."""
    k_gate, k_n, k_rect = jax.random.split(key, 3)
    rects = []
    for kr in jax.random.split(k_rect, 2):
        k0, k1, k2, k3 = jax.random.split(kr, 4)
        rects.append(jnp.stack([
            jax.random.randint(k0, (), 0, jnp.maximum(size_hw[1], 1)),
            jax.random.randint(k1, (), 0, jnp.maximum(size_hw[0], 1)),
            jax.random.randint(k2, (), 50, 100), jax.random.randint(k3, (), 50, 100)]))
    return (jax.random.uniform(k_gate, ()) < 0.5, jax.random.randint(k_n, (), 1, 3),
            jnp.stack(rects))


def _jax_draws(aug, rng, sizes, recipe):
    """The port's draws for `aug(rng, batch)`: `_one`'s key schedule under
    `vmap` over `split(rng, B)`."""
    ch, cw = aug.crop_size

    def jitter(key, rp):
        kb, kc, ks, kh, kperm = jax.random.split(key, 5)
        lo = lambda s: jnp.maximum(0.0, 1 - s)
        u = jax.random.uniform
        f = jnp.stack([u(kb, (), minval=lo(rp["brightness"]), maxval=1 + rp["brightness"]),
                       u(kc, (), minval=lo(rp["contrast"]), maxval=1 + rp["contrast"]),
                       u(ks, (), minval=lo(rp["saturation"]), maxval=1 + rp["saturation"]),
                       u(kh, (), minval=-rp["hue"], maxval=rp["hue"])])
        return f, jax.random.permutation(kperm, 4)

    def one(key, size_hw, rid):
        rp = {k: v[rid] for k, v in aug.table.items()}
        ks = jax.random.split(key, 13)
        jits = [jitter(ks[i], rp) for i in (1, 2, 3)]
        gate, n_rect, rects = _jax_eraser_draws(ks[4], size_hw)
        hf, wf = size_hw[0].astype(jnp.float32), size_hw[1].astype(jnp.float32)
        min_scale = jnp.maximum((ch + rp["crop_margin"]) / hf, (cw + rp["crop_margin"]) / wf)
        scale = 2.0 ** jax.random.uniform(ks[5], (), minval=rp["min_scale"],
                                          maxval=rp["max_scale"])
        do_stretch = jax.random.uniform(ks[6], ()) < rp["stretch_prob"]
        st = 2.0 ** jax.random.uniform(ks[7], (2,), minval=-0.2, maxval=0.2)
        do_spatial = jax.random.uniform(ks[8], ()) < rp["spatial_aug_prob"]
        sx = jnp.where(do_spatial, jnp.maximum(scale * jnp.where(do_stretch, st[0], 1.0),
                                               min_scale), 1.0)
        sy = jnp.where(do_spatial, jnp.maximum(scale * jnp.where(do_stretch, st[1], 1.0),
                                               min_scale), 1.0)
        hs = jnp.round(hf * sy).astype(jnp.int32)
        ws = jnp.round(wf * sx).astype(jnp.int32)
        fh = jax.random.uniform(ks[9], ()) < rp["h_flip_prob"]
        fv = jax.random.uniform(ks[10], ()) < rp["v_flip_prob"]
        y0 = jax.random.randint(ks[11], (), 0, jnp.maximum(hs - ch, 1))
        x0 = jax.random.randint(ks[12], (), 0, jnp.maximum(ws - cw, 1))
        return dict(jitter=jnp.stack([j[0] for j in jits]), order=jnp.stack([j[1] for j in jits]),
                    asym=jax.random.uniform(ks[0], ()) < rp["asym_prob"], erase=gate,
                    n_rect=n_rect, rects=rects, scale=scale, stretch=st, do_stretch=do_stretch,
                    do_spatial=do_spatial, flip=jnp.stack([fh, fv]), offset=jnp.stack([y0, x0]))

    d = jax.vmap(one)(jax.random.split(rng, len(sizes)), jnp.asarray(sizes),
                      jnp.asarray(recipe))
    out = {}
    for k, v in d.items():
        a = np.array(v)
        out[k] = torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu" else a)
    return out


def test_eraser_matches_jax_on_its_rectangles():
    n, h, w = 4, 120, 150
    img = np.random.RandomState(3).uniform(0, 255, (n, h, w, 3)).astype(np.float32)
    sizes = np.array([[h, w], [h, w], [100, 130], [h, w]], np.int32)
    extent = ((np.arange(h)[None, :, None] < sizes[:, 0, None, None])
              & (np.arange(w)[None, None, :] < sizes[:, 1, None, None]))[..., None]
    extent = extent.astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(7), n)
    draws = [_jax_eraser_draws(keys[i], jnp.asarray(sizes[i])) for i in range(n)]
    gate = torch.tensor([bool(d[0]) for d in draws])
    assert gate.any()
    got = T._eraser(torch.from_numpy(img), torch.from_numpy(extent), gate,
                    torch.tensor([int(d[1]) for d in draws]),
                    torch.stack([torch.from_numpy(np.asarray(d[2]).astype(np.int64))
                                 for d in draws]))
    for i in range(n):
        want = J._eraser(keys[i], jnp.asarray(img[i]), jnp.asarray(extent[i]),
                         jnp.asarray(sizes[i]), 0.5)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), rtol=0, atol=IMG_TOL)


def _dense_batch(seed=4, n=3, h=72, w=100):
    rng = np.random.RandomState(seed)
    return dict(image1=rng.uniform(0, 255, (n, h, w, 3)).astype(np.float32),
                image2=rng.uniform(0, 255, (n, h, w, 3)).astype(np.float32),
                flow=rng.normal(0, 6, (n, h, w, 2)).astype(np.float32),
                mask1=((rng.rand(n, h, w, 1) < 0.05) * 255).astype(np.float32),
                mask2=((rng.rand(n, h, w, 1) < 0.05) * 255).astype(np.float32))


def _mixed_batch(seed=5):
    """Dense samples at 70x120 beside sparse ones at 60x128, zero-padded to
    70x128, with `sizes`, `recipe` and a sparse `valid`."""
    rng = np.random.RandomState(seed)
    shapes, recipe = [(70, 120), (60, 128), (70, 120), (60, 128)], [0, 1, 0, 1]
    n, hm, wm = len(shapes), 70, 128
    b = {k: np.zeros((n, hm, wm, c), np.float32)
         for k, c in (("image1", 3), ("image2", 3), ("flow", 2), ("mask1", 1), ("mask2", 1))}
    b["valid"] = np.zeros((n, hm, wm), np.float32)
    for i, (h, w) in enumerate(shapes):
        v = (rng.rand(h, w) < 0.3) if recipe[i] else np.ones((h, w), bool)
        b["image1"][i, :h, :w] = rng.uniform(0, 255, (h, w, 3))
        b["image2"][i, :h, :w] = rng.uniform(0, 255, (h, w, 3))
        b["mask1"][i, :h, :w] = (rng.rand(h, w, 1) < 0.05) * 255
        b["mask2"][i, :h, :w] = (rng.rand(h, w, 1) < 0.05) * 255
        b["valid"][i, :h, :w] = v
        b["flow"][i, :h, :w] = rng.normal(0, 6, (h, w, 2)) * v[..., None]
    b["sizes"] = np.asarray(shapes, np.int32)
    b["recipe"] = np.asarray(recipe, np.int32)
    return b


@pytest.mark.parametrize("kind,seed", [("dense", 0), ("dense", 1), ("mixed", 0), ("mixed", 3)])
def test_apply_matches_jax_augmentor(kind, seed):
    if kind == "dense":
        batch, crop, kw = _dense_batch(), (48, 64), dict(min_scale=-0.1, max_scale=1.0)
    else:
        batch, crop = _mixed_batch(), (48, 96)
        kw = dict(recipes=[J.dense_recipe(-0.2, 0.6), J.sparse_recipe(-0.3, 0.5)])
    rng = jax.random.PRNGKey(seed)
    jaug = J.DeviceFlowAugmentor(crop, **kw)
    want = jaug(rng, {k: jnp.asarray(v) for k, v in batch.items()})
    n, h, w = batch["image1"].shape[:3]
    sizes = batch.get("sizes", np.tile([[h, w]], (n, 1)).astype(np.int32))
    draws = _jax_draws(jaug, rng, sizes, batch.get("recipe", np.zeros(n, np.int32)))
    got = T.DeviceFlowAugmentor(crop, **kw).apply(
        {k: torch.from_numpy(v) for k, v in batch.items()}, draws)
    assert sorted(got) == sorted(want) == ["flow", "image1", "image2", "mask1", "mask2", "valid"]
    for k in ("image1", "image2", "mask1", "mask2"):
        assert got[k].shape == (n, *crop, got[k].shape[-1])
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=IMG_TOL,
                                   err_msg=k)
    wf = np.asarray(want["flow"])
    np.testing.assert_allclose(got["flow"].numpy(), wf, rtol=0,
                               atol=1e-4 * max(1.0, float(np.abs(wf).max())))
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    if kind == "mixed":  # the sparse samples' counts of valid points
        counts = got["valid"].sum(dim=(1, 2))
        assert torch.equal(counts, torch.from_numpy(np.asarray(want["valid"]).sum((1, 2))))
        assert float(counts[1]) < crop[0] * crop[1]


# ---- the port's own draws


def _port_draws(n=4096, seed=0):
    """Half dense samples at 384x512, half sparse at 375x1242, for a
    368x496 crop."""
    recipes = [T.dense_recipe(-0.1, 1.0), T.sparse_recipe(-0.3, 0.5)]
    aug = T.DeviceFlowAugmentor((368, 496), recipes=recipes)
    recipe = torch.arange(n) % 2
    sizes = torch.tensor([[384, 512], [375, 1242]])[recipe]
    gen = torch.Generator().manual_seed(seed)
    return aug, recipes, recipe, sizes, aug.draw(gen, n, sizes, recipe)


def test_draws_respect_every_recipe():
    aug, recipes, recipe, sizes, d = _port_draws()
    _, _, resized = aug._resize(d, sizes, aug._recipe(recipe))
    for rid, rp in enumerate(recipes):
        sel = recipe == rid
        n = int(sel.sum())

        def share(x, p, what):
            got = float(x[sel].float().mean())
            sigma = (p * (1 - p) / n) ** 0.5
            assert abs(got - p) <= 4 * sigma, (rid, what, got, p)

        share(d["flip"][:, 0], rp["h_flip_prob"], "h_flip")
        share(d["flip"][:, 1], rp["v_flip_prob"], "v_flip")
        share(d["do_stretch"], rp["stretch_prob"], "stretch")
        share(d["do_spatial"], rp["spatial_aug_prob"], "spatial")
        share(d["asym"], rp["asym_prob"], "asym")
        share(d["erase"], 0.5, "eraser")
        share(d["n_rect"] == 1, 0.5, "one rectangle")
        for j in range(3):
            for pos in range(4):
                for op in range(4):
                    share(d["order"][:, j, pos] == op, 0.25, f"order {j} {pos} {op}")
        jit = d["jitter"][sel]
        for k, name in enumerate(("brightness", "contrast", "saturation")):
            lo, hi = max(0.0, 1 - rp[name]), 1 + rp[name]
            assert float(jit[..., k].min()) >= lo - 1e-6 and float(jit[..., k].max()) <= hi + 1e-6
        assert float(jit[..., 3].abs().max()) <= rp["hue"] + 1e-6
        sc = d["scale"][sel]
        assert float(sc.min()) >= 2 ** rp["min_scale"] * (1 - 1e-6)
        assert float(sc.max()) <= 2 ** rp["max_scale"] * (1 + 1e-6)
        span = torch.clamp(resized[sel] - torch.tensor([368, 496]), min=1)
        off = d["offset"][sel]
        assert bool((off >= 0).all() and (off < span).all())
        rects, sz = d["rects"][sel], sizes[sel]
        assert bool((rects[..., 0] >= 0).all() and (rects[..., 0] < sz[:, 1:2]).all())
        assert bool((rects[..., 1] >= 0).all() and (rects[..., 1] < sz[:, 0:1]).all())
        assert bool((rects[..., 2:] >= 50).all() and (rects[..., 2:] < 100).all())
    st = d["stretch"]
    assert float(st.min()) >= 2 ** -0.2 * (1 - 1e-6) and float(st.max()) <= 2 ** 0.2 * (1 + 1e-6)
    assert set(d["n_rect"].tolist()) == {1, 2}


def test_a_rank_draws_its_rows_of_the_global_batch():
    aug = T.DeviceFlowAugmentor((48, 64))
    sizes = torch.tensor([[72, 100]]).expand(6, 2)
    recipe = torch.zeros(6, dtype=torch.long)
    whole = aug.draw(torch.Generator().manual_seed(3), 6, sizes, recipe)
    for rank in range(3):
        part = aug.draw(torch.Generator().manual_seed(3), 2, sizes[:2], recipe[:2], world=3,
                        rank=rank)
        for k, v in part.items():
            assert torch.equal(v, whole[k][rank::3]), (rank, k)


# ---- fetch_dataset(no_aug=True)

STAGES = [("chairs", None), ("things", None), ("sintel", None), ("sintel", "C+T+S"),
          ("sintel", "C+T+S+K"), ("kitti", None)]


def _stand_in(name):
    class StandIn:
        def __init__(self, root, mask_root, aug_params=None, split="training", dstype=None,
                     mask_type="orb", seed=None):
            self.key, self.aug = (name, dstype), aug_params

        def __len__(self):
            return 3

        def __getitem__(self, index):
            return {"image1": np.full((2, 2, 3), index, np.float32)}

    return StandIn


def _describe(ds):
    """The parts of a stage's raw dataset: (weight, recipe row, which
    dataset, its host augmentation)."""
    parts = ds.parts if hasattr(ds, "parts") else [(ds, 1)]
    return [(w, p.recipe_id, p.dataset.key, p.dataset.aug) for p, w in parts]


@pytest.mark.parametrize("stage,train_ds", STAGES)
def test_fetch_dataset_no_aug_matches_jax(stage, train_ds, monkeypatch):
    for mod in (jds, tds):
        for cls in ("FlyingChairs", "FlyingThings3D", "MpiSintel", "KITTI"):
            monkeypatch.setattr(mod, cls, _stand_in(cls))
    roots = {k: k for k in ("chairs", "things", "sintel", "kitti")}
    kw = dict(stage=stage, image_size=(368, 496), train_ds=train_ds, no_aug=True)
    ours, theirs = tds.fetch_dataset(roots, roots, **kw), jds.fetch_dataset(roots, roots, **kw)
    assert ours.device_recipes == theirs.device_recipes
    assert _describe(ours) == _describe(theirs)
    assert len(ours) == len(theirs)
    for i in range(0, len(ours), max(1, len(ours) // 17)):
        assert ours[i]["recipe"] == theirs[i]["recipe"]
        np.testing.assert_array_equal(ours[i]["image1"], theirs[i]["image1"])
