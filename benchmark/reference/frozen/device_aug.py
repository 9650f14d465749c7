"""On-card flow augmentation: the training step's half of the input
pipeline (the counterpart of the JAX package's `data/device_aug.py`).

The loader ships raw full-size frames (`fetch_dataset(no_aug=True)`) and
this module does the photometric jitter, the eraser and the scale /
stretch / flip / crop warp on the card, per sample, with the recipes of
the host augmentors (`data/augment.py`): dense (`FlowAugmentor`) and
sparse (`SparseFlowAugmentor`, KITTI).

Each call has two parts. `DeviceFlowAugmentor.draw(gen, batch_size,
sizes, recipe)` takes every per-sample random quantity from one
`torch.Generator` (one uniform draw for the batch) and returns them as
tensors; `apply(batch, draws)` is deterministic. `__call__` is
`apply(batch, draw(...))`. Under data parallelism `draw` takes the
uniforms of the global batch on every rank (the same generator state
everywhere) and keeps the rank's rows, the loader's stride.

Semantics, as the JAX module has them:
- Batches are NHWC f32 on any device (image1, image2 in 0..255, flow,
  mask1, mask2; `valid` optional, ones where absent). Batches of several
  resolutions arrive zero-padded with the true (h, w) in `sizes`; means,
  scale floors and sampling weights mask to the true extent, and padding
  columns of the warp weigh 0. `recipe` indexes the recipe table
  (`dense_recipe`, `sparse_recipe`): a mixed stage's samples carry their
  dataset's row.
- Photometric ops are float forms of the PIL / torchvision enhancers,
  applied in a random order per sample, symmetric over the pair (one draw
  and one contrast mean over both frames) or, with the recipe's
  `asym_prob`, one draw a frame. Every sample computes the three jitters
  and keeps one, as JAX's `vmap` does.
- The cv2 chain resize -> flip -> crop is one separable bilinear warp:
  per-sample tent weights for each axis with cv2's pixel mapping (the
  scale is the ratio of the rounded sizes) and edge clamp, applied as two
  batched f32 products over all ten channels at once. The products run
  in full f32 (TF32 off) whatever the caller's flags, as JAX's
  `Precision.HIGHEST` einsums do. A batch in f64 is warped in f64, tent
  weights and products alike, from the same draws.
- Sparse flow (KITTI) scatters each valid point to round(s * scale),
  rounding half to even, as two 0/1 products; colliding points average,
  and the reference's `strict` boundary rule (resized index 0 dropped)
  holds where the sample was resized. A batch whose table has no sparse
  row skips the scatter.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from .precision import no_tf32 as _no_tf32

# ---------------------------------------------------------------------------
# photometric: float forms of the torchvision / PIL jitter
# ---------------------------------------------------------------------------


def _rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """PIL 'L' luma weights (ITU-R 601-2), no uint8 rounding."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    return 0.299 * r + 0.587 * g + 0.114 * b


def _blend(base, img, factor):
    return torch.clamp(base * (1.0 - factor) + img * factor, 0.0, 255.0)


def adjust_brightness(img, factor, mean_=None):
    return torch.clamp(img * factor, 0.0, 255.0)


def adjust_contrast(img, factor, mean_):
    """PIL Contrast: a blend with the grayscale image's mean over the true
    extent, which the caller passes in."""
    return _blend(mean_, img, factor)


def adjust_saturation(img, factor, mean_=None):
    return _blend(_rgb_to_gray(img)[..., None], img, factor)


def adjust_hue(img, shift, mean_=None):
    """Hue rotation by `shift` (a fraction of the circle) through float HSV;
    `shift` broadcasts against img[..., 0]."""
    x = img / 255.0
    mx = x.amax(dim=-1)
    mn = x.amin(dim=-1)
    c = mx - mn
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    safe_c = torch.where(c > 0, c, torch.ones_like(c))
    h = torch.where(mx == r, (g - b) / safe_c,
                    torch.where(mx == g, 2.0 + (b - r) / safe_c, 4.0 + (r - g) / safe_c))
    h = torch.where(c > 0, h / 6.0, torch.zeros_like(h)) % 1.0
    h = (h + shift) % 1.0
    hp = h * 6.0
    i = torch.floor(hp)
    f = hp - i
    p = mx - c
    q = mx - c * f
    t = mx - c * (1.0 - f)
    i = i.to(torch.int32) % 6

    def pick(options):
        out = options[0]
        for k in range(1, 6):
            out = torch.where(i == k, options[k], out)
        return out

    rgb = torch.stack([pick([mx, q, p, p, t, mx]), pick([t, mx, mx, q, p, p]),
                       pick([p, p, t, mx, mx, q])], dim=-1)
    return torch.clamp(rgb * 255.0, 0.0, 255.0)


def _color_jitter(img, extent, factors, order):
    """Random-order jitter of (N, F, H, W, 3) images in [0, 255]: F frames
    a sample share its factors (N, 4: brightness, contrast, saturation,
    hue) and op order (N, 4, a permutation of 0..3), and the contrast mean
    spans them (the reference jitters a pair stacked as one image).
    extent (N, 1, H, W, 1): 1 inside the true image.

    Contrast and saturation are `_blend`s with the gray mean and the gray
    image, and brightness is one with base 0 (0 * (1 - f) adds an exact 0
    to img * f), so each position computes one blend and the hue rotation
    for every sample and keeps the one its op names."""
    n_px = torch.clamp(extent.sum(dim=(1, 2, 3, 4)) * img.shape[1], min=1.0)
    col = lambda t: t.view(-1, 1, 1, 1, 1)
    for pos in range(4):
        op = order[:, pos]
        gray = _rgb_to_gray(img)[..., None]
        mean_ = col((gray * extent).sum(dim=(1, 2, 3, 4)) / n_px)
        f = col(factors.gather(1, op[:, None])[:, 0])
        base = torch.where(col(op == 2), gray, torch.where(col(op == 1), mean_, 0.0))
        img = torch.where(col(op == 3), adjust_hue(img, f[..., 0]), _blend(base, img, f))
    return img


# ---------------------------------------------------------------------------
# eraser occlusion
# ---------------------------------------------------------------------------


def _eraser(img2, extent, gate, n_rect, rects):
    """Rectangles of frame 2 (N, H, W, 3) filled with its mean colour over
    the true extent (N, H, W, 1): where `gate`, the first `n_rect` (1 or 2)
    of `rects` (N, 2, 4: x0, y0, dx, dy)."""
    n, h, w = img2.shape[:3]
    n_px = torch.clamp(extent.sum(dim=(1, 2, 3)), min=1.0)
    mean_color = (img2 * extent).sum(dim=(1, 2)) / n_px[:, None]
    yy = torch.arange(h, device=img2.device).view(1, h, 1)
    xx = torch.arange(w, device=img2.device).view(1, 1, w)
    v = lambda t: t.view(n, 1, 1)
    out = img2
    for r in range(2):
        x0, y0, dx, dy = (rects[:, r, k] for k in range(4))
        inside = ((yy >= v(y0)) & (yy < v(y0 + dy)) & (xx >= v(x0)) & (xx < v(x0 + dx)))
        use = v(gate & (n_rect > r))
        out = torch.where((inside & use)[..., None], mean_color[:, None, None, :], out)
    return out


# ---------------------------------------------------------------------------
# per-sample recipes (mixed-dataset stages)
# ---------------------------------------------------------------------------


def dense_recipe(min_scale: float, max_scale: float, do_flip: bool = True) -> Dict[str, float]:
    """`FlowAugmentor`'s parameters (`data/augment.py`)."""
    return dict(
        sparse=0.0, min_scale=min_scale, max_scale=max_scale,
        crop_margin=8.0, stretch_prob=0.8, spatial_aug_prob=0.8,
        h_flip_prob=0.5 if do_flip else 0.0,
        v_flip_prob=0.1 if do_flip else 0.0,
        asym_prob=0.2, brightness=0.4, contrast=0.4, saturation=0.4,
        hue=0.5 / 3.14)


def sparse_recipe(min_scale: float, max_scale: float, do_flip: bool = True) -> Dict[str, float]:
    """`SparseFlowAugmentor`'s: symmetric jitter of 0.3, one scale (no
    stretch), horizontal flips only, a crop margin of 1 (the dense one's
    8), the sparse flow scatter."""
    return dict(
        sparse=1.0, min_scale=min_scale, max_scale=max_scale,
        crop_margin=1.0, stretch_prob=0.0, spatial_aug_prob=0.8,
        h_flip_prob=0.5 if do_flip else 0.0, v_flip_prob=0.0,
        asym_prob=0.0, brightness=0.3, contrast=0.3, saturation=0.3,
        hue=0.3 / 3.14)


# ---------------------------------------------------------------------------
# spatial: one separable bilinear warp == cv2.resize -> flip -> crop
# ---------------------------------------------------------------------------


def _window_rows(out_len, offset, flip, resized_len, dtype=torch.float32):
    """(N, out_len) in `dtype`: the resized-space index of each crop row,
    offset + o, or resized_len - 1 - (offset + o) where flipped."""
    o = torch.arange(out_len, dtype=dtype, device=offset.device)[None, :]
    r = offset.to(dtype)[:, None] + o
    return torch.where(flip[:, None], resized_len.to(dtype)[:, None] - 1.0 - r, r)


def _axis_weights(out_len, src_len_static, src_len, offset, flip, resized_len,
                  dtype=torch.float32):
    """(N, out_len, src_len_static) tent weights of one axis of the warp
    (src_len, offset, flip, resized_len: (N,) tensors). Crop row o samples
    source position (r + 0.5) * src_len / resized_len - 0.5, clamped to
    the true extent: cv2's scale is the ratio of the rounded sizes, not the
    requested factor. Columns at or past src_len (padding) weigh 0."""
    r = _window_rows(out_len, offset, flip, resized_len, dtype)
    src = src_len.to(dtype)[:, None]
    pos = (r + 0.5) * (src / resized_len.to(dtype)[:, None]) - 0.5
    pos = torch.minimum(torch.clamp(pos, min=0.0), src - 1.0)
    grid = torch.arange(src_len_static, dtype=dtype, device=offset.device)
    w = torch.clamp(1.0 - (pos[:, :, None] - grid).abs(), min=0.0)
    return w * (grid[None, None, :] < src[:, :, None]).to(dtype)


def _separable(wy, img, wx):
    """wy (N, ch, H) . img (N, H, W, C) . wx (N, cw, W)^T -> (N, ch, cw, C),
    full f32."""
    with _no_tf32():
        tmp = torch.einsum("noh,nhwc->nowc", wy, img)
        return torch.einsum("npw,nowc->nopc", wx, tmp)


def warp_resize_crop(img, y0, x0, fv, fh, size_hw, resized_hw, crop_size):
    """(N, H, W, C) -> (N, ch, cw, C): cv2.resize to `resized_hw` (N, 2)
    with INTER_LINEAR, the flips (`fv`, `fh`), and the crop at (y0, x0),
    per sample, of the true extent `size_hw` (N, 2)."""
    h, w = img.shape[1:3]
    ch, cw = crop_size
    wy = _axis_weights(ch, h, size_hw[:, 0], y0, fv, resized_hw[:, 0], img.dtype)
    wx = _axis_weights(cw, w, size_hw[:, 1], x0, fh, resized_hw[:, 1], img.dtype)
    return _separable(wy, img, wx)


def _scatter_axis_matrix(out_len, src_len_static, src_len, offset, flip, resized_len, scale,
                         strict):
    """(N, out_len, src_len_static) 0/1: M[o, s] = 1 where source index s
    lands on crop row o. The reference scatter
    (`data/augment.py::resize_sparse_flow_map`) sends s to round(s *
    scale), half to even; `strict` (N,) drops resized index 0, its
    boundary quirk, where the sample was resized."""
    r = _window_rows(out_len, offset, flip, resized_len)
    s = torch.arange(src_len_static, dtype=torch.float32, device=offset.device)
    tgt = torch.round(s[None, :] * scale[:, None])
    m = (tgt[:, None, :] == r[:, :, None]) & (s[None, None, :] < src_len.float()[:, None, None])
    lo_ok = torch.where(strict[:, None], r > 0, r >= 0)
    m = m & (lo_ok & (r < resized_len.float()[:, None]))[:, :, None]
    return m.float()


def sparse_scatter_crop(flow, valid, sy, sx, y0, x0, fh, size_hw, resized_hw, crop_size,
                        strict):
    """Sparse flow (N, H, W, 2) with `valid` (N, H, W): resize -> h-flip
    -> crop, points that collide averaged -> (flow (N, ch, cw, 2) scaled by
    (sx, sy) and negated in x where flipped, valid (N, ch, cw))."""
    h, w = flow.shape[1:3]
    ch, cw = crop_size
    my = _scatter_axis_matrix(ch, h, size_hw[:, 0], y0, torch.zeros_like(fh), resized_hw[:, 0],
                              sy, strict)
    mx = _scatter_axis_matrix(cw, w, size_hw[:, 1], x0, fh, resized_hw[:, 1], sx, strict)
    v = valid.float()[..., None]
    out = _separable(my, torch.cat([flow * v, v], dim=-1), mx)
    num, cnt = out[..., :2], out[..., 2:]
    flow_out = num / torch.clamp(cnt, min=1.0)
    flow_out = flow_out * torch.stack([sx, sy], dim=-1)[:, None, None, :]
    sign = torch.stack([torch.where(fh, -1.0, 1.0), torch.ones_like(sx)], dim=-1)
    return flow_out * sign[:, None, None, :], (cnt[..., 0] > 0).float()


# ---------------------------------------------------------------------------
# the augmentor
# ---------------------------------------------------------------------------

# the columns of `draw`'s one uniform draw
_JIT, _PERM, _ASYM, _ERASE, _NRECT, _RECTS = 0, 12, 24, 25, 26, 27
_SCALE, _DO_STRETCH, _STRETCH, _DO_SPATIAL, _FLIP, _OFFSET = 35, 36, 37, 39, 40, 42
_N_UNIFORM = 44


def _randint(u, lo, hi):
    """u in [0, 1) -> an integer in [lo, hi) (`hi` may be a tensor)."""
    return torch.clamp(lo + torch.floor(u * (hi - lo)), max=hi - 1.0).long()


class DeviceFlowAugmentor:
    """The recipe-table augmentor (the module docstring says what it
    does). With the default single dense recipe it is the chairs / things
    path; mixed stages pass one recipe a source dataset and per-sample
    `recipe` indices.

    Draws (`draw`; (N, ...) tensors on the batch's device):
    - `jitter` (N, 3, 4) f32: brightness, contrast, saturation factors and
      the hue shift, for the symmetric jitter, frame 1's and frame 2's;
    - `order` (N, 3, 4) long: each jitter's op order;
    - `asym` (N,) bool: the per-frame jitters instead of the symmetric one;
    - `erase` (N,) bool, `n_rect` (N,) long (1 or 2), `rects` (N, 2, 4)
      long: x0, y0, dx, dy;
    - `scale` (N,) f32 (2^U[min_scale, max_scale)), `stretch` (N, 2) f32
      (2^U[-0.2, 0.2) for x, y), `do_stretch`, `do_spatial` (N,) bool;
    - `flip` (N, 2) bool: horizontal, vertical;
    - `offset` (N, 2) long: the crop's (y0, x0).
    """

    max_stretch = 0.2
    eraser_aug_prob = 0.5
    eraser_bounds = (50, 100)

    def __init__(self, crop_size: Tuple[int, int], min_scale: float = -0.2,
                 max_scale: float = 0.5, do_flip: bool = True,
                 recipes: Optional[Sequence[Dict[str, float]]] = None):
        self.crop_size = tuple(int(c) for c in crop_size)
        if recipes is None:
            recipes = [dense_recipe(min_scale, max_scale, do_flip)]
        self.table = {k: torch.tensor([r[k] for r in recipes], dtype=torch.float32)
                      for k in recipes[0]}
        self.has_sparse = any(r["sparse"] > 0.5 for r in recipes)

    def _recipe(self, recipe: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {k: v.to(recipe.device)[recipe] for k, v in self.table.items()}

    def _resize(self, draws, sizes, rp):
        """-> sx, sy (N,) f32 and the resized (h, w) (N, 2) long, from the
        scale draws, the true sizes and the recipe's crop margin."""
        ch, cw = self.crop_size
        hf, wf = sizes[:, 0].float(), sizes[:, 1].float()
        m = rp["crop_margin"]
        min_scale = torch.maximum((ch + m) / hf, (cw + m) / wf)
        one = torch.ones_like(hf)
        st = draws["stretch"]
        sx = draws["scale"] * torch.where(draws["do_stretch"], st[:, 0], one)
        sy = draws["scale"] * torch.where(draws["do_stretch"], st[:, 1], one)
        sx = torch.where(draws["do_spatial"], torch.maximum(sx, min_scale), one)
        sy = torch.where(draws["do_spatial"], torch.maximum(sy, min_scale), one)
        resized = torch.stack([torch.round(hf * sy), torch.round(wf * sx)], dim=-1).long()
        return sx, sy, resized

    def draw(self, gen: torch.Generator, batch_size: int, sizes: torch.Tensor,
             recipe: torch.Tensor, *, world: int = 1, rank: int = 0) -> Dict[str, torch.Tensor]:
        """Every random quantity of `apply` for a batch of `batch_size`
        samples of true `sizes` (N, 2) and `recipe` rows (N,), from one
        uniform draw of `gen`. With `world` > 1 the draw is the global
        batch's (batch_size * world samples, the same on every rank given
        the same generator state) and the rank keeps rows rank, rank +
        world, ...: the loader's stride."""
        dev = sizes.device
        u = torch.rand((batch_size * world, _N_UNIFORM), generator=gen, device=gen.device,
                       dtype=torch.float64)
        u = u[rank::world].to(dev)
        rp = {k: v.double() for k, v in self._recipe(recipe).items()}
        col = lambda t: t[:, None]

        lo = lambda s: torch.clamp(1.0 - s, min=0.0)
        jlo = torch.stack([lo(rp["brightness"]), lo(rp["contrast"]), lo(rp["saturation"]),
                           -rp["hue"]], dim=-1)[:, None, :]
        jhi = torch.stack([1.0 + rp["brightness"], 1.0 + rp["contrast"],
                           1.0 + rp["saturation"], rp["hue"]], dim=-1)[:, None, :]
        jitter = jlo + (jhi - jlo) * u[:, _JIT:_PERM].view(-1, 3, 4)
        order = u[:, _PERM:_ASYM].view(-1, 3, 4).argsort(dim=-1)

        h, w = sizes[:, 0].double(), sizes[:, 1].double()
        blo, bhi = self.eraser_bounds
        ur = u[:, _RECTS:_SCALE].view(-1, 2, 4)
        rects = torch.stack([_randint(ur[..., 0], 0.0, col(torch.clamp(w, min=1.0))),
                             _randint(ur[..., 1], 0.0, col(torch.clamp(h, min=1.0))),
                             _randint(ur[..., 2], float(blo), float(bhi)),
                             _randint(ur[..., 3], float(blo), float(bhi))], dim=-1)

        expo = rp["min_scale"] + (rp["max_scale"] - rp["min_scale"]) * u[:, _SCALE]
        ms = self.max_stretch
        draws = dict(
            jitter=jitter.float(), order=order, asym=u[:, _ASYM] < rp["asym_prob"],
            erase=u[:, _ERASE] < self.eraser_aug_prob, n_rect=1 + (u[:, _NRECT] >= 0.5).long(),
            rects=rects, scale=torch.exp2(expo.float()),
            stretch=torch.exp2((-ms + 2 * ms * u[:, _STRETCH:_DO_SPATIAL]).float()),
            do_stretch=u[:, _DO_STRETCH] < rp["stretch_prob"],
            do_spatial=u[:, _DO_SPATIAL] < rp["spatial_aug_prob"],
            flip=torch.stack([u[:, _FLIP] < rp["h_flip_prob"],
                              u[:, _FLIP + 1] < rp["v_flip_prob"]], dim=-1))
        _, _, resized = self._resize(draws, sizes, self._recipe(recipe))
        crop = torch.tensor(self.crop_size, device=dev, dtype=torch.float64)
        span = torch.clamp(resized.double() - crop, min=1.0)
        draws["offset"] = _randint(u[:, _OFFSET:], 0.0, span)
        return draws

    @staticmethod
    def _defaults(batch):
        b, h, w = batch["image1"].shape[:3]
        dev = batch["image1"].device
        sizes = batch.get("sizes")
        if sizes is None:
            sizes = torch.tensor([[h, w]], device=dev).expand(b, 2)
        recipe = batch.get("recipe")
        if recipe is None:
            recipe = torch.zeros((b,), dtype=torch.long, device=dev)
        return sizes.long(), recipe.long()

    def apply(self, batch: Dict[str, torch.Tensor],
              draws: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The augmentation of a raw batch (NHWC f32: image1, image2, flow,
        mask1, mask2; optional valid (N, H, W), sizes (N, 2), recipe (N,))
        under `draws` -> the batch cropped to `crop_size`, valid filled,
        without sizes and recipe."""
        img1, img2 = batch["image1"], batch["image2"]
        n, h, w = img1.shape[:3]
        dev = img1.device
        sizes, recipe = self._defaults(batch)
        rp = self._recipe(recipe)
        valid = batch.get("valid")
        if valid is None:
            valid = torch.ones((n, h, w), device=dev)
        extent = ((torch.arange(h, device=dev).view(1, h, 1) < sizes[:, 0].view(n, 1, 1))
                  & (torch.arange(w, device=dev).view(1, 1, w) < sizes[:, 1].view(n, 1, 1)))
        extent = extent.float()[..., None]  # (N, H, W, 1)

        # photometric: the symmetric jitter over the pair, and each frame's
        jit, order = draws["jitter"], draws["order"]
        sym = _color_jitter(torch.stack([img1, img2], dim=1), extent[:, None], jit[:, 0],
                            order[:, 0])
        per = _color_jitter(torch.cat([img1, img2])[:, None], extent.repeat(2, 1, 1, 1)[:, None],
                            torch.cat([jit[:, 1], jit[:, 2]]), torch.cat([order[:, 1], order[:, 2]]))
        asym = draws["asym"].view(n, 1, 1, 1)
        img1 = torch.where(asym, per[:n, 0], sym[:, 0])
        img2 = torch.where(asym, per[n:, 0], sym[:, 1])
        img2 = _eraser(img2, extent, draws["erase"], draws["n_rect"], draws["rects"])

        # spatial: one warp of the ten channels
        sx, sy, resized = self._resize(draws, sizes, rp)
        fh, fv = draws["flip"][:, 0], draws["flip"][:, 1]
        y0, x0 = draws["offset"][:, 0], draws["offset"][:, 1]
        flow = batch["flow"]
        out = warp_resize_crop(torch.cat([img1, img2, batch["mask1"], batch["mask2"], flow], -1),
                               y0, x0, fv, fh, sizes, resized, self.crop_size)
        img1, img2, mask1, mask2, flow_d = torch.split(out, [3, 3, 1, 1, 2], dim=-1)
        sign = torch.stack([torch.where(fh, -1.0, 1.0), torch.where(fv, -1.0, 1.0)], -1)
        flow_d = flow_d * torch.stack([sx, sy], -1)[:, None, None, :] * sign[:, None, None, :]
        valid_d = ((flow_d[..., 0].abs() < 1000) & (flow_d[..., 1].abs() < 1000)).float()
        if self.has_sparse:
            flow_s, valid_s = sparse_scatter_crop(flow, valid, sy, sx, y0, x0, fh, sizes,
                                                  resized, self.crop_size,
                                                  strict=draws["do_spatial"])
            is_sparse = (rp["sparse"] > 0.5).view(n, 1, 1)
            flow_d = torch.where(is_sparse[..., None], flow_s, flow_d)
            valid_d = torch.where(is_sparse, valid_s, valid_d)
        out = {k: v for k, v in batch.items() if k not in ("sizes", "recipe")}
        out.update(image1=img1.contiguous(), image2=img2.contiguous(), flow=flow_d.contiguous(),
                   valid=valid_d, mask1=mask1.contiguous(), mask2=mask2.contiguous())
        return out

    def __call__(self, gen: torch.Generator, batch: Dict[str, torch.Tensor], *,
                 world: int = 1, rank: int = 0) -> Dict[str, torch.Tensor]:
        sizes, recipe = self._defaults(batch)
        draws = self.draw(gen, batch["image1"].shape[0], sizes, recipe, world=world, rank=rank)
        return self.apply(batch, draws)
