"""Mask-aware data augmentation on the host (numpy, cv2, PIL).

The reference's augmentor: the photometric jitter (random-order
brightness / contrast / saturation / hue, torchvision's ColorJitter recipe
with PIL enhancers), eraser occlusion, and the spatial scale / stretch /
flip / crop pipeline, in which the keypoint masks are resized, flipped and
cropped in lockstep with the flow. The sparse (KITTI) variant resizes the
sparse flow map by scattering its valid points.

Every draw comes from the augmentor's own `np.random.RandomState(seed)`
(the global numpy generator where `seed` is None), so a seed fixes the
outputs. cv2 and PIL are imported at the first call.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.cache
def _cv2():
    """cv2, single-threaded and without OpenCL, as the augmentation runs in
    data workers."""
    import cv2

    cv2.setNumThreads(0)
    cv2.ocl.setUseOpenCL(False)
    return cv2


def _resize(a: np.ndarray, fx: float, fy: float) -> np.ndarray:
    cv2 = _cv2()
    return cv2.resize(a, None, fx=fx, fy=fy, interpolation=cv2.INTER_LINEAR)


def _adjust_hue(img, hue_factor: float):
    """torchvision-style PIL hue shift: H channel + factor*255 (mod 256)."""
    from PIL import Image

    if img.mode in ("L", "1", "I", "F"):
        return img
    h, s, v = img.convert("HSV").split()
    np_h = np.array(h, dtype=np.uint8)
    with np.errstate(over="ignore"):
        np_h = (np_h.astype(np.int16) + int(round(hue_factor * 255))).astype(np.uint8)
    h = Image.fromarray(np_h, "L")
    return Image.merge("HSV", (h, s, v)).convert(img.mode)


class ColorJitter:
    """Random-order brightness/contrast/saturation/hue jitter (torchvision recipe)."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0, rng=None):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        self.rng = rng or np.random

    def __call__(self, img: np.ndarray) -> np.ndarray:
        from PIL import Image, ImageEnhance

        pil = Image.fromarray(img)
        ops = []
        if self.brightness > 0:
            f = self.rng.uniform(max(0, 1 - self.brightness), 1 + self.brightness)
            ops.append(lambda im, f=f: ImageEnhance.Brightness(im).enhance(f))
        if self.contrast > 0:
            f = self.rng.uniform(max(0, 1 - self.contrast), 1 + self.contrast)
            ops.append(lambda im, f=f: ImageEnhance.Contrast(im).enhance(f))
        if self.saturation > 0:
            f = self.rng.uniform(max(0, 1 - self.saturation), 1 + self.saturation)
            ops.append(lambda im, f=f: ImageEnhance.Color(im).enhance(f))
        if self.hue > 0:
            f = self.rng.uniform(-self.hue, self.hue)
            ops.append(lambda im, f=f: _adjust_hue(im, f))
        for i in self.rng.permutation(len(ops)):
            pil = ops[i](pil)
        return np.array(pil, dtype=np.uint8)


class FlowAugmentor:
    """Dense-flow augmentor."""

    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5, do_flip=True,
                 seed=None):
        self.crop_size = crop_size
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = 0.8
        self.stretch_prob = 0.8
        self.max_stretch = 0.2

        self.do_flip = do_flip
        self.h_flip_prob = 0.5
        self.v_flip_prob = 0.1

        self.rng = np.random.RandomState(seed) if seed is not None else np.random
        self.photo_aug = ColorJitter(0.4, 0.4, 0.4, 0.5 / 3.14, rng=self.rng)
        self.asymmetric_color_aug_prob = 0.2
        self.eraser_aug_prob = 0.5

    # -- photometric ---------------------------------------------------------
    def color_transform(self, img1, img2):
        if self.rng.rand() < self.asymmetric_color_aug_prob:
            return self.photo_aug(img1), self.photo_aug(img2)
        stack = np.concatenate([img1, img2], axis=0)
        stack = self.photo_aug(stack)
        out1, out2 = np.split(stack, 2, axis=0)
        return out1, out2

    def eraser_transform(self, img1, img2, bounds=(50, 100)):
        ht, wd = img1.shape[:2]
        if self.rng.rand() < self.eraser_aug_prob:
            img2 = img2.copy()
            mean_color = np.mean(img2.reshape(-1, 3), axis=0)
            for _ in range(self.rng.randint(1, 3)):
                x0 = self.rng.randint(0, wd)
                y0 = self.rng.randint(0, ht)
                dx = self.rng.randint(bounds[0], bounds[1])
                dy = self.rng.randint(bounds[0], bounds[1])
                img2[y0 : y0 + dy, x0 : x0 + dx, :] = mean_color
        return img1, img2

    # -- spatial -------------------------------------------------------------
    def spatial_transform(self, img1, img2, flow, mask1, mask2):
        ht, wd = img1.shape[:2]
        min_scale = np.maximum(
            (self.crop_size[0] + 8) / float(ht), (self.crop_size[1] + 8) / float(wd)
        )
        scale = 2 ** self.rng.uniform(self.min_scale, self.max_scale)
        scale_x = scale_y = scale
        if self.rng.rand() < self.stretch_prob:
            scale_x *= 2 ** self.rng.uniform(-self.max_stretch, self.max_stretch)
            scale_y *= 2 ** self.rng.uniform(-self.max_stretch, self.max_stretch)
        scale_x = np.clip(scale_x, min_scale, None)
        scale_y = np.clip(scale_y, min_scale, None)

        if self.rng.rand() < self.spatial_aug_prob:
            rs = lambda a: _resize(a, scale_x, scale_y)
            img1, img2, flow = rs(img1), rs(img2), rs(flow)
            mask1, mask2 = rs(mask1), rs(mask2)
            flow = flow * [scale_x, scale_y]

        if self.do_flip:
            if self.rng.rand() < self.h_flip_prob:
                img1, img2 = img1[:, ::-1], img2[:, ::-1]
                flow = flow[:, ::-1] * [-1.0, 1.0]
                mask1, mask2 = mask1[:, ::-1], mask2[:, ::-1]
            if self.rng.rand() < self.v_flip_prob:
                img1, img2 = img1[::-1, :], img2[::-1, :]
                flow = flow[::-1, :] * [1.0, -1.0]
                mask1, mask2 = mask1[::-1, :], mask2[::-1, :]

        y0 = x0 = 0
        if img1.shape[0] > self.crop_size[0]:
            y0 = self.rng.randint(0, img1.shape[0] - self.crop_size[0])
        if img1.shape[1] > self.crop_size[1]:
            x0 = self.rng.randint(0, img1.shape[1] - self.crop_size[1])
        sl = np.s_[y0 : y0 + self.crop_size[0], x0 : x0 + self.crop_size[1]]
        return img1[sl], img2[sl], flow[sl], mask1[sl], mask2[sl]

    def __call__(self, img1, img2, flow, mask1, mask2):
        img1, img2 = self.color_transform(img1, img2)
        img1, img2 = self.eraser_transform(img1, img2)
        img1, img2, flow, mask1, mask2 = self.spatial_transform(
            img1, img2, flow, mask1, mask2
        )
        out = [np.ascontiguousarray(a) for a in (img1, img2, flow, mask1, mask2)]
        for i in (3, 4):
            if out[i].ndim == 2:
                out[i] = out[i][:, :, None]
        return tuple(out)


class SparseFlowAugmentor:
    """KITTI variant: symmetric-only jitter(0.3),
    sparse flow resized by scattering valid points, h-flip only."""

    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5, do_flip=False,
                 seed=None):
        self.crop_size = crop_size
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = 0.8

        self.do_flip = do_flip

        self.rng = np.random.RandomState(seed) if seed is not None else np.random
        self.photo_aug = ColorJitter(0.3, 0.3, 0.3, 0.3 / 3.14, rng=self.rng)
        self.eraser_aug_prob = 0.5

    def color_transform(self, img1, img2):
        stack = np.concatenate([img1, img2], axis=0)
        stack = self.photo_aug(stack)
        return np.split(stack, 2, axis=0)

    def eraser_transform(self, img1, img2):
        ht, wd = img1.shape[:2]
        if self.rng.rand() < self.eraser_aug_prob:
            img2 = img2.copy()
            mean_color = np.mean(img2.reshape(-1, 3), axis=0)
            for _ in range(self.rng.randint(1, 3)):
                x0 = self.rng.randint(0, wd)
                y0 = self.rng.randint(0, ht)
                dx = self.rng.randint(50, 100)
                dy = self.rng.randint(50, 100)
                img2[y0 : y0 + dy, x0 : x0 + dx, :] = mean_color
        return img1, img2

    def resize_sparse_flow_map(self, flow, valid, fx=1.0, fy=1.0):
        ht, wd = flow.shape[:2]
        coords = np.stack(np.meshgrid(np.arange(wd), np.arange(ht)), axis=-1)
        coords = coords.reshape(-1, 2).astype(np.float32)
        flow_flat = flow.reshape(-1, 2).astype(np.float32)
        valid_flat = valid.reshape(-1).astype(np.float32)

        coords0 = coords[valid_flat >= 1]
        flow0 = flow_flat[valid_flat >= 1]

        ht1 = int(round(ht * fy))
        wd1 = int(round(wd * fx))
        coords1 = coords0 * [fx, fy]
        flow1 = flow0 * [fx, fy]

        xx = np.round(coords1[:, 0]).astype(np.int32)
        yy = np.round(coords1[:, 1]).astype(np.int32)
        v = (xx > 0) & (xx < wd1) & (yy > 0) & (yy < ht1)

        flow_img = np.zeros([ht1, wd1, 2], np.float32)
        valid_img = np.zeros([ht1, wd1], np.int32)
        flow_img[yy[v], xx[v]] = flow1[v]
        valid_img[yy[v], xx[v]] = 1
        return flow_img, valid_img

    def spatial_transform(self, img1, img2, flow, valid, mask1, mask2):
        ht, wd = img1.shape[:2]
        min_scale = np.maximum(
            (self.crop_size[0] + 1) / float(ht), (self.crop_size[1] + 1) / float(wd)
        )
        scale = 2 ** self.rng.uniform(self.min_scale, self.max_scale)
        scale_x = np.clip(scale, min_scale, None)
        scale_y = np.clip(scale, min_scale, None)

        if self.rng.rand() < self.spatial_aug_prob:
            rs = lambda a: _resize(a, scale_x, scale_y)
            img1, img2 = rs(img1), rs(img2)
            flow, valid = self.resize_sparse_flow_map(flow, valid, scale_x, scale_y)
            mask1, mask2 = rs(mask1), rs(mask2)

        if self.do_flip and self.rng.rand() < 0.5:
            img1, img2 = img1[:, ::-1], img2[:, ::-1]
            flow = flow[:, ::-1] * [-1.0, 1.0]
            valid = valid[:, ::-1]
            mask1, mask2 = mask1[:, ::-1], mask2[:, ::-1]

        y0 = x0 = 0
        if img1.shape[0] > self.crop_size[0]:
            y0 = self.rng.randint(0, img1.shape[0] - self.crop_size[0])
        if img1.shape[1] > self.crop_size[1]:
            x0 = self.rng.randint(0, img1.shape[1] - self.crop_size[1])
        sl = np.s_[y0 : y0 + self.crop_size[0], x0 : x0 + self.crop_size[1]]
        return img1[sl], img2[sl], flow[sl], valid[sl], mask1[sl], mask2[sl]

    def __call__(self, img1, img2, flow, valid, mask1, mask2):
        img1, img2 = self.color_transform(img1, img2)
        img1, img2 = self.eraser_transform(img1, img2)
        img1, img2, flow, valid, mask1, mask2 = self.spatial_transform(
            img1, img2, flow, valid, mask1, mask2
        )
        out = [np.ascontiguousarray(a) for a in (img1, img2, flow, valid, mask1, mask2)]
        for i in (4, 5):
            if out[i].ndim == 2:
                out[i] = out[i][:, :, None]
        return tuple(out)
