"""Synthetic flow data with exact ground truth, in memory (numpy, scipy).

Frames are smoothed textured noise (three Gaussian blurs of white noise,
so the correlation volume has structure at every scale); each next frame
is an affine warp of the textured plane, sampled bilinearly, with the
dense flow that the warp implies. Every frame is one sample of a canvas
with a margin wide enough that no pixel's source leaves it, so the flow is
exact at every pixel. Keypoint masks mark 3% of the pixels. All of it
comes from a seed.

The datasets give the samples the port's `FlowDataset` gives: NHWC float32
`image1`, `image2` (0..255 integer values), `flow`, `mask1`, `mask2`
(0/255), `valid`; KITTI-like data is sparse (`valid` on about a fifth of
the pixels, flow 0 elsewhere).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

# the warp between consecutive frames: per-axis translation magnitude (px),
# largest rotation (degrees), scale range
SHIFT = (4.0, 12.0)
MAX_DEG = 2.0
SCALE = (0.97, 1.03)


def random_affine(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """A 2x3 affine S about the frame's centre: S(p) = A (p - c) + c + t,
    p in (x, y); |t| per axis in SHIFT with a random sign, a rotation up to
    MAX_DEG, a scale in SCALE."""
    ang = math.radians(rng.uniform(-MAX_DEG, MAX_DEG))
    s = rng.uniform(*SCALE)
    t = rng.uniform(*SHIFT, size=2) * rng.choice([-1.0, 1.0], size=2)
    a = s * np.array([[math.cos(ang), -math.sin(ang)], [math.sin(ang), math.cos(ang)]])
    c = np.array([(w - 1) / 2, (h - 1) / 2])
    return np.concatenate([a, (c + t - a @ c)[:, None]], axis=1)


def _apply(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ m[:, :2].T + m[:, 2]


def _compose(m1: np.ndarray, m2: np.ndarray) -> np.ndarray:
    """The affine p -> m1(m2(p))."""
    return np.concatenate([m1[:, :2] @ m2[:, :2], (m1[:, :2] @ m2[:, 2] + m1[:, 2])[:, None]],
                          axis=1)


def _inverse(m: np.ndarray) -> np.ndarray:
    ainv = np.linalg.inv(m[:, :2])
    return np.concatenate([ainv, (-ainv @ m[:, 2])[:, None]], axis=1)


def textured(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """(h, w, 3) float32 smoothed noise spread over 0..255."""
    from scipy.ndimage import gaussian_filter

    base = rng.rand(h, w, 3).astype(np.float32)
    img = np.zeros_like(base)
    for sigma, gain in ((1.5, 1.0), (5.0, 2.0), (12.0, 4.0)):
        img += gain * gaussian_filter(base, (sigma, sigma, 0), mode="mirror")
    img -= img.min()
    img *= 255.0 / max(float(img.max()), 1e-6)
    return img


def affine_clip(rng: np.random.RandomState, h: int, w: int,
                n_frames: int) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """`n_frames` frames of one textured plane under a chain of random
    affine warps, and the flow between each consecutive pair.

    Frame k is the plane sampled at T_k(p), with T_0 the identity and
    T_{k+1} = T_k o S_k: frame k+1 at p shows what frame k shows at S_k(p),
    so the flow of frame k's pixel p is S_k^-1(p) - p, exact. -> (frames
    (h, w, 3) float32 with integer values, flows (h, w, 2) float32)."""
    from scipy.ndimage import map_coordinates

    steps = [random_affine(rng, h, w) for _ in range(n_frames - 1)]
    chain = [np.concatenate([np.eye(2), np.zeros((2, 1))], axis=1)]
    for s in steps:
        chain.append(_compose(chain[-1], s))
    # the margin: the farthest any T_k moves a corner (an affine map moves
    # no pixel of the frame farther than its farthest corner)
    corners = np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1]], np.float64)
    m = int(math.ceil(max(np.abs(_apply(t, corners) - corners).max() for t in chain))) + 2
    plane = textured(rng, h + 2 * m, w + 2 * m)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    pts = np.stack([xs, ys], axis=-1).reshape(-1, 2)
    frames = []
    for t in chain:
        src = _apply(t, pts) + m  # the canvas (x, y) each pixel shows
        frame = np.stack([map_coordinates(plane[..., ch], [src[:, 1], src[:, 0]], order=1,
                                          mode="mirror").reshape(h, w) for ch in range(3)],
                         axis=-1)
        frames.append(np.clip(np.round(frame), 0, 255).astype(np.float32))
    flows = [(_apply(_inverse(s), pts) - pts).reshape(h, w, 2).astype(np.float32)
             for s in steps]
    return frames, flows


def keypoint_mask(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """(h, w, 1) float32: 255 at 3% of the pixels, 0 elsewhere."""
    return ((rng.rand(h, w, 1) > 0.97) * 255).astype(np.float32)


def degrade(rng: np.random.RandomState, frame: np.ndarray) -> np.ndarray:
    """A 'final'-pass copy of a frame: a Gaussian blur (sigma 1) and
    Gaussian noise (sigma 3 grey levels), rounded to 0..255."""
    from scipy.ndimage import gaussian_filter

    out = gaussian_filter(frame, (1.0, 1.0, 0), mode="mirror")
    out = out + rng.normal(0.0, 3.0, frame.shape)
    return np.clip(np.round(out), 0, 255).astype(np.float32)


class InMemoryDataset:
    """A list of samples behind `__len__` and `__getitem__` (each call gives
    a fresh dict of the same arrays)."""

    def __init__(self, samples: Sequence[Dict[str, np.ndarray]]):
        self.samples = list(samples)

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return dict(self.samples[index % len(self.samples)])


def _sample(img1, img2, flow, mask1, mask2, valid=None) -> Dict[str, np.ndarray]:
    if valid is None:
        valid = ((np.abs(flow[..., 0]) < 1000) & (np.abs(flow[..., 1]) < 1000))
    return dict(image1=img1, image2=img2, flow=flow, mask1=mask1, mask2=mask2,
                valid=valid.astype(np.float32))


def chairs_layout(seed: int, n: int = 4, h: int = 384, w: int = 512) -> InMemoryDataset:
    """`n` independent pairs at FlyingChairs' 384x512, dense flow."""
    rng = np.random.RandomState(seed)
    samples = []
    for _ in range(n):
        (f1, f2), (flow,) = affine_clip(rng, h, w, 2)
        samples.append(_sample(f1, f2, flow, keypoint_mask(rng, h, w),
                               keypoint_mask(rng, h, w)))
    return InMemoryDataset(samples)


def sintel_layout(seed: int, n_frames: int = 5, h: int = 436,
                  w: int = 1024) -> Tuple[Dict[str, InMemoryDataset], Dict]:
    """One scene of `n_frames` frames at Sintel's 436x1024 -> ({'clean':
    its consecutive pairs, 'final': the same with each frame degraded},
    {'frames': {'clean': [...], 'final': [...]}, 'masks': [...], 'flows':
    [...]}) for the sequence path."""
    rng = np.random.RandomState(seed)
    frames, flows = affine_clip(rng, h, w, n_frames)
    masks = [keypoint_mask(rng, h, w) for _ in range(n_frames)]
    passes = {"clean": frames, "final": [degrade(rng, f) for f in frames]}
    sets = {name: InMemoryDataset([_sample(fr[k], fr[k + 1], flows[k], masks[k], masks[k + 1])
                                   for k in range(n_frames - 1)])
            for name, fr in passes.items()}
    return sets, dict(frames=passes, masks=masks, flows=flows)


def kitti_layout(seed: int, shapes: Sequence[Tuple[int, int]] = ((375, 1242),) * 3 + ((370, 1224),),
                 valid_share: float = 0.2) -> InMemoryDataset:
    """One pair at each of `shapes` (KITTI's 375x1242 and 370x1224), flow
    and `valid` on about `valid_share` of the pixels, 0 elsewhere."""
    rng = np.random.RandomState(seed)
    samples = []
    for h, w in shapes:
        (f1, f2), (flow,) = affine_clip(rng, h, w, 2)
        valid = rng.rand(h, w) < valid_share
        flow = np.where(valid[..., None], flow, 0.0).astype(np.float32)
        samples.append(_sample(f1, f2, flow, keypoint_mask(rng, h, w),
                               keypoint_mask(rng, h, w), valid))
    return InMemoryDataset(samples)
