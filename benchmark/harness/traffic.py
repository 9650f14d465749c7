"""The traffic generator: synthetic flow pairs with exact ground truth, made
on the device from a seed (the program's `data/synthetic.py`, copied and
moved onto the card so that set-up stays short).

Frames are smoothed textured noise (three Gaussian blurs of white noise,
gains 1, 2, 4 at sigmas 1.5, 5, 12, spread over 0..255), so the
correlation volume has structure at every scale; the second frame is an
affine warp of the textured plane (a translation of 4-12 px per axis with
a random sign, a rotation up to 2 degrees, a scale in [0.97, 1.03] about
the frame's centre), sampled bilinearly from a canvas with a margin wide
enough that no pixel's source leaves it, so the flow is exact at every
pixel. Frames are rounded to integers in 0..255. Keypoint masks mark 3% of
the pixels (0/255). Every seed draws the same sizes in the same order, so
only the values change with it.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

SHIFT = (4.0, 12.0)
MAX_DEG = 2.0
SCALE = (0.97, 1.03)
BLURS = ((1.5, 1.0), (5.0, 2.0), (12.0, 4.0))
KEYPOINT_SHARE = 0.03


def margin(h: int, w: int) -> int:
    """The canvas margin: the farthest the largest warp moves a corner."""
    half_diag = math.hypot(w - 1, h - 1) / 2
    a = max(abs(SCALE[0] - 1), abs(SCALE[1] - 1)) + SCALE[1] * math.radians(MAX_DEG)
    return int(math.ceil(SHIFT[1] * math.sqrt(2) + a * half_diag)) + 2


def _gauss_blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of (N, C, H, W), truncated at 4 sigma,
    mirrored at the edges (scipy's 'mirror')."""
    r = int(4 * sigma + 0.5)
    t = torch.arange(-r, r + 1, device=x.device, dtype=torch.float32)
    k = torch.exp(-0.5 * (t / sigma) ** 2)
    k = k / k.sum()
    c = x.shape[1]
    x = F.conv2d(F.pad(x, (r, r, 0, 0), mode="reflect"), k.view(1, 1, 1, -1).repeat(c, 1, 1, 1),
                 groups=c)
    return F.conv2d(F.pad(x, (0, 0, r, r), mode="reflect"), k.view(1, 1, -1, 1).repeat(c, 1, 1, 1),
                    groups=c)


def textured(gen: torch.Generator, n: int, h: int, w: int, device) -> torch.Tensor:
    """(n, 3, h, w) f32 smoothed noise spread over 0..255, one plane a sample."""
    base = torch.rand((n, 3, h, w), generator=gen, device=device)
    img = sum(gain * _gauss_blur(base, sigma) for sigma, gain in BLURS)
    lo = img.amin(dim=(1, 2, 3), keepdim=True)
    hi = img.amax(dim=(1, 2, 3), keepdim=True)
    return (img - lo) * (255.0 / (hi - lo).clamp(min=1e-6))


def affine(gen: torch.Generator, n: int, h: int, w: int, device) -> torch.Tensor:
    """(n, 2, 3) affines S(p) = A (p - c) + c + t in (x, y), f64."""
    u = torch.rand((n, 6), generator=gen, device=device, dtype=torch.float64)
    ang = torch.deg2rad((2 * u[:, 0] - 1) * MAX_DEG)
    s = SCALE[0] + u[:, 1] * (SCALE[1] - SCALE[0])
    t = (SHIFT[0] + u[:, 2:4] * (SHIFT[1] - SHIFT[0])) * torch.where(u[:, 4:6] < 0.5, -1.0, 1.0)
    cos, sin = torch.cos(ang) * s, torch.sin(ang) * s
    a = torch.stack([torch.stack([cos, -sin], -1), torch.stack([sin, cos], -1)], -2)
    c = torch.tensor([(w - 1) / 2, (h - 1) / 2], device=device, dtype=torch.float64)
    off = c + t - a @ c
    return torch.cat([a, off[..., None]], -1)


def pairs(gen: torch.Generator, n: int, h: int, w: int, device) -> Dict[str, torch.Tensor]:
    """`n` independent pairs at h x w -> NHWC f32 image1, image2 (0..255
    integers), flow (n, h, w, 2), mask1, mask2 (n, h, w, 1, 0/255) and
    valid (n, h, w, ones), on `device`."""
    m = margin(h, w)
    s = affine(gen, n, h, w, device)
    plane = textured(gen, n, h + 2 * m, w + 2 * m, device)
    ys, xs = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float64),
                            torch.arange(w, device=device, dtype=torch.float64), indexing="ij")
    pts = torch.stack([xs, ys], -1).reshape(1, -1, 2)  # (1, h*w, 2)
    src = pts @ s[:, :, :2].transpose(1, 2) + s[:, None, :, 2] + m  # canvas (x, y)
    hc, wc = h + 2 * m, w + 2 * m
    grid = torch.stack([2 * src[..., 0] / (wc - 1) - 1, 2 * src[..., 1] / (hc - 1) - 1], -1)
    frame2 = F.grid_sample(plane, grid.view(n, h, w, 2).float(), mode="bilinear",
                           align_corners=True)
    frame1 = plane[:, :, m:m + h, m:m + w]
    rnd = lambda f: f.round().clamp(0, 255).permute(0, 2, 3, 1).contiguous()
    ainv = torch.linalg.inv(s[:, :, :2])
    inv_off = -(ainv @ s[:, :, 2:])[..., 0]
    flow = (pts @ ainv.transpose(1, 2) + inv_off[:, None] - pts).view(n, h, w, 2).float()
    masks = (torch.rand((2, n, h, w, 1), generator=gen, device=device)
             > 1 - KEYPOINT_SHARE).float() * 255
    return dict(image1=rnd(frame1), image2=rnd(frame2), flow=flow, mask1=masks[0],
                mask2=masks[1], valid=torch.ones((n, h, w), device=device))


def pool(gen: torch.Generator, n: int, h: int, w: int, device, chunk: int = 8):
    """`pairs` made `chunk` at a time (the canvases' memory bounded) and
    joined."""
    parts = [pairs(gen, min(chunk, n - i), h, w, device) for i in range(0, n, chunk)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
