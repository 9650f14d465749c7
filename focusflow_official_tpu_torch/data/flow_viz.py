"""Optical-flow visualization: Middlebury color wheel (numpy).

The standard colour coding of Baker et al., "A Database and Evaluation
Methodology for Optical Flow": a 55-colour RY/YG/GC/CB/BM/MR wheel,
uv -> RGB.
"""

from __future__ import annotations

import numpy as np


def make_colorwheel() -> np.ndarray:
    """(55, 3) uint-range color wheel with RY=15, YG=6, GC=4, CB=11, BM=13, MR=6."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0

    def ramp(n, up):
        r = np.floor(255 * np.arange(n) / n)
        return r if up else 255 - r

    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = ramp(RY, True)
    col += RY
    wheel[col : col + YG, 0] = ramp(YG, False)
    wheel[col : col + YG, 1] = 255
    col += YG
    wheel[col : col + GC, 1] = 255
    wheel[col : col + GC, 2] = ramp(GC, True)
    col += GC
    wheel[col : col + CB, 1] = ramp(CB, False)
    wheel[col : col + CB, 2] = 255
    col += CB
    wheel[col : col + BM, 2] = 255
    wheel[col : col + BM, 0] = ramp(BM, True)
    col += BM
    wheel[col : col + MR, 2] = ramp(MR, False)
    wheel[col : col + MR, 0] = 255
    return wheel


def flow_uv_to_colors(u: np.ndarray, v: np.ndarray, convert_to_bgr=False) -> np.ndarray:
    wheel = make_colorwheel()
    ncols = wheel.shape[0]
    flow_image = np.zeros((*u.shape, 3), np.uint8)

    rad = np.sqrt(u**2 + v**2)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = fk - k0

    for i in range(3):
        col0 = wheel[k0, i] / 255.0
        col1 = wheel[k1, i] / 255.0
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] = col[~idx] * 0.75  # out-of-range
        ch = 2 - i if convert_to_bgr else i
        flow_image[..., ch] = np.floor(255 * col)
    return flow_image


def flow_to_image(flow_uv: np.ndarray, clip_flow=None, convert_to_bgr=False) -> np.ndarray:
    """(H, W, 2) float flow -> (H, W, 3) uint8 RGB visualization."""
    assert flow_uv.ndim == 3 and flow_uv.shape[2] == 2
    if clip_flow is not None:
        flow_uv = np.clip(flow_uv, 0, clip_flow)
    u, v = flow_uv[..., 0], flow_uv[..., 1]
    rad = np.sqrt(u**2 + v**2)
    rad_max = np.max(rad)
    eps = 1e-5
    u = u / (rad_max + eps)
    v = v / (rad_max + eps)
    return flow_uv_to_colors(u, v, convert_to_bgr)
