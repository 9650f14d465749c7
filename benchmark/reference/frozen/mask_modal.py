"""Keypoint-mask modality preparation (NHWC).

Turns the raw single-channel 0/255 keypoint mask into the model's
conditioning input, per TRAIN.MASK_MODAL:

- 'point'     : repeat to `mask_channel` channels; mask2 <- all-255
- 'neighborE' : binary dilation with an ellipse structuring element
- 'neighborG' : Gaussian smear, renormalised to peak 255
- 'context'   : dilated mask gates image1; mask2 <- image2
- 'frame'     : mask <- image (unconditioned control)
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def ellipse_kernel(size: int) -> np.ndarray:
    """cv2.getStructuringElement(MORPH_ELLIPSE, (size, size)) without cv2:
    half-axes size//2, rows filled between the rounded edge points."""
    r = size // 2
    inv_r2 = 1.0 / (r * r) if r > 0 else 0.0
    kernel = np.zeros((size, size), np.float32)
    for i in range(size):
        dy = abs(i - r)
        if dy <= r:
            dx = int(round(r * np.sqrt(max(0.0, 1.0 - dy * dy * inv_r2))))
            kernel[i, max(0, r - dx):min(size, r + dx + 1)] = 1.0
    return kernel


@functools.lru_cache(maxsize=None)
def gaussian_kernel(kernel_size: int, sigma: float) -> np.ndarray:
    """Gaussian sampled on linspace(-3 sigma, 3 sigma, k), normalised to
    sum 1 (the reference `get_kernel`)."""
    s3 = 3.0 * sigma
    xs = np.linspace(-s3, s3, kernel_size)
    x, y = np.meshgrid(xs, xs)
    g = 1.0 / (2 * np.pi * sigma**2) * np.exp(-(x**2 + y**2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _depthwise_conv(x: torch.Tensor, kernel: np.ndarray,
                    padding: int) -> torch.Tensor:
    """Per-channel conv of NHWC `x` with one 2-D kernel, in f32."""
    c = x.shape[-1]
    k = torch.as_tensor(kernel, device=x.device)[None, None].repeat(c, 1, 1, 1)
    y = F.conv2d(x.float().permute(0, 3, 1, 2), k, padding=padding, groups=c)
    return y.permute(0, 2, 3, 1)


def _tile(m: torch.Tensor, channels: int) -> torch.Tensor:
    return m if m.shape[-1] == channels else m.repeat(1, 1, 1, channels)


def init_mask(image1, image2, mask1, mask2, *, mask_modal: str,
              mask_channel: int = 3, mask_dilate: int = 31,
              kernel_size: int = 31, kernel_sigma: float = 5.0,
              tile_channels: bool = True):
    """Prepare (mask1, mask2) conditioning inputs from raw 0/255 NHWC masks.
    `tile_channels=False` keeps the point and neighbour modalities at the
    raw mask's channels, for a consumer that folds the tiling into its
    first conv (the context and frame modalities are image-valued)."""
    if not tile_channels:
        mask_channel = mask1.shape[-1]
    if mask_modal == "point":
        mask1 = _tile(mask1, mask_channel)
        mask2 = torch.full_like(mask1, 255.0)
    elif mask_modal == "neighborE":
        d = mask_dilate
        dil = _depthwise_conv(mask1 / 255.0, ellipse_kernel(d), d // 2) > 0
        mask1 = _tile(dil.float() * 255.0, mask_channel)
        mask2 = torch.full_like(mask1, 255.0)
    elif mask_modal == "neighborG":
        g = gaussian_kernel(kernel_size, kernel_sigma)
        sm = _depthwise_conv(mask1, g, kernel_size // 2)
        mask1 = _tile(sm * 255.0 / torch.clamp(sm.max(), min=1e-12),
                      mask_channel)
        mask2 = torch.full_like(mask1, 255.0)
    elif mask_modal == "context":
        d = mask_dilate
        dil = _depthwise_conv(mask1 / 255.0, ellipse_kernel(d), d // 2) > 0
        mask1 = dil.to(image1.dtype) * image1
        mask2 = image2
    elif mask_modal == "frame":
        mask1, mask2 = image1, image2
    else:
        raise ValueError(f"Unknown mask modal: {mask_modal}")
    return mask1, mask2
