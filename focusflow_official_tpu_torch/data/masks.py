"""Keypoint detection and mask rasterization (an offline tool: CPU, cv2).

As the reference's mask generator: detect keypoints on the grayscale frame
and rasterize them into a 0/255 single-channel mask image.

- 'gf'   : cv2.goodFeaturesToTrack(img, 500, 0.01, 10)
- 'sift' : cv2.SIFT keypoints
- 'orb'  : cv2.ORB keypoints
- 'silk' : learned keypoints, made offline by the external SiLK library;
           `silk_from_scores` rasterizes its precomputed score maps.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _to_gray(image: np.ndarray) -> np.ndarray:
    import cv2

    if image.ndim == 3:
        return cv2.cvtColor(image, cv2.COLOR_RGB2GRAY)
    return image


def _rasterize(keypoints_xy: np.ndarray, shape) -> np.ndarray:
    mask = np.zeros(shape[:2], np.uint8)
    if len(keypoints_xy):
        xs = np.clip(np.round(keypoints_xy[:, 0]).astype(np.int64), 0, shape[1] - 1)
        ys = np.clip(np.round(keypoints_xy[:, 1]).astype(np.int64), 0, shape[0] - 1)
        mask[ys, xs] = 255
    return mask


def good_feature_mask(image: np.ndarray, max_corners=500, quality=0.01,
                      min_distance=10) -> np.ndarray:
    import cv2

    gray = _to_gray(image)
    pts = cv2.goodFeaturesToTrack(gray, max_corners, quality, min_distance)
    pts = pts.reshape(-1, 2) if pts is not None else np.zeros((0, 2))
    return _rasterize(pts, gray.shape)


def sift_mask(image: np.ndarray) -> np.ndarray:
    import cv2

    gray = _to_gray(image)
    kps = cv2.SIFT_create().detect(gray, None)
    pts = np.array([kp.pt for kp in kps]) if kps else np.zeros((0, 2))
    return _rasterize(pts, gray.shape)


def orb_mask(image: np.ndarray) -> np.ndarray:
    import cv2

    gray = _to_gray(image)
    kps = cv2.ORB_create().detect(gray, None)
    pts = np.array([kp.pt for kp in kps]) if kps else np.zeros((0, 2))
    return _rasterize(pts, gray.shape)


def silk_from_scores(score_map: np.ndarray, top_k: int = 500,
                     threshold: Optional[float] = None) -> np.ndarray:
    """Rasterize a SiLK-style dense keypoint score map to a 0/255 mask.

    The reference produces SiLK masks with the external library offline;
    this ingests its score output (H, W) and keeps the top_k (or
    thresholded) locations.
    """
    h, w = score_map.shape
    flat = score_map.ravel()
    if threshold is not None:
        keep = np.nonzero(flat >= threshold)[0]
    else:
        k = min(top_k, flat.size)
        keep = np.argpartition(-flat, k - 1)[:k]
    mask = np.zeros(h * w, np.uint8)
    mask[keep] = 255
    return mask.reshape(h, w)


MASK_CREATORS = {
    "gf": good_feature_mask,
    "sift": sift_mask,
    "orb": orb_mask,
}
