"""Flow and image codecs (numpy; cv2 and PIL imported where used).

The reference's formats:
- Middlebury `.flo` (magic 202021.25, little-endian f32, W then H then data)
- PFM (FlyingThings3D flow), with the vertical flip and the endian sign of
  the scale
- KITTI uint16 PNG flow: channels (u, v, valid), (value - 2^15) / 64; cv2
  reads and writes it (16-bit, BGR order)
- `read_image` (PIL) and `read_gen`, which dispatches by extension
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import numpy as np

_FLO_MAGIC = 202021.25


def _cv2():
    """cv2, which the KITTI flow PNG codec needs (16-bit PNGs in BGR)."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("the KITTI flow PNG codec needs OpenCV (the cv2 package), "
                          "which could not be imported") from e
    return cv2


def read_flo(path: str) -> Optional[np.ndarray]:
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != np.float32(_FLO_MAGIC):
            raise ValueError(f"{path}: invalid .flo magic {magic}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(path: str, flow: np.ndarray) -> None:
    assert flow.ndim == 3 and flow.shape[2] == 2
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.array([_FLO_MAGIC], np.float32).tofile(f)
        np.array([w], np.int32).tofile(f)
        np.array([h], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


def read_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"{path}: not a PFM file")
        dims = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if not dims:
            raise ValueError(f"{path}: malformed PFM header")
        w, h = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (h, w, 3) if color else (h, w)
    return np.flipud(data.reshape(shape))


def read_flow_kitti(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """KITTI optical flow PNG: 16-bit BGR -> (flow (H,W,2), valid (H,W))."""
    cv2 = _cv2()
    raw = cv2.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
    raw = raw[:, :, ::-1].astype(np.float32)  # BGR -> RGB = (u, v, valid)
    flow, valid = raw[:, :, :2], raw[:, :, 2]
    flow = (flow - 2**15) / 64.0
    return flow, valid


def write_flow_kitti(path: str, flow: np.ndarray) -> None:
    """(H, W, 2) flow -> a KITTI PNG with every pixel marked valid."""
    cv2 = _cv2()
    uv = 64.0 * flow + 2**15
    valid = np.ones([flow.shape[0], flow.shape[1], 1])
    out = np.concatenate([uv, valid], axis=-1).astype(np.uint16)
    cv2.imwrite(path, out[..., ::-1])


def read_image(path: str) -> np.ndarray:
    from PIL import Image

    return np.array(Image.open(path))


def read_gen(path: str):
    ext = os.path.splitext(path)[-1].lower()
    if ext in (".png", ".jpeg", ".ppm", ".jpg"):
        return read_image(path)
    if ext in (".bin", ".raw"):
        return np.load(path)
    if ext == ".flo":
        return read_flo(path).astype(np.float32)
    if ext == ".pfm":
        flow = read_pfm(path).astype(np.float32)
        return flow if flow.ndim == 2 else flow[:, :, :-1]
    raise ValueError(f"unsupported extension: {path}")
