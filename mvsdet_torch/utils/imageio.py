"""Minimal image writing: PNG (pure python) + depth colorisation.

The reference dumps rendered/GT/depth images at eval time through
cv2/matplotlib (nerf_utils/save_rendered_img.py:17-45,
mvsdet.py:976-982).  This repo's only image *decode* dependency is the
native C++ loader (data/_native), so writing goes through a
self-contained zlib PNG encoder — no cv2/PIL needed anywhere.

A copy of mvsdet_tpu/utils/imageio.py: the port imports nothing of the
JAX package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, img: np.ndarray) -> None:
    """Write (H, W) or (H, W, 3) uint8/float array as a PNG.

    Floats are assumed in [0, 1] and quantised.
    """
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    assert c in (1, 3), c
    color_type = 0 if c == 1 else 2

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def colorize_depth(depth: np.ndarray, d_min: float = None,
                   d_max: float = None) -> np.ndarray:
    """Depth (H, W) -> turbo-ish RGB uint8 (invalid <= 0 painted black)."""
    depth = np.asarray(depth, np.float64)
    valid = depth > 0
    if d_min is None:
        d_min = float(depth[valid].min()) if valid.any() else 0.0
    if d_max is None:
        d_max = float(depth[valid].max()) if valid.any() else 1.0
    t = np.clip((depth - d_min) / max(d_max - d_min, 1e-9), 0.0, 1.0)
    # compact 5-stop jet approximation
    r = np.clip(1.5 - np.abs(4 * t - 3.0), 0, 1)
    g = np.clip(1.5 - np.abs(4 * t - 2.0), 0, 1)
    b = np.clip(1.5 - np.abs(4 * t - 1.0), 0, 1)
    rgb = (np.stack([r, g, b], -1) * 255 + 0.5).astype(np.uint8)
    rgb[~valid] = 0
    return rgb
