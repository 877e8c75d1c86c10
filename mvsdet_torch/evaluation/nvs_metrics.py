"""Novel-view-synthesis metrics: PSNR / SSIM / depth RMSE.

A copy of mvsdet_tpu/evaluation/nvs_metrics.py, so the port imports nothing
of the JAX package.

Equivalents of the reference NVS evaluation
(mmdet3d/evaluation/metrics/Indoor_NVS.py + nerf_utils/
save_rendered_img.py:17-45).  The reference computes skimage
``structural_similarity(pred, target, channel_axis=-1, data_range=1)``
on float [0, 1] images (save_rendered_img.py:42-44), i.e. the skimage
DEFAULT algorithm: uniform 7x7 window, sample-covariance normalisation
n/(n-1), K1=0.01 / K2=0.03, per-channel mean SSIM averaged over
channels.  `ssim` below implements exactly that formula in numpy
(skimage itself is not a dependency), so committed SSIM numbers are
directly comparable to the reference's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def psnr(pred: np.ndarray, gt: np.ndarray, data_range: float = 1.0) -> float:
    """Peak signal-to-noise ratio (images in [0, data_range])."""
    mse = float(np.mean((np.asarray(pred, np.float64)
                         - np.asarray(gt, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))


def _uniform_valid(img: np.ndarray, size: int) -> np.ndarray:
    """Windowed mean over all fully-interior size x size windows.

    Equals scipy.ndimage.uniform_filter (skimage's filter) at the
    interior positions that survive skimage's `crop(S, pad)`, so the
    boundary mode never enters the result.
    """
    from scipy.signal import convolve2d

    k = np.full((size, size), 1.0 / (size * size))
    return convolve2d(img, k, mode="valid")


def ssim(pred: np.ndarray, gt: np.ndarray, data_range: float = 1.0,
         win_size: int = 7) -> float:
    """SSIM with skimage `structural_similarity` default semantics.

    Uniform `win_size` window, sample-covariance normalisation
    n/(n-1) with n = win_size**2, K1=0.01 / K2=0.03, mean over the
    interior (crop (win_size-1)//2) per channel, averaged over channels
    — the exact formula the reference evaluates with channel_axis=-1,
    data_range=1 on float images (ref: projects/NeRF-Det/nerfdet/
    nerf_utils/save_rendered_img.py:42-44).  Golden-tested against a
    re-typed skimage oracle in tests/test_evaluation.py (the JAX package's
    copy).
    """
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    if pred.ndim == 2:
        pred = pred[..., None]
        gt = gt[..., None]
    if min(pred.shape[0], pred.shape[1]) < win_size:
        raise ValueError(
            f"image {pred.shape[:2]} smaller than SSIM window {win_size}")
    n = win_size * win_size
    cov_norm = n / (n - 1.0)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    vals = []
    for c in range(pred.shape[-1]):
        x, y = pred[..., c], gt[..., c]
        ux = _uniform_valid(x, win_size)
        uy = _uniform_valid(y, win_size)
        vx = cov_norm * (_uniform_valid(x * x, win_size) - ux * ux)
        vy = cov_norm * (_uniform_valid(y * y, win_size) - uy * uy)
        vxy = cov_norm * (_uniform_valid(x * y, win_size) - ux * uy)
        a1 = 2 * ux * uy + c1
        a2 = 2 * vxy + c2
        b1 = ux**2 + uy**2 + c1
        b2 = vx + vy + c2
        vals.append(float(((a1 * a2) / (b1 * b2)).mean()))
    return float(np.mean(vals))


def depth_rmse(pred: np.ndarray, gt: np.ndarray,
               mask: Optional[np.ndarray] = None) -> float:
    """RMSE over valid (gt > 0) pixels (Indoor_NVS depth protocol)."""
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    if mask is None:
        mask = gt > 0
    if not np.any(mask):
        return 0.0
    return float(np.sqrt(np.mean((pred[mask] - gt[mask]) ** 2)))
