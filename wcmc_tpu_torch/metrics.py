"""Evaluation metrics (numpy, host-side).

Counterpart of reference support/metrics.py.  SSIM is implemented
natively (scikit-image is not a dependency) but reproduces
``skimage.metrics.structural_similarity`` semantics at the reference
call site (multichannel, win_size=7, uniform window, sample
covariance, and the legacy float ``data_range=2.0`` default the
reference implicitly used at support/metrics.py:94).
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import uniform_filter

__all__ = ["MSE", "RelMSE", "TRelMSE", "L1", "RelL1", "SSIM", "tonemap_simple"]


def tonemap_simple(im):
    col = np.clip(np.copy(im), 0.0, None)
    return col / (1.0 + col)


def MSE(im, ref, reduce=True):
    return np.square(im - ref).mean() if reduce else np.square(im - ref)


def RelMSE(im, ref, eps=1e-4, reduce=True):
    """Relative MSE with NaN dropping (the headline quality metric,
    reference support/metrics.py:41-53)."""
    diff = np.square(im - ref) / (np.square(ref) + eps)
    diff = np.ravel(diff)
    diff = diff[~np.isnan(diff)]
    return diff.mean() if reduce else diff


def TRelMSE(im, ref, eps=1e-4, reduce=True):
    return RelMSE(tonemap_simple(im), tonemap_simple(ref), eps, reduce)


def L1(im, ref, reduce=True):
    return np.abs(im - ref).mean() if reduce else np.abs(im - ref)


def RelL1(im, ref, eps=1e-4, reduce=True):
    diff = np.abs(im - ref) / (np.abs(ref) + eps)
    return diff.mean() if reduce else diff


def _ssim_single(im, ref, data_range, win_size, k1, k2):
    nd = im.ndim
    cov_norm = win_size**nd / (win_size**nd - 1)  # sample covariance

    def f(x):
        return uniform_filter(x, size=win_size)

    ux, uy = f(im), f(ref)
    uxx, uyy, uxy = f(im * im), f(ref * ref), f(im * ref)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux**2 + uy**2 + c1) * (vx + vy + c2)
    )
    pad = (win_size - 1) // 2
    interior = s[tuple(slice(pad, d - pad) for d in s.shape)]
    return interior.mean(), s


def structural_similarity(
    im,
    ref,
    data_range: float | None = None,
    win_size: int = 7,
    k1: float = 0.01,
    k2: float = 0.03,
    full: bool = False,
):
    """Mean SSIM over channels of an (H, W[, C]) float image pair."""
    im = np.asarray(im, np.float64)
    ref = np.asarray(ref, np.float64)
    if data_range is None:
        data_range = 2.0  # legacy skimage default for float inputs
    if im.ndim == 3:
        vals, maps = zip(
            *(
                _ssim_single(im[..., c], ref[..., c], data_range, win_size, k1, k2)
                for c in range(im.shape[-1])
            )
        )
        mean = float(np.mean(vals))
        smap = np.stack(maps, axis=-1)
    else:
        mean, smap = _ssim_single(im, ref, data_range, win_size, k1, k2)
        mean = float(mean)
    return (mean, smap) if full else mean


def SSIM(im, ref, reduce=True):
    """Structural dissimilarity 1 - SSIM (reference support/metrics.py:86-94)."""
    out = structural_similarity(im, ref, full=(not reduce))
    if reduce:
        return 1.0 - out
    mean, smap = out
    return 1.0 - mean, 1.0 - smap
