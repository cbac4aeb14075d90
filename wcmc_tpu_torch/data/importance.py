"""Patch importance-sampling map, as separable 1-D convolutions on the
given device.

Counterpart of ``wcmc_tpu/data/importance.py``:

    importance = 0.3 * grad(luminance) + 0.2 * grad(normal) + 0.5 * material

with grad(x) = |sobel(gaussian(x, sigma=31))| normalized to [0, 1] and
material = (diffuse + 4 * glossy + 2 * specular) / 7.  The Gaussian
(sigma 31, truncate 4: radius 124) and the Sobel derivative run as 1-D
convolutions along each axis with scipy's border modes ('reflect' for
the blur, 'nearest' for Sobel).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from wcmc_tpu_torch.data import schema
from wcmc_tpu_torch.utils.utils import linear_to_srgb, tonemap_reinhard_lum

GAUSS_SIGMA = 31.0
GAUSS_TRUNCATE = 4.0


def _gaussian_kernel(sigma: float, truncate: float) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _conv1d(img: torch.Tensor, kernel: torch.Tensor, axis: int, mode: str) -> torch.Tensor:
    """Convolve a 2-D image along one axis with border padding.

    ``mode``: 'reflect' (scipy's, half-sample symmetric: the edge sample
    repeats) or 'nearest' (edge replicate)."""
    r = kernel.shape[0] // 2
    x = img.T if axis == 0 else img          # the convolved axis last
    n = x.shape[-1]
    idx = np.arange(-r, n + r)
    if mode == "reflect":
        # half-sample symmetric (numpy's 'symmetric'), period 2n
        idx = np.mod(idx, 2 * n)
        idx = np.where(idx >= n, 2 * n - 1 - idx, idx)
    elif mode == "nearest":
        idx = np.clip(idx, 0, n - 1)
    else:
        raise ValueError(f"unknown border mode {mode!r}")
    x = x[:, torch.from_numpy(idx).to(x.device)]
    # conv1d is a correlation: flip the kernel for a convolution
    out = F.conv1d(x[:, None, :], kernel.flip(0)[None, None, :].to(x))[:, 0, :]
    return out.T if axis == 0 else out


def _gaussian_blur(img: torch.Tensor) -> torch.Tensor:
    k = torch.from_numpy(_gaussian_kernel(GAUSS_SIGMA, GAUSS_TRUNCATE)).to(img.device)
    return _conv1d(_conv1d(img, k, 0, "reflect"), k, 1, "reflect")


def _sobel(img: torch.Tensor, axis: int) -> torch.Tensor:
    deriv = torch.tensor([-1.0, 0.0, 1.0], device=img.device)
    smooth = torch.tensor([1.0, 2.0, 1.0], device=img.device)
    if axis == 0:
        return _conv1d(_conv1d(img, deriv, 0, "nearest"), smooth, 1, "nearest")
    return _conv1d(_conv1d(img, deriv, 1, "nearest"), smooth, 0, "nearest")


def gradient_importance_map(img: torch.Tensor) -> torch.Tensor:
    """Normalized Gaussian-smoothed Sobel gradient magnitude of a
    (H, W[, C]) image, computed in float64 and returned in the image's
    dtype: the gradient of a sigma-31 blur is small against the blurred
    values, so f32 rounding in the blur grows about a hundredfold in it
    (the reference's f32 map lies ~1e-4 of its max from the f64 one)."""
    dtype = img.dtype
    img = img.double()
    if img.ndim == 2:
        img = img[..., None]
    acc = 0.0
    for c in range(img.shape[-1]):
        blurred = _gaussian_blur(img[..., c])
        acc = acc + _sobel(blurred, 0) ** 2 + _sobel(blurred, 1) ** 2
    mag = torch.sqrt(acc)
    return ((mag - mag.min()) / (mag.max() - mag.min() + 1e-5)).to(dtype)


@torch.inference_mode()
def importance_map(gt: torch.Tensor, sbmc_s: torch.Tensor, sbmc_p: torch.Tensor,
                   patch_size: int = schema.PATCH_SIZE) -> torch.Tensor:
    """The normalized patch-sampling probability map, on the inputs'
    device.

    Args:
      gt:      (H, W, 9) ground truth.
      sbmc_s:  (H, W, S, 27) SBMC sample buffer.
      sbmc_p:  (H, W, S, 66) SBMC path buffer.
    Returns:
      (H - patch_size, W - patch_size) f32 map summing to ~1.
    """
    gt_img = linear_to_srgb(tonemap_reinhard_lum(gt[..., :3], 1.5))
    diffuse = sbmc_p[..., schema.SBMC_P_IS_DIFFUSE[0]].mean(dim=2)
    glossy = sbmc_p[..., schema.SBMC_P_IS_GLOSSY[0]].mean(dim=2)
    specular = sbmc_p[..., schema.SBMC_P_IS_SPECULAR[0]].mean(dim=2)
    normal = sbmc_s[..., schema.SBMC_S_NORMAL[0]:schema.SBMC_S_NORMAL[1]].mean(dim=2)
    # normals are directions; clamp so capped sentinel values cannot
    # overflow the f32 gradient math
    normal = torch.clamp(normal * 0.5 + 0.5, 0.0, 1.0)

    lum = 0.2126 * gt_img[..., 0] + 0.7152 * gt_img[..., 1] + 0.0722 * gt_img[..., 2]
    prob = (0.3 * gradient_importance_map(lum)
            + 0.2 * gradient_importance_map(normal)
            + 0.5 * (diffuse + glossy * 4.0 + specular * 2.0) / 7.0)
    half = patch_size // 2
    prob = prob[half:-half, half:-half]
    return prob / (prob.sum() + 1e-5)
