"""Color-space transforms (channels-last) for FeatureMSE's ``color="hls"``.

Counterpart of ``rgb_to_hls`` and ``hls_cartesian`` in
``wcmc_tpu/ops/colors.py`` (kornia's convention: hue in radians).
"""

from __future__ import annotations

import math

import torch


def rgb_to_hls(img: torch.Tensor) -> torch.Tensor:
    """RGB -> HLS. ``img``: (..., 3) in [0, 1]. H in radians [0, 2pi)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    l = (maxc + minc) / 2.0
    delta = maxc - minc
    zero = delta == 0
    safe_delta = torch.where(zero, torch.ones_like(delta), delta)

    hr = torch.remainder((g - b) / safe_delta, 6.0)
    hg = (b - r) / safe_delta + 2.0
    hb = (r - g) / safe_delta + 4.0
    h = torch.where(maxc == r, hr, torch.where(maxc == g, hg, hb))
    h = torch.where(zero, torch.zeros_like(h), h) * (math.pi / 3.0)

    denom = 1.0 - torch.abs(2.0 * l - 1.0)
    safe_denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    s = torch.where(zero, torch.zeros_like(delta), delta / safe_denom)
    return torch.stack([h, l, s], dim=-1)


def hls_cartesian(img: torch.Tensor) -> torch.Tensor:
    """Cylindrical HLS -> the Cartesian coordinates FeatureMSE compares:
    (s cos h, 2 l, s sin h)."""
    h, l, s = img[..., 0], img[..., 1], img[..., 2]
    return torch.stack([s * torch.cos(h), 2.0 * l, s * torch.sin(h)], dim=-1)
