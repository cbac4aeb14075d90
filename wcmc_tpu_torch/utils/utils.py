"""Small shared helpers: channels-last crops, device selection, the
FeatureMSE tonemap and the display transforms the importance map uses."""

from __future__ import annotations

import torch


def crop_like(src, tgt):
    """Center-crop ``src`` spatially to match ``tgt``.

    Spatial dims are the two axes *before* the channel axis
    (channels-last layout: ``(..., H, W, C)``); the top/left margin is
    ``d // 2``, as in the reference."""
    sh, sw = src.shape[-3], src.shape[-2]
    th, tw = tgt.shape[-3], tgt.shape[-2]
    dh, dw = sh - th, sw - tw
    if dh == 0 and dw == 0:
        return src
    if dh < 0 or dw < 0:
        raise ValueError(f"crop_like: src {tuple(src.shape)} smaller than "
                         f"tgt {tuple(tgt.shape)}")
    top, left = dh // 2, dw // 2
    return src[..., top:sh - (dh - top), left:sw - (dw - left), :]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    names another device.  Without a card and without an explicit
    device this raises — the port never falls back to the CPU
    silently."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or "
            "--device cpu) to run on the CPU"
        )
    return torch.device("cuda")


def tonemap_gamma(img):
    """FeatureMSE's radiance transform: Reinhard then gamma 2.2
    (0.454545 = 1/2.2).  The clamp at zero splits its gradient at a tie
    as ``jnp.maximum`` does."""
    img = torch.maximum(img, img.new_zeros(()))
    return (img / (1.0 + img)) ** 0.454545


def _luminance(c):
    return 0.2126 * c[..., 0:1] + 0.7152 * c[..., 1:2] + 0.0722 * c[..., 2:3]


def tonemap_reinhard_lum(c, limit: float = 1.5):
    """Luminance-normalized Reinhard: ``c / (1 + lum(c) / limit)``."""
    return c / (1.0 + _luminance(c) / limit)


def linear_to_srgb(c, gamma: float = 2.2):
    """``max(c, 0) ** (1 / gamma)`` clipped to [0, 1]."""
    return torch.clamp(torch.clamp(c, min=0.0) ** (1.0 / gamma), 0.0, 1.0)
