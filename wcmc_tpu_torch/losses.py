"""Training losses, incl. the path-disentangling (manifold) losses.

Counterpart of ``wcmc_tpu/losses.py``.  The reference draws the random
pairings of the manifold losses inside the loss from a ``jax.random``
key; here the draws are arguments, so a test can replay the reference's
draws and a train step can take them from an explicit
``torch.Generator`` (:func:`draw_pairings`, :meth:`ManifoldLoss.draw`):

* ``pairing="roll"``: a pair ``(shift1, shift2)`` of ints — a random
  cyclic shift, a block transpose whose divisor is fixed by the length,
  and a second cyclic shift;
* ``pairing="permutation"``: an index vector.

A loss takes ``draws = {"patch": ..., "batch": ...}``: one draw for the
intra-patch pairs (over S*H*W positions) and one for the intra-batch
pairs (over B*S*H*W).  The same draw shuffles the embedding and the
radiance.

Layouts: embedded paths ``p_buffer`` are ``(B, S, H, W, C)``, or
``(B, S, C, H, W)`` with ``cmajor``; reference radiance is
``(B, H, W, 3)``.
"""

from __future__ import annotations

import math

import torch

from wcmc_tpu_torch.ops.colors import hls_cartesian, rgb_to_hls
from wcmc_tpu_torch.utils.utils import tonemap_gamma

PAIRINGS = ("roll", "permutation")


# ---------------------------------------------------------------------------
# Reconstruction losses
# ---------------------------------------------------------------------------

def relative_mse(im: torch.Tensor, ref: torch.Tensor, eps: float = 1e-2):
    """0.5 * mean((x - y)^2 / (y^2 + eps))."""
    return 0.5 * torch.mean((im - ref) ** 2 / (ref**2 + eps))


def smape(im, ref, eps: float = 1e-2):
    """Symmetric mean absolute error; the denominator carries no
    gradient."""
    denom = eps + im.detach().abs() + ref.detach().abs()
    return torch.mean(torch.abs(im - ref) / denom)


def _reinhard(im):
    im = torch.maximum(im, im.new_zeros(()))
    return im / (1.0 + im)


def tonemapped_mse(im, ref, eps: float = 1e-2):
    del eps
    return 0.5 * torch.mean((_reinhard(im) - _reinhard(ref)) ** 2)


def tonemapped_relative_mse(im, ref, eps: float = 1e-2):
    im, ref = _reinhard(im), _reinhard(ref)
    return 0.5 * torch.mean((im - ref) ** 2 / (ref**2 + eps))


def l1(im, ref):
    return torch.mean(torch.abs(im - ref))


# ---------------------------------------------------------------------------
# Path-disentangling losses
# ---------------------------------------------------------------------------

def _block_divisor(n: int) -> int:
    return next((d for d in (8, 6, 4, 3, 2) if n % d == 0), 1)


def draw_pairings(generator: torch.Generator, n: int, pairing: str):
    """One pairing draw over ``n`` positions (see the module doc)."""
    if pairing == "permutation":
        return torch.randperm(n, generator=generator)
    if pairing != "roll":
        raise ValueError(f"pairing must be one of {PAIRINGS}, got {pairing!r}")
    shift1 = int(torch.randint(0, n, (), generator=generator))
    shift2 = int(torch.randint(1, max(n, 2), (), generator=generator))
    return shift1, shift2


def _shuffle(flat, draw, pairing: str, axis: int):
    n = flat.shape[axis]
    if pairing == "permutation":
        return torch.index_select(flat, axis, draw.to(flat.device))
    shift1, shift2 = draw
    flat = torch.roll(flat, int(shift1), dims=axis)
    d = _block_divisor(n)
    if d > 1:
        ax = axis % flat.dim()
        shp = flat.shape
        y = flat.reshape(shp[:ax] + (d, n // d) + shp[ax + 1:])
        flat = y.transpose(ax, ax + 1).reshape(shp)
    return torch.roll(flat, int(shift2), dims=axis)


def _pair_sq_dists(flat_a, shuffled, channel_axis: int):
    return 0.5 * torch.sum((flat_a - shuffled) ** 2, dim=channel_axis)


def _paired_displacement(p_flat, r_flat, draw, pairing, pos_axis=-2,
                         channel_axis=-1):
    """(embedding distance - radiance distance) over the drawn pairs."""
    p_shuf = _shuffle(p_flat, draw, pairing, pos_axis)
    r_shuf = _shuffle(r_flat, draw, pairing, pos_axis)
    return (_pair_sq_dists(p_flat, p_shuf, channel_axis)
            - _pair_sq_dists(r_flat, r_shuf, channel_axis))


def _patch_displacement(p_buffer, ref, draw, pairing, cmajor=False):
    """Pairs inside each batch element, one draw shared by all."""
    if cmajor:  # (B, S, C, H, W) -> (B, C, N)
        b, _, c = p_buffer.shape[:3]
        p_flat = p_buffer.transpose(1, 2).reshape(b, c, -1)
        r_flat = ref.transpose(1, 2).reshape(b, ref.shape[2], -1)
        return _paired_displacement(p_flat, r_flat, draw, pairing,
                                    pos_axis=-1, channel_axis=-2)
    b, c = p_buffer.shape[0], p_buffer.shape[-1]
    p_flat = p_buffer.reshape(b, -1, c)
    r_flat = ref.reshape(b, -1, ref.shape[-1])
    return _paired_displacement(p_flat, r_flat, draw, pairing)


def _batch_displacement(p_buffer, ref, draw, pairing, cmajor=False):
    """Pairs drawn across the whole batch."""
    if cmajor:  # (B, S, C, H, W) -> (C, B*S*H*W)
        c = p_buffer.shape[2]
        p_flat = p_buffer.permute(2, 0, 1, 3, 4).reshape(c, -1)
        r_flat = ref.permute(2, 0, 1, 3, 4).reshape(ref.shape[2], -1)
        return _paired_displacement(p_flat, r_flat, draw, pairing,
                                    pos_axis=-1, channel_axis=-2)
    c = p_buffer.shape[-1]
    p_flat = p_buffer.reshape(-1, c)
    r_flat = ref.reshape(-1, ref.shape[-1])
    return _paired_displacement(p_flat, r_flat, draw, pairing)


def _prep_pair(p_buffer, ref, color, cmajor=False):
    """Tonemap the radiance target and broadcast it over the sample
    axis, in the p-buffer's layout."""
    if color == "hls":
        ref = hls_cartesian(rgb_to_hls(tonemap_gamma(ref)))
        if cmajor:
            p = p_buffer.movedim(2, -1)
            p_buffer = hls_cartesian(rgb_to_hls(tonemap_gamma(p))).movedim(-1, 2)
        else:
            p_buffer = hls_cartesian(rgb_to_hls(tonemap_gamma(p_buffer)))
    else:
        ref = tonemap_gamma(ref)
    if cmajor:
        ref = ref.permute(0, 3, 1, 2)                 # (B, 3, H, W)
    s = p_buffer.shape[1]
    ref = ref[:, None].expand((ref.shape[0], s) + tuple(ref.shape[1:]))
    return p_buffer, ref


def positions(p_shape, cmajor: bool = False):
    """(positions per patch, positions per batch) of a p-buffer shape."""
    b, s = p_shape[0], p_shape[1]
    h, w = (p_shape[3], p_shape[4]) if cmajor else (p_shape[2], p_shape[3])
    return s * h * w, b * s * h * w


def feature_mse(p_buffer, ref, draws, color: str = "rgb",
                non_local: bool = True, pairing: str = "roll",
                cmajor: bool = False):
    """FeatureMSE: penalizes (d_embed - d_radiance)^2 over the drawn
    (sample, pixel) pairs, intra-patch plus (with ``non_local``)
    intra-batch."""
    p_buffer, ref = _prep_pair(p_buffer, ref, color, cmajor)
    disp_p = _patch_displacement(p_buffer, ref, draws["patch"], pairing, cmajor)
    loss_p = 0.5 * torch.mean(disp_p**2)
    if non_local:
        disp_b = _batch_displacement(p_buffer, ref, draws["batch"], pairing, cmajor)
        loss_b = 0.5 * torch.mean(disp_b**2)
    else:
        loss_b = loss_p
    return loss_p + loss_b


def global_relative_similarity(p_buffer, ref, draws, alpha: float = 2.0,
                               pairing: str = "roll", cmajor: bool = False):
    """GRS: logsumexp(alpha*[+-disp_p, +-disp_b, 0]) - log(1 + 4N),
    scaled by 1/sqrt(alpha)."""
    p_buffer, ref = _prep_pair(p_buffer, ref, "rgb", cmajor)
    n = p_buffer.numel() // p_buffer.shape[2 if cmajor else -1]
    disp_p = _patch_displacement(p_buffer, ref, draws["patch"], pairing,
                                 cmajor).reshape(-1)
    disp_b = _batch_displacement(p_buffer, ref, draws["batch"], pairing, cmajor)
    exponents = alpha * torch.cat(
        [disp_p, disp_b, -disp_p, -disp_b, disp_p.new_zeros(1)])
    out = torch.logsumexp(exponents, dim=0) - math.log(1 + 4 * n)
    return out / math.sqrt(alpha)


class ManifoldLoss:
    """A manifold loss with its pairing fixed: ``loss(p_buffer, ref,
    draws, cmajor=...)``, and ``loss.draw(generator, p_shape, cmajor)``
    for the draws that one call needs."""

    def __init__(self, fn, pairing: str, **kw):
        if pairing not in PAIRINGS:
            raise ValueError(f"pairing must be one of {PAIRINGS}, got {pairing!r}")
        self.fn, self.pairing, self.kw = fn, pairing, kw

    def draw(self, generator, p_shape, cmajor: bool = False):
        n_patch, n_batch = positions(p_shape, cmajor)
        return {"patch": draw_pairings(generator, n_patch, self.pairing),
                "batch": draw_pairings(generator, n_batch, self.pairing)}

    def __call__(self, p_buffer, ref, draws, cmajor: bool = False):
        return self.fn(p_buffer, ref, draws, pairing=self.pairing,
                       cmajor=cmajor, **self.kw)


def make_manifold_loss(name: str, non_local: bool = True,
                       pairing: str = "roll") -> ManifoldLoss:
    """Keyed by the CLI's --manif_loss flag values."""
    if name == "FMSE":
        return ManifoldLoss(feature_mse, pairing, non_local=non_local)
    if name == "GRS":
        return ManifoldLoss(global_relative_similarity, pairing)
    raise ValueError(f"manif_loss must be 'FMSE' or 'GRS', got {name!r}")
