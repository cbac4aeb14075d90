"""Sample splatting, the SBMC hot op.

Counterpart of ``wcmc_tpu/ops/splat.py``: each sample predicts a K x K
kernel that scatters its radiance into the image, and the result is
normalized by the total weight splatted to each pixel.  Built on the
differentiable ``kernel_scatter``: on the card kernel K7 forward and,
backward, K8 for the weights' gradient and K9 for the values' (only
when they require grad: the radiance of a train step is data); on the
CPU their plain versions.  The kernel is centred, so the full
``h + K - 1`` canvas is centre-cropped back to ``h x w``.  ``group``
is the reference's ``sample_axis_name``: the process group over which the
sample axis is sharded (forward only), whose ranks' numerator and
denominator sums are added and whose logit maxima are combined before the
normalization.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from wcmc_tpu_torch.ops.kernel_apply import kernel_scatter
from wcmc_tpu_torch.parallel.collectives import all_max, all_sum


def kernel_splat(x, weights, ksize: int):
    """Centred splat of per-position values: x (B, h, w, C) and
    non-negative weights (B, h, w, K*K) -> (B, h, w, C) accumulated
    contributions (un-normalized)."""
    r = ksize // 2
    full = kernel_scatter(x, weights, ksize)
    return full[:, r:r + x.shape[1], r:r + x.shape[2], :]


def splat_normalized(values, weights, ksize: int, eps: float = 1e-8, group=None):
    """``sum_s splat(v_s * w_s) / (sum_s splat(w_s) + eps)`` for values
    (B, S, h, w, C) and non-negative weights (B, S, h, w, K*K); returns
    (B, h, w, C).  The values and a ones channel go through one splat, so
    the K*K weight tensor is read once."""
    b, s, h, w, c = values.shape
    v = values.reshape(b * s, h, w, c)
    wt = weights.reshape(b * s, h, w, weights.shape[-1])
    ones = torch.ones((b * s, h, w, 1), dtype=values.dtype, device=values.device)
    acc = kernel_splat(torch.cat([v, ones], dim=-1), wt, ksize)
    acc = all_sum(acc.reshape(b, s, h, w, c + 1).sum(dim=1), group)
    return acc[..., :c] / (acc[..., c:] + eps)


def splat_normalized_logits(values, logits, ksize: int, eps: float = 1e-8, group=None):
    """Normalized splat with log-domain weights ``exp(logits)``, stabilized
    per output pixel: every contribution to pixel o is scaled by
    ``exp(-M[o])`` with ``M[o]`` the window max (over the K x K sources
    around o) of the per-source max logit, which cancels in the ratio and
    keeps the denominator near 1 so ``eps`` never dominates.  The shift is
    a constant of the gradient.

    values (B, S, h, w, C), logits (B, S, h, w, K*K) -> (B, h, w, C) f32.
    """
    b, s, h, w, _ = values.shape
    r = ksize // 2
    logits = logits.float()
    with torch.no_grad():
        lmax = all_max(logits.amax(dim=(1, 4)), group)                  # (B, h, w)
        # -inf implicit padding, as the reference's reduce_window init
        m = F.max_pool2d(lmax[:, None], ksize, stride=1, padding=r)
        # contribution (p, d) lands at o = p + d - r; edge values stand in
        # for contributions that fall outside the crop
        mpad = F.pad(m, (r, r, r, r), mode="replicate")[:, 0]
        shift = torch.stack([mpad[:, dy:dy + h, dx:dx + w]
                             for dy in range(ksize) for dx in range(ksize)], dim=-1)
    weights = torch.exp(logits - shift[:, None])
    return splat_normalized(values.float(), weights, ksize, eps=eps, group=group)
