"""Feature preprocessing on tensors (any device).

Counterpart of ``wcmc_tpu/data/preprocess.py``: every transform is a
function of the raw ``(H, W, S, 104)`` sample dump, written with torch
ops so the whole pass runs on the card.  Constants (log scalings,
epsilons, the ``/19`` bounce normalization, the sqrt-roughness
linearization, the 1e10 clip) are the reference's, in float32.

All outputs are channels-last.
"""

from __future__ import annotations

import torch

from wcmc_tpu_torch.data import schema

FINITE_CAP = 1.0e38


def sanitize(x: torch.Tensor) -> torch.Tensor:
    """Zero non-finite samples; clamp finite values to ±1e38 (see the
    reference's ``sanitize`` for why corrupt samples are zeroed)."""
    x = torch.where(torch.isfinite(x), x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
    return x.clamp(-FINITE_CAP, FINITE_CAP)


def _rng(x, r):
    return x[..., r[0]:r[1]]


def preprocess_llpm(sample: torch.Tensor) -> torch.Tensor:
    """Raw ``(..., 104)`` samples -> 37-ch LLPM path descriptor.

    Column 0 is the log path weight (later split off as a pixel
    feature); columns 1: are the 36-ch PathNet input."""
    path_weight = torch.log(_rng(sample, schema.PATH_WEIGHT) + 1e-6) / 90.0
    rad_wo_w = torch.log(_rng(sample, schema.RADIANCE_WO_WEIGHT) + 1e-6) / 30.0
    light = torch.log(_rng(sample, schema.LIGHT_INTENSITY) + 1e-8) / 10.0
    throughputs = torch.log(_rng(sample, schema.THROUGHPUTS) + 1e-6) / 30.0
    bounce_types = _rng(sample, schema.BOUNCE_TYPES).clamp(0.0, 19.0) / 19.0
    roughnesses = torch.sqrt(_rng(sample, schema.ROUGHNESSES).clamp(0.0, 1.0))
    return torch.cat(
        [path_weight, rad_wo_w, light, throughputs, bounce_types, roughnesses],
        dim=-1,
    )


def preprocess_sbmc(sample: torch.Tensor):
    """Raw ``(..., 104)`` samples -> (27-ch sample buffer, 66-ch path
    buffer): [total, log total, log specular, subpixel, g-buffer] and
    [log probabilities, light directions, five bounce-type bits].  The
    linear radiance is clipped to [0, 1e10] so squared errors of capped
    outliers stay finite."""
    total = _rng(sample, schema.RADIANCE).clamp(0.0, 1e10)
    diffuse = _rng(sample, schema.DIFFUSE).clamp(0.0, 1e10)
    specular = torch.log1p((total - diffuse).clamp(min=0.0)) / 10.0
    subpixel = _rng(sample, schema.SUBPIXEL)
    g_buffer = sample[..., schema.ALBEDO_AT_FIRST[0]:schema.HAS_HIT[1]]
    probabilities = torch.log(_rng(sample, schema.PROBABILITIES).clamp(min=0.0) + 1e-5) / 30.0
    light_dirs = _rng(sample, schema.LIGHT_DIRECTIONS).clamp(-1.0, 1.0)
    bounce = _rng(sample, schema.BOUNCE_TYPES).to(torch.int32)
    # reflection, transmission, diffuse, glossy, specular
    bits = [((bounce & (1 << b)) != 0).to(sample.dtype) for b in range(5)]
    s_buffer = torch.cat(
        [total, torch.log1p(total) / 10.0, specular, subpixel, g_buffer], dim=-1)
    p_buffer = torch.cat([probabilities, light_dirs] + bits, dim=-1)
    return s_buffer, p_buffer


def _spatial_gradients(buf: torch.Tensor) -> torch.Tensor:
    """Forward-difference dx/dy with zero padding at the leading edge:
    ``(H, W, C)`` -> ``(H, W, 2C)`` = [dx, dy]."""
    dx = buf[:, 1:, :] - buf[:, :-1, :]
    dy = buf[1:, :, :] - buf[:-1, :, :]
    dx = torch.nn.functional.pad(dx, (0, 0, 1, 0))
    dy = torch.nn.functional.pad(dy, (0, 0, 0, 0, 1, 0))
    return torch.cat([dx, dy], dim=-1)


def preprocess_kpcn(sample: torch.Tensor) -> torch.Tensor:
    """Raw ``(H, W, S, 104)`` samples -> 44-ch KPCN pixel statistics.

    Albedo-factored diffuse, log specular, per-feature variances scaled
    by 1/spp, frame-normalized depth and forward-difference gradients.
    The samples are clipped to ±1e10 first so squared moments of capped
    outliers stay finite."""
    spp = sample.shape[2]
    eps = schema.ALBEDO_EPS
    sample = sample.clamp(-1e10, 1e10)

    def mean_var(x):
        return (x.mean(dim=2),
                x.var(dim=2, correction=0).mean(dim=2, keepdim=True) / spp)

    normal, normal_v = mean_var(_rng(sample, schema.NORMAL_AT_DIFF))

    depth_s = _rng(sample, schema.DEPTH_AT_DIFF)
    depth = depth_s.mean(dim=2)
    depth_v = depth_s.var(dim=2, correction=0)
    max_depth = depth.max()
    safe = torch.clamp(max_depth, min=1e-20)
    positive = max_depth > 0
    depth = torch.where(positive, depth / safe, depth)
    depth_v = torch.where(positive, depth_v / (safe * safe * spp), depth_v)
    depth = depth.clamp(0.0, 1.0)

    albedo_s = _rng(sample, schema.ALBEDO_AT_DIFF)
    albedo, albedo_v = mean_var(albedo_s)
    albedo_sqr = ((albedo + eps) ** 2).mean(dim=2, keepdim=True)

    diff_s = _rng(sample, schema.DIFFUSE).clamp(min=0.0)
    diffuse, diffuse_v = mean_var(diff_s)

    spec_s = (_rng(sample, schema.RADIANCE).clamp(min=0.0) - diff_s).clamp(min=0.0)
    specular, specular_v = mean_var(spec_s)
    specular_sqr = ((1.0 + specular) ** 2).mean(dim=2, keepdim=True)

    diffuse = diffuse / (albedo + eps)
    diffuse_v = diffuse_v / albedo_sqr
    specular = torch.log1p(specular)
    specular_v = specular_v / specular_sqr

    feats = []
    for f, v in (
        (diffuse, diffuse_v),
        (specular, specular_v),
        (normal, normal_v),
        (depth, depth_v),
        (albedo, albedo_v),
    ):
        feats += [f, v, _spatial_gradients(f)]
    return torch.cat(feats, dim=-1)


def kpcn_net_inputs(kpcn_buffer: torch.Tensor) -> dict:
    """Split the cached 44-ch KPCN buffer into model-input keys: the
    diffuse branch sees [diffuse stats | normal..albedo stats], the
    specular branch [specular stats | normal..albedo stats]."""
    return {
        "kpcn_diffuse_in": torch.cat(
            [kpcn_buffer[..., :10], kpcn_buffer[..., 20:]], dim=-1
        ),
        "kpcn_specular_in": kpcn_buffer[..., 10:],
        "kpcn_diffuse_buffer": kpcn_buffer[..., 0:3],
        "kpcn_specular_buffer": kpcn_buffer[..., 10:13],
        "kpcn_albedo": kpcn_buffer[..., 34:37] + schema.ALBEDO_EPS,
    }


def kpcn_targets(gt: torch.Tensor) -> dict:
    """GT ``(H, W, 9)`` -> albedo-factored diffuse / log specular
    targets."""
    total = _rng(gt, schema.GT_RADIANCE)
    diffuse = _rng(gt, schema.GT_DIFFUSE)
    albedo = _rng(gt, schema.GT_ALBEDO)
    return {
        "target_total": total,
        "target_diffuse": diffuse / (albedo + schema.ALBEDO_EPS),
        # clamp keeps log1p finite when MC noise makes diffuse > total
        "target_specular": torch.log1p((total - diffuse).clamp(min=-0.9999)),
    }


def sbmc_features(s_buffer, p_buffer=None, use_g_buf: bool = True,
                  use_sbmc_buf: bool = True) -> dict:
    """Cached SBMC buffers -> the sample-space keys {'radiance',
    'features'}: the g-buffer features (24 channels) or only the log
    total (3), then the path buffer when ``use_sbmc_buf``."""
    radiance = s_buffer[..., :3]
    feats = s_buffer[..., 3:27] if use_g_buf else s_buffer[..., 3:6]
    if use_sbmc_buf:
        if p_buffer is None:
            raise ValueError("use_sbmc_buf needs the path buffer")
        feats = torch.cat([feats, p_buffer], dim=-1)
    return {"radiance": radiance, "features": feats}


def kpcn_recombine(diffuse: torch.Tensor, specular: torch.Tensor,
                   albedo: torch.Tensor) -> torch.Tensor:
    """Invert the KPCN factorization: ``diffuse * albedo + exp(specular) -
    1``."""
    return diffuse * albedo + torch.expm1(specular)


def llpm_from_raw(sample: torch.Tensor, spp: int):
    """Raw ``(H, W, S, 104)`` dump -> (the pixel path-weight feature ``(H,
    W, 1)``, the 36-channel paths ``(H, W, spp, 36)``) of its first ``spp``
    samples."""
    buf = preprocess_llpm(sample[:, :, :spp, :])
    return buf[..., :1].mean(dim=2), buf[..., 1:]
