"""Synthetic OptaGen-layout render dumps for testing and benchmarking.

The real data producer (the OptaGen renderer) is out of scope for the
framework; tests and benchmarks instead generate structured random
buffers with the exact 104-channel per-sample layout asserted by the
data pipeline (reference support/datasets.py:620).  The generator puts
physically-plausible signal in each channel group (piecewise-constant
albedo regions, smooth normals/depth, lognormal radiance with spike
outliers) so that preprocessing transforms exercise their full range.
"""

from __future__ import annotations

import os

import numpy as np

from wcmc_tpu_torch.data import schema


def _smooth_field(rng, h, w, c, octaves=3, scale=1.0):
    """Cheap multi-octave value noise -> (h, w, c) float32 in [0, scale]."""
    out = np.zeros((h, w, c), np.float32)
    for o in range(octaves):
        gh = max(2, h >> (octaves - o)); gw = max(2, w >> (octaves - o))
        grid = rng.random((gh, gw, c), dtype=np.float32)
        ys = np.linspace(0, gh - 1, h)
        xs = np.linspace(0, gw - 1, w)
        y0 = np.floor(ys).astype(int); x0 = np.floor(xs).astype(int)
        y1 = np.minimum(y0 + 1, gh - 1); x1 = np.minimum(x0 + 1, gw - 1)
        fy = (ys - y0)[:, None, None]; fx = (xs - x0)[None, :, None]
        top = grid[y0][:, x0] * (1 - fx) + grid[y0][:, x1] * fx
        bot = grid[y1][:, x0] * (1 - fx) + grid[y1][:, x1] * fx
        out += (top * (1 - fy) + bot * fy) / (2 ** o)
    out /= sum(1.0 / 2 ** o for o in range(octaves))
    return out * scale


def synthetic_ground_truth(rng: np.random.Generator, h: int, w: int):
    """Clean ``(H, W, 9)`` ground truth: radiance, diffuse, albedo."""
    albedo = np.clip(_smooth_field(rng, h, w, 3, octaves=2), 0.05, 1.0)
    irradiance = _smooth_field(rng, h, w, 1, scale=2.0) + 0.1
    diffuse = albedo * irradiance
    specular = _smooth_field(rng, h, w, 3, scale=0.5) ** 2
    radiance = diffuse + specular
    return np.concatenate([radiance, diffuse, albedo], axis=-1).astype(np.float32)


def synthetic_raw_sample(
    rng: np.random.Generator,
    h: int,
    w: int,
    spp: int,
    gt: np.ndarray | None = None,
    nan_fraction: float = 0.0,
):
    """Noisy per-sample dump ``(H, W, S, 104)`` consistent with ``gt``."""
    if gt is None:
        gt = synthetic_ground_truth(rng, h, w)
    out = np.zeros((h, w, spp, schema.RAW_CHANNELS), np.float32)

    def put(r, x):
        out[..., r[0]:r[1]] = x

    gt_diffuse = gt[..., 3:6][:, :, None, :]
    gt_albedo = gt[..., 6:9][:, :, None, :]
    gt_specular = (gt[..., 0:3] - gt[..., 3:6])[:, :, None, :]

    # Per-sample MC noise: lognormal multiplicative + occasional fireflies.
    noise = rng.lognormal(0.0, 0.6, (h, w, spp, 3)).astype(np.float32)
    firefly = (rng.random((h, w, spp, 1)) < 0.002) * rng.exponential(
        20.0, (h, w, spp, 1)
    )
    diffuse_s = gt_diffuse * noise + firefly.astype(np.float32)
    spec_noise = rng.lognormal(0.0, 1.0, (h, w, spp, 3)).astype(np.float32)
    specular_s = np.maximum(gt_specular, 0) * spec_noise
    put(schema.RADIANCE, diffuse_s + specular_s)
    put(schema.DIFFUSE, diffuse_s)

    put(schema.SUBPIXEL, rng.random((h, w, spp, 2), dtype=np.float32))
    jitter = 0.05 * rng.standard_normal((h, w, spp, 3)).astype(np.float32)
    put(schema.ALBEDO_AT_FIRST, np.clip(gt_albedo + jitter, 0, 1))
    put(schema.ALBEDO, np.clip(gt_albedo + jitter, 0, 1))
    put(schema.ALBEDO_AT_DIFF, np.clip(gt_albedo + jitter, 0, 1))

    normal = _smooth_field(rng, h, w, 3, scale=2.0) - 1.0
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True) + 1e-6
    nrm = normal[:, :, None, :] + 0.02 * rng.standard_normal(
        (h, w, spp, 3)
    ).astype(np.float32)
    put(schema.NORMAL_AT_FIRST, nrm)
    put(schema.NORMAL, nrm)
    put(schema.NORMAL_AT_DIFF, nrm)

    depth = _smooth_field(rng, h, w, 1, scale=10.0)
    dep = depth[:, :, None, :] * (
        1.0 + 0.01 * rng.standard_normal((h, w, spp, 1)).astype(np.float32)
    )
    put(schema.DEPTH_AT_FIRST, dep)
    put(schema.DEPTH, dep)
    put(schema.DEPTH_AT_DIFF, dep)
    put(schema.VISIBILITY, (rng.random((h, w, spp, 1)) > 0.3).astype(np.float32))

    # ~3% of pixels miss all geometry (background / emitters): bounce type 0.
    has_hit = (rng.random((h, w, 1, 1)) > 0.03).astype(np.float32)
    put(schema.HAS_HIT, np.broadcast_to(has_hit, (h, w, spp, 1)))
    put(
        schema.PROBABILITIES,
        rng.exponential(1.0, (h, w, spp, 4 * schema.N_BOUNCES)).astype(np.float32),
    )
    put(
        schema.LIGHT_DIRECTIONS,
        rng.uniform(-1.2, 1.2, (h, w, spp, 2 * schema.N_BOUNCES)).astype(np.float32),
    )
    bt = rng.integers(1, 20, (h, w, spp, schema.N_BOUNCES)).astype(np.float32)
    put(schema.BOUNCE_TYPES, bt * has_hit)

    put(schema.PATH_WEIGHT, rng.exponential(1.0, (h, w, spp, 1)).astype(np.float32))
    put(
        schema.RADIANCE_WO_WEIGHT,
        rng.exponential(0.5, (h, w, spp, 3)).astype(np.float32),
    )
    put(
        schema.LIGHT_INTENSITY,
        rng.exponential(10.0, (h, w, spp, 3)).astype(np.float32),
    )
    put(
        schema.THROUGHPUTS,
        rng.random((h, w, spp, 3 * schema.N_BOUNCES), dtype=np.float32),
    )
    put(
        schema.ROUGHNESSES,
        rng.random((h, w, spp, schema.N_BOUNCES), dtype=np.float32),
    )

    if nan_fraction > 0:
        mask = rng.random(out.shape) < nan_fraction
        out[mask] = np.nan
    return out, gt


def build_synthetic_dataset(root, n_train=2, n_val=1, n_test=1, size=256,
                            spp=8, test_extra_parts=1, seed=0,
                            nan_fraction=1e-5):
    """Write ``<root>/{train,val,test}/{gt,input}/<scene>.npy`` plus the
    extra-spp part files ``<scene>_1.npy`` ... of test scenes.

    Same tree, file names and draw order as the reference's
    ``scripts/make_synthetic_dataset.py::build``, so one seed gives the
    same bytes from either package."""
    rng = np.random.default_rng(seed)
    for mode, count in (("train", n_train), ("val", n_val), ("test", n_test)):
        gt_dir = os.path.join(root, mode, "gt")
        in_dir = os.path.join(root, mode, "input")
        os.makedirs(gt_dir, exist_ok=True)
        os.makedirs(in_dir, exist_ok=True)
        for i in range(count):
            scene = f"scene{i}"
            gt = synthetic_ground_truth(rng, size, size)
            raw, _ = synthetic_raw_sample(rng, size, size, spp, gt=gt,
                                          nan_fraction=nan_fraction)
            np.save(os.path.join(gt_dir, scene + ".npy"), gt)
            np.save(os.path.join(in_dir, scene + ".npy"), raw)
            if mode == "test":
                for p in range(1, test_extra_parts + 1):
                    extra, _ = synthetic_raw_sample(rng, size, size, spp, gt=gt)
                    np.save(os.path.join(in_dir, f"{scene}_{p}.npy"), extra)
