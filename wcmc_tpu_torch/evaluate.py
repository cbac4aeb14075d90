"""Full-frame tiled inference + the 5x4 evaluation metric grid.

Counterpart of ``wcmc_tpu/evaluate.py``: overlap-tiled inference with
interior-crop assembly, the 28 px boundary crop, background/emitter
passthrough via ``has_hit``, and the {RelMSE, RelL1, DSSIM, L1, MSE} x
{linear, Reinhard, gamma 2.2, adaptive gamma 2.8} CSV grid.  Batches go
to the device from pinned host memory; the device runs ahead of the
host's assembly by a bounded window.  The upload stays synchronous: the
threaded ``DevicePrefetcher`` of the training loop made a served frame
slower on an H100 host (``PERF.md`` §5), since a frame is bound by
the host's tile stacking and a producer thread per frame only adds to it.
"""

from __future__ import annotations

import os
import time
import warnings

import numpy as np
import torch
from torch.profiler import record_function

from wcmc_tpu_torch import metrics as M
from wcmc_tpu_torch.data.full_image import FullImageDataset

VALID_SIZE = 72
PATCH_SIZE = 128


def tonemap(c, ref=None, k_inv_gamma=1.0 / 2.2):
    """Adaptive-luminance tonemap."""
    if ref is None:
        ref = c
    lum = 0.2126 * ref[..., 0] + 0.7152 * ref[..., 1] + 0.0722 * ref[..., 2]
    col = np.copy(c) / (1.0 + lum / 1.5)[..., None]
    col = np.clip(col, 0, None)
    return np.clip(col ** k_inv_gamma, 0.0, 1.0)


METRICS = [M.RelMSE, M.RelL1, M.SSIM, M.L1, M.MSE]
METRIC_NAMES = ["RelMSE", "RelL1", "DSSIM", "L1", "MSE"]
TMAPS = [
    lambda x: x,
    M.tonemap_simple,
    tonemap,
    lambda x: tonemap(x, k_inv_gamma=1.0 / 2.8),
]
TMAP_NAMES = ["linear", "reinhard", "gamma22", "gamma28"]


def _replicate_pad(tile: np.ndarray, target_h: int, target_w: int) -> np.ndarray:
    """Edge-replicate a (B, h, w, C) tile back to (B, th, tw, C)."""
    pad_h = target_h - tile.shape[1]
    pad_w = target_w - tile.shape[2]
    if pad_h == 0 and pad_w == 0:
        return tile
    return np.pad(
        tile,
        ((0, 0), (pad_h // 2, pad_h - pad_h // 2),
         (pad_w // 2, pad_w - pad_w // 2), (0, 0)),
        mode="edge",
    )


def _upload(batch: dict, device: torch.device) -> dict:
    """Host numpy batch -> device tensors, through pinned memory when
    the device is a card (the copies are asynchronous)."""
    if device.type != "cuda":
        return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    return {k: torch.from_numpy(v).pin_memory().to(device, non_blocking=True)
            for k, v in batch.items()}


def inference(interface, dataset: FullImageDataset, batch_size: int = 8):
    """Tiled full-frame inference with interior-crop assembly.

    Returns (out_rad (H, W, 3), out_path or None, elapsed_seconds):
    ``out_path`` is the assembled (S, H, W, C) p-buffer, a dict of them
    for KPCN's two branches."""
    interface.to_eval_mode()
    device = interface.device
    H, W = dataset.h, dataset.w
    out_rad = np.zeros((H, W, 3), np.float32)
    out_path = None
    use_paths = dataset.use_llpm_buf
    t0 = time.time()
    n = len(dataset)

    def assemble(idxs, out_dev, p_buffers):
        nonlocal out_path
        coords = [dataset[i][1] for i in idxs]
        out = _replicate_pad(out_dev.float().cpu().numpy(),
                             getattr(dataset, "tile_h", PATCH_SIZE),
                             getattr(dataset, "tile_w", PATCH_SIZE))
        pbs = None
        if use_paths:
            # KPCN: a dict of branches; the sample-space models: one array
            items = p_buffers.items() if isinstance(p_buffers, dict) else [(None, p_buffers)]
            pbs = {k: v.float().cpu().numpy() for k, v in items}
            if out_path is None:
                out_path = {k: np.zeros((v.shape[1], H, W, v.shape[-1]), np.float32)
                            for k, v in pbs.items()}
        for b, (i0, j0, i1, j1, i, j) in enumerate(coords):
            out_rad[i0:i1, j0:j1] = out[b, i0 - i:i1 - i, j0 - j:j1 - j]
            if use_paths:
                for k, pb in pbs.items():
                    out_path[k][:, i0:i1, j0:j1] = pb[b, :, i0 - i:i1 - i, j0 - j:j1 - j]

    # Dispatch ahead of assembly, but bound the in-flight window: each
    # pending entry holds device outputs (incl. per-sample p-buffers).
    # The record_function ranges name the host stages in a profiler
    # trace (chip_smoke.py reads them); they cost ~1 us when no profiler
    # is running.
    max_in_flight = 3
    pending: list = []
    for start in range(0, n, batch_size):
        idxs = list(range(start, min(start + batch_size, n)))
        with record_function("inference.stack"):
            tiles = [dataset[i][0] for i in idxs]
            host = {k: np.stack([t[k] for t in tiles]) for k in tiles[0]}
        with record_function("inference.upload"):
            batch = _upload(host, device)
        with record_function("inference.validate"):
            out_dev, p_dev = interface.validate_batch(batch)
        pending.append((idxs, out_dev, p_dev))
        if len(pending) > max_in_flight:
            with record_function("inference.assemble"):
                assemble(*pending.pop(0))
    with record_function("inference.assemble"):
        for entry in pending:
            assemble(*entry)
    # crop the assembled canvas back to the original frame (the dataset
    # may have auto-padded to the tile grid)
    oh = getattr(dataset, "orig_h", H)
    ow = getattr(dataset, "orig_w", W)
    out_rad = out_rad[:oh, :ow]
    if out_path is not None:
        out_path = {k: v[:, :oh, :ow] for k, v in out_path.items()}
        if None in out_path:
            out_path = out_path[None]
    return out_rad, out_path, time.time() - t0


def evaluate_frame(out_rad, tgt, ipt, has_hit):
    """Boundary crop + passthrough + full metric grid.

    Returns (results, results_input): {tmap}_{metric} -> float."""
    crop = (PATCH_SIZE - VALID_SIZE) // 2
    out_rad = out_rad[crop:-crop, crop:-crop]
    tgt = tgt[crop:-crop, crop:-crop]
    ipt = ipt[crop:-crop, crop:-crop]
    hh = has_hit[crop:-crop, crop:-crop]
    out_rad = np.where(hh == 0, ipt, out_rad)

    results, results_input = {}, {}
    for tname, tmap in zip(TMAP_NAMES, TMAPS):
        for mname, metric in zip(METRIC_NAMES, METRICS):
            results[f"{tname}_{mname}"] = float(metric(tmap(out_rad), tmap(tgt)))
            results_input[f"{tname}_{mname}"] = float(metric(tmap(ipt), tmap(tgt)))
    return results, results_input


def _clamp_pathological_tile(tile_h, tile_w):
    """Square tiles above 384 px on both sides become 256 x 256, with a
    warning, as the reference clamps them (its ``_clamp_pathological_tile``;
    for the models with paths the tile size changes the output, since the
    PathNet context is global to the tile).  Full-width bands
    (``tile_w >> tile_h``) and ``None`` pass through.
    ``WCMC_ALLOW_LARGE_TILES=1`` overrides the clamp."""
    if (tile_h or 0) > 384 and (tile_w or 0) > 384 and \
            not os.environ.get("WCMC_ALLOW_LARGE_TILES"):
        warnings.warn(
            f"tile {tile_h}x{tile_w} clamped to 256x256, as wcmc_tpu clamps large square "
            "tiles; set WCMC_ALLOW_LARGE_TILES=1 to override", stacklevel=3)
        return 256, 256
    return tile_h, tile_w


def denoise(
    interface,
    input_dir: str,
    base_model: str,
    scenes=None,
    spps=(8,),
    output_dir: str = "./eval_out",
    use_g_buf: bool = True,
    use_sbmc_buf: bool = True,
    use_llpm_buf: bool = False,
    pnet_out_size: int = 3,
    save_figures: bool = False,
    rhf: bool = False,
    feat_imp: bool = False,
    batch_size_fn=None,
    tile_h: int | None = None,
    tile_w: int | None = None,
):
    """Scene x spp evaluation sweep -> nested results dict + CSVs.

    ``tile_h``/``tile_w`` select the device tile size (see
    FullImageDataset).  KPCN without paths defaults to 256-px tiles (its
    assembled output is exactly the untiled forward either way); models
    with paths, and the sample-space models, keep 128, since the PathNet
    context is tile-global.  With
    ``rhf`` the first frame's p-buffer is saved and the sweep returns
    ``{}`` right away, as the reference does."""
    if tile_h is None and tile_w is None and base_model == "kpcn" \
            and not use_llpm_buf:
        tile_h = tile_w = 256
    tile_h, tile_w = _clamp_pathological_tile(tile_h, tile_w)
    if batch_size_fn is None:
        if (tile_h or PATCH_SIZE) * (tile_w or PATCH_SIZE) > 256 * 256:
            batch_size_fn = lambda spp: 1  # noqa: E731 — band tiles
        else:
            batch_size_fn = lambda spp: 8 if spp <= 32 else 4  # noqa: E731
    if not os.path.isdir(input_dir):
        raise FileNotFoundError(input_dir)
    gt_dir = input_dir.replace(os.sep + "input", os.sep + "gt")
    if scenes is None:
        scenes = sorted(
            f[:-4] for f in os.listdir(gt_dir)
            if f.endswith(".npy") and "_" not in f
        )
    os.makedirs(output_dir, exist_ok=True)

    all_results = {}
    for scene in scenes:
        scene = scene[:-4] if scene.endswith(".npy") else scene
        for spp in spps:
            ds = FullImageDataset(
                os.path.join(input_dir, scene + ".npy"), spp, base_model,
                use_g_buf, use_sbmc_buf, use_llpm_buf, pnet_out_size,
                feat_imp=feat_imp, tile_h=tile_h, tile_w=tile_w,
            )
            out_rad, out_path, dt = inference(interface, ds, batch_size_fn(spp))
            if rhf and out_path is not None:
                # p-buffer export for RHF-style visualization
                pb = out_path["diffuse"] if isinstance(out_path, dict) else out_path
                np.save(os.path.join(output_dir, f"p_buffer_{scene}_{spp}.npy"), pb)
                return {}
            oh, ow = ds.orig_h, ds.orig_w
            res, res_in = evaluate_frame(
                out_rad, ds.full_tgt[:oh, :ow], ds.full_ipt[:oh, :ow],
                ds.has_hit[:oh, :ow],
            )
            res["inference_sec"] = dt
            all_results[(scene, spp)] = {"output": res, "input": res_in}
            if save_figures:
                _save_figures(os.path.join(output_dir, scene), spp, out_rad,
                              ds.full_tgt[:oh, :ow], ds.full_ipt[:oh, :ow])

    _write_csv(os.path.join(output_dir, f"results_{spps[-1]}.csv"),
               all_results, "output")
    _write_csv(os.path.join(output_dir, f"results_input_{spps[-1]}.csv"),
               all_results, "input")
    return all_results


def _save_figures(sdir, spp, out_rad, tgt, ipt):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(sdir, exist_ok=True)
    crop = (PATCH_SIZE - VALID_SIZE) // 2
    err = M.RelMSE(out_rad[crop:-crop, crop:-crop], tgt[crop:-crop, crop:-crop],
                   reduce=False).reshape(tgt[crop:-crop, crop:-crop].shape)
    plt.imsave(os.path.join(sdir, "target.png"), TMAPS[-1](tgt))
    plt.imsave(os.path.join(sdir, f"input_{spp}.png"), TMAPS[-1](ipt))
    plt.imsave(os.path.join(sdir, f"output_{spp}.png"), TMAPS[-1](out_rad))
    plt.imsave(os.path.join(sdir, f"errmap_rmse_{spp}.png"),
               np.mean(np.clip(err**0.45, 0.0, 1.0), axis=2), cmap="magma")


def _write_csv(path, all_results, which):
    keys = sorted({k for v in all_results.values() for k in v[which]})
    with open(path, "w") as f:
        f.write("scene,spp," + ",".join(keys) + "\n")
        for (scene, spp), v in sorted(all_results.items()):
            row = [scene, str(spp)] + [
                f"{v[which].get(k, float('nan')):.6g}" for k in keys
            ]
            f.write(",".join(row) + "\n")
