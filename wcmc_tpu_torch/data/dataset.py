"""Disk-backed data: the offline preprocessing cache.

Counterpart of ``wcmc_tpu/data/dataset.py`` for what full-frame serving
needs: the cache file names, the sanitizing loader, the extra-spp part
concatenation, and ``offline_preprocess`` for the test split (LLPM and
SBMC caches with their extra-spp parts, per-spp KPCN caches, GT
sanitizing).  The preprocessing runs on
the given device; the cache files are the reference's (same names,
shapes and float32 dtype), so either package reads the other's caches.

Directory layout: ``<root>/<mode>/gt/<scene>.npy`` and
``<root>/<mode>/input/<scene>.npy`` with extra-spp parts
``<scene>_1.npy`` ... appended on the sample axis.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from wcmc_tpu_torch.data import preprocess, schema
from wcmc_tpu_torch.utils.utils import resolve_device

PATCH_SIZE = schema.PATCH_SIZE


def _cache_name(in_fn: str, tag: str) -> str:
    base, ext = os.path.splitext(in_fn)
    return f"{base}_{tag}{ext}"


def _input_path(gt_fn: str) -> str:
    return gt_fn.replace(os.sep + "gt" + os.sep, os.sep + "input" + os.sep)


def _load_sanitized(fn: str, spp: int | None = None) -> np.ndarray:
    arr = np.load(fn, mmap_mode="r")
    if spp is not None:
        arr = arr[:, :, :spp, :]
    arr = np.asarray(arr, dtype=np.float32)
    # zero non-finite samples (see preprocess.sanitize)
    arr = np.where(np.isfinite(arr), arr, 0.0)
    return np.clip(arr, -preprocess.FINITE_CAP, preprocess.FINITE_CAP)


def load_all_spp(in_fn: str, spp: int) -> np.ndarray:
    """Concatenate ``<base>.npy, <base>_1.npy, ...`` on the sample axis
    until ``spp`` samples are available."""
    arr = _load_sanitized(in_fn)
    i = 0
    while arr.shape[2] < spp:
        i += 1
        part_fn = f"{os.path.splitext(in_fn)[0]}_{i}{os.path.splitext(in_fn)[1]}"
        if not os.path.isfile(part_fn):
            raise FileNotFoundError(
                f"{spp} spp not available: missing {part_fn}"
            )
        arr = np.concatenate([arr, _load_sanitized(part_fn)], axis=2)
    return arr[:, :, :spp, :]


def _on_device(fn, arr: np.ndarray, device):
    """Run one preprocessing transform on ``device``; numpy in and out
    (a tuple of arrays for a transform that returns a tuple)."""
    with torch.inference_mode():
        out = fn(torch.from_numpy(arr).to(device))
        if isinstance(out, tuple):
            return tuple(o.cpu().numpy() for o in out)
        return out.cpu().numpy()


def _write_caches(in_fn: str, suffix: str, load, jobs, overwrite: bool, device):
    """For each ``(tags, transform)`` job whose caches ``<base>_<tag><suffix>.npy``
    are not all there (or with ``overwrite``), run the transform on
    ``load()`` and save its outputs, in order, under those tags."""
    for tags, fn in jobs:
        names = [_cache_name(in_fn, tag + suffix) for tag in tags]
        if overwrite or not all(os.path.isfile(n) for n in names):
            out = _on_device(fn, load(), device)
            for name, buf in zip(names, out if isinstance(out, tuple) else (out,)):
                np.save(name, buf)


def offline_preprocess(
    gt_base_dir: str,
    mode: str = "test",
    spp: int = 8,
    llpm: bool = True,
    sbmc: bool = False,
    kpcn: bool = True,
    overwrite: bool = False,
    test_spps=(2, 4, 8, 16, 32, 64),
    verbose: bool = False,
    device=None,
):
    """One-time cache builder for the test split.

    Writes ``*_llpm.npy``, and with ``sbmc`` ``*_sbmc_s.npy`` and
    ``*_sbmc_p.npy`` (from the first ``spp`` samples), each extra-spp part
    ``<scene>_<i>.npy`` into ``*_llpm_<i>.npy`` (and ``*_sbmc_s_<i>.npy``,
    ``*_sbmc_p_<i>.npy``), ``*_kpcn_<spp>.npy`` for each of ``test_spps``
    the scene has samples for, and sanitizes the GT files in place.
    ``device`` is where the transforms run (the card unless given).

    The train/val caches need the importance map, which comes with the
    disk pipeline, and raise ``NotImplementedError`` until then.
    """
    if mode != "test":
        raise NotImplementedError(
            "train/val caches need the importance map, which is not ported yet"
        )
    device = resolve_device(device)
    jobs = ([(("llpm",), preprocess.preprocess_llpm)] if llpm else []) + (
        [(("sbmc_s", "sbmc_p"), preprocess.preprocess_sbmc)] if sbmc else [])

    gt_dir = os.path.join(gt_base_dir, mode, "gt")
    gt_files = sorted(
        os.path.join(gt_dir, f) for f in os.listdir(gt_dir)
        if f.endswith(".npy") and "_prob_imp" not in f
    )
    for gt_fn in gt_files:
        in_fn = _input_path(gt_fn)
        if verbose:
            print("[preprocess]", in_fn)

        def load_raw():
            raw = _load_sanitized(in_fn, spp)
            if raw.shape[-1] != schema.RAW_CHANNELS:
                raise ValueError(f"{in_fn} is not an OptaGen dump")
            return raw

        _write_caches(in_fn, "", functools.cache(load_raw), jobs, overwrite, device)
        # extra-spp parts get their own caches so FullImageDataset can
        # assemble arbitrary spp from cached buffers
        i = 0
        while True:
            i += 1
            part = f"{os.path.splitext(in_fn)[0]}_{i}.npy"
            if not os.path.isfile(part):
                break
            _write_caches(in_fn, f"_{i}", functools.cache(lambda p=part: _load_sanitized(p)),
                          jobs, overwrite, device)

        if kpcn:
            for s_ in test_spps:
                fn = _cache_name(in_fn, f"kpcn_{s_}")
                if not overwrite and os.path.isfile(fn):
                    continue
                try:
                    arr = load_all_spp(in_fn, s_)
                except FileNotFoundError:
                    continue  # scene doesn't have that many samples
                np.save(fn, _on_device(preprocess.preprocess_kpcn, arr, device))

        # sanitize GT in place
        np.save(gt_fn, _load_sanitized(gt_fn))
