"""Disk-backed data: the offline preprocessing cache and the patch
training sets.

Counterpart of ``wcmc_tpu/data/dataset.py``:

* ``offline_preprocess`` runs the preprocessing transforms (and, for the
  train/val splits, the importance map) on the given device and writes
  the reference's cache files (same names, shapes and float32 dtype:
  ``*_llpm.npy``, ``*_sbmc_s.npy``, ``*_sbmc_p.npy``,
  ``*_kpcn_<spp>.npy``, ``*_prob_imp.npy``), so either package reads the
  other's caches;
* ``DenoiseDataset`` serves channels-last numpy patch dicts with patches
  drawn proportionally to the cached probability map
  (``patches_per_image = (256 // bs) * bs`` random, or a 100-patch grid);
* ``MSDenoiseDataset`` concatenates the per-spp variants (spp 2..N);
* ``BatchLoader`` collates sequentially, ``ShuffleLoader`` shuffles
  across images with a threaded image prefetch.

The loaders are host numpy code: with the same seed and the same cache
files they yield the reference's batches bit for bit.  Their batches are
numpy dicts in the layout the interfaces take (``data/batches.py``);
``data/prefetch.py`` moves them to the device.

Directory layout: ``<root>/<mode>/gt/<scene>.npy`` and
``<root>/<mode>/input/<scene>.npy`` with extra-spp parts
``<scene>_1.npy`` ... appended on the sample axis.
"""

from __future__ import annotations

import functools
import os
from typing import Iterator

import numpy as np
import torch

from wcmc_tpu_torch.data import preprocess, schema
from wcmc_tpu_torch.parallel.mesh import shard_slice
from wcmc_tpu_torch.utils.utils import resolve_device

PATCH_SIZE = schema.PATCH_SIZE


def get_valid_path(path: str, fallback_roots=None) -> str:
    """Multi-root data failover: when ``path`` is missing, retry with
    each root in ``fallback_roots`` (default: the colon-separated
    ``WCMC_DATA_FALLBACKS``) in place of everything before the
    ``/<mode>/`` component."""
    if os.path.isfile(path):
        return path
    roots = fallback_roots
    if roots is None:
        env = os.environ.get("WCMC_DATA_FALLBACKS", "")
        roots = [r for r in env.split(":") if r]
    for root in roots:
        for mode in ("train", "val", "test"):
            marker = os.sep + mode + os.sep
            if marker in path:
                cand = os.path.join(root, path[path.index(marker) + 1:])
                if os.path.isfile(cand):
                    return cand
    raise FileNotFoundError(path)


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


def _serve_dtype(name: str) -> np.dtype:
    """The numpy dtype ``name``; "bfloat16" is ml_dtypes' (the dtype the
    reference serves), which this raises without."""
    if name != "bfloat16":
        return np.dtype(name)
    try:
        import ml_dtypes
    except ImportError as exc:
        raise RuntimeError("serving paths as bfloat16 needs the ml_dtypes package") from exc
    return np.dtype(ml_dtypes.bfloat16)


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
    """One-time cache pass over one split (``mode`` train, val or test).

    Writes ``*_llpm.npy`` (and each extra-spp part ``<scene>_<i>.npy``
    into ``*_llpm_<i>.npy``), with ``sbmc`` ``*_sbmc_s.npy`` and
    ``*_sbmc_p.npy`` from the first ``spp`` samples (the test split also
    per extra-spp part), ``*_kpcn_<s>.npy`` for each of ``test_spps``
    the scene has samples for (test) or for s in 2..``spp`` from the
    first s samples (train/val), sanitizes the GT files in place, and
    for train/val writes the patch importance map ``*_prob_imp.npy``
    (``data/importance.py``).  ``device`` is where the transforms run
    (the card unless given)."""
    if mode not in ("train", "val", "test"):
        raise ValueError(f"unknown split {mode!r}")
    device = resolve_device(device)
    test = mode == "test"
    llpm_jobs = [(("llpm",), preprocess.preprocess_llpm)] if llpm else []
    sbmc_jobs = [(("sbmc_s", "sbmc_p"), preprocess.preprocess_sbmc)] if sbmc else []

    gt_dir = os.path.join(gt_base_dir, mode, "gt")
    gt_files = sorted(
        os.path.join(gt_dir, f) for f in os.listdir(gt_dir)
        if f.endswith(".npy") and "_prob_imp" not in f
    )
    for gt_fn in gt_files:
        in_fn = _input_path(gt_fn)
        if verbose:
            print("[preprocess]", in_fn)

        @functools.cache
        def load_raw():
            raw = _load_sanitized(in_fn, spp)
            if raw.shape[-1] != schema.RAW_CHANNELS:
                raise ValueError(f"{in_fn} is not an OptaGen dump")
            return raw

        _write_caches(in_fn, "", load_raw, llpm_jobs + (sbmc_jobs if test else []),
                      overwrite, device)
        # extra-spp parts get their own caches so FullImageDataset can
        # assemble arbitrary spp from cached buffers (SBMC's on the test
        # split only)
        i = 0
        while True:
            i += 1
            part = f"{os.path.splitext(in_fn)[0]}_{i}.npy"
            if not os.path.isfile(part):
                break
            _write_caches(in_fn, f"_{i}", functools.cache(lambda p=part: _load_sanitized(p)),
                          llpm_jobs + (sbmc_jobs if test else []), overwrite, device)

        sbmc_bufs = None
        prob_fn = _cache_name(in_fn, "prob_imp")
        if not test:
            names = [_cache_name(in_fn, t) for t in ("sbmc_s", "sbmc_p")]
            save = sbmc and (overwrite or not all(os.path.isfile(n) for n in names))
            if save or overwrite or not os.path.isfile(prob_fn):
                with torch.inference_mode():
                    sbmc_bufs = preprocess.preprocess_sbmc(
                        torch.from_numpy(load_raw()).to(device))
                if save:
                    for name, buf in zip(names, sbmc_bufs):
                        np.save(name, buf.cpu().numpy())

        if kpcn:
            for s_ in (test_spps if test else range(2, spp + 1)):
                fn = _cache_name(in_fn, f"kpcn_{s_}")
                if not overwrite and os.path.isfile(fn):
                    continue
                try:
                    arr = load_all_spp(in_fn, s_) if test else load_raw()[:, :, :s_, :]
                except FileNotFoundError:
                    continue  # scene doesn't have that many samples
                np.save(fn, _on_device(preprocess.preprocess_kpcn, arr, device))

        # sanitize GT in place
        gt = _load_sanitized(gt_fn)
        np.save(gt_fn, gt)

        if sbmc_bufs is not None:
            from wcmc_tpu_torch.data.importance import importance_map

            prob = importance_map(torch.from_numpy(gt).to(device), *sbmc_bufs)
            np.save(prob_fn, prob.cpu().numpy())


class DenoiseDataset:
    """Map-style patch dataset over the preprocessed cache."""

    def __init__(
        self,
        gt_base_dir: str,
        spp: int,
        base_model: str = "sbmc",
        mode: str = "train",
        batch_size: int = 8,
        sampling: str = "random",
        use_g_buf: bool = True,
        use_sbmc_buf: bool = True,
        use_llpm_buf: bool = False,
        pnet_out_size: int = 3,
        seed: int = 0,
        patches_per_image: int | None = None,
        augment: bool = False,
        serve_paths_dtype: str | None = None,
    ):
        if base_model not in ("sbmc", "kpcn", "lbmc"):
            raise RuntimeError(f"Unknown baseline model {base_model}")
        if mode not in ("train", "val", "test"):
            raise RuntimeError(f"Unknown training mode {mode}")
        if sampling not in ("random", "grid"):
            raise RuntimeError(f"Unknown sampling mode {sampling}")
        if base_model == "lbmc":
            base_model, use_sbmc_buf, use_g_buf = "sbmc", False, True

        self.gt_dir = os.path.join(gt_base_dir, mode, "gt")
        self.gt_files = sorted(
            os.path.join(self.gt_dir, f) for f in os.listdir(self.gt_dir)
            if f.endswith(".npy")
        )
        self.spp = spp
        self.mode = mode
        self.sampling = sampling
        self.base_model = base_model
        self.use_g_buf = use_g_buf
        self.use_sbmc_buf = use_sbmc_buf and base_model == "sbmc"
        self.use_llpm_buf = use_llpm_buf
        self.channels = schema.ChannelConfig(
            base_model,
            use_g_buf=use_g_buf,
            use_sbmc_buf=self.use_sbmc_buf,
            use_llpm_buf=use_llpm_buf,
            pnet_out_size=pnet_out_size,
        )
        self._rng = np.random.default_rng(seed)
        self._rng.shuffle(self.gt_files)

        if patches_per_image is not None:
            self.patches_per_image = patches_per_image
        elif sampling == "random":
            self.patches_per_image = (256 // batch_size) * batch_size
        else:
            self.patches_per_image = 100
        self._cached_idx = None
        self._patches = None
        self._alias_samplers: dict = {}
        self.augment = augment
        # ``serve_paths_dtype="bfloat16"`` serves the LLPM 'paths' (most of
        # a batch's bytes) as ml_dtypes' bfloat16, halving host copies and
        # host-to-device bytes at the precision PathNet computes in
        self._paths_dtype = None
        if serve_paths_dtype:
            self._paths_dtype = _serve_dtype(serve_paths_dtype)

    # channel-size accessors matching the reference attribute names
    @property
    def dncnn_in_size(self):
        return self.channels.dncnn_in_size

    @property
    def pnet_in_size(self):
        return self.channels.pnet_in_size

    @property
    def pnet_out_size(self):
        return self.channels.pnet_out_size

    def __len__(self):
        return len(self.gt_files) * self.patches_per_image

    def _load_image(self, img_idx: int) -> dict:
        gt_fn = self.gt_files[img_idx]
        in_fn = _input_path(gt_fn)
        sample = {}

        if self.base_model == "sbmc":
            s_buf = np.load(_cache_name(in_fn, "sbmc_s"), mmap_mode="r")
            s_buf = np.asarray(s_buf[:, :, :self.spp, :])
            sample["radiance"] = s_buf[..., 0:3]
            feats = s_buf[..., 3:27] if self.use_g_buf else s_buf[..., 3:6]
            if self.use_sbmc_buf:
                p_buf = np.load(_cache_name(in_fn, "sbmc_p"), mmap_mode="r")
                feats = np.concatenate(
                    [feats, np.asarray(p_buf[:, :, :self.spp, :])], axis=-1
                )
            sample["features"] = feats
        else:  # kpcn
            buf = np.load(_cache_name(in_fn, f"kpcn_{self.spp}"))
            sample["kpcn_diffuse_in"] = np.concatenate(
                [buf[..., :10], buf[..., 20:]], axis=-1
            )
            sample["kpcn_specular_in"] = buf[..., 10:]
            sample["kpcn_diffuse_buffer"] = buf[..., 0:3]
            sample["kpcn_specular_buffer"] = buf[..., 10:13]
            sample["kpcn_albedo"] = buf[..., 34:37] + schema.ALBEDO_EPS

        if self.use_llpm_buf:
            llpm = np.load(_cache_name(in_fn, "llpm"), mmap_mode="r")
            llpm = np.asarray(llpm[:, :, :self.spp, :])
            pw = llpm[..., :1]
            if self.base_model == "sbmc":
                sample["features"] = np.concatenate(
                    [sample["features"], pw], axis=-1
                )
            else:
                sample["kpcn_diffuse_in"] = np.concatenate(
                    [sample["kpcn_diffuse_in"], pw.mean(axis=2)], axis=-1
                )
                sample["kpcn_specular_in"] = np.concatenate(
                    [sample["kpcn_specular_in"], pw.mean(axis=2)], axis=-1
                )
            paths = llpm[..., 1:]
            if self._paths_dtype is not None:
                # one amortized cast per image (~32 batches of serves
                # read/write half the bytes afterwards)
                paths = paths.astype(self._paths_dtype)
            sample["paths"] = paths

        gt = np.load(gt_fn)
        if self.base_model == "sbmc":
            sample["target_image"] = gt[..., 0:3]
        else:
            total, diffuse, albedo = gt[..., 0:3], gt[..., 3:6], gt[..., 6:9]
            sample["target_diffuse"] = diffuse / (albedo + schema.ALBEDO_EPS)
            sample["target_specular"] = np.log1p(np.maximum(total - diffuse, -0.9999))
            sample["target_total"] = total
        return sample, in_fn

    def _sample_coords(self, shape, prob: np.ndarray | None,
                       prob_key: str | None = None,
                       rng: np.random.Generator | None = None):
        h, w = shape
        n = self.patches_per_image
        if rng is None:
            rng = self._rng
        if self.sampling == "grid":
            coords = [
                (x, y)
                for x in range(0, h - PATCH_SIZE + 1, PATCH_SIZE)
                for y in range(0, w - PATCH_SIZE + 1, PATCH_SIZE)
            ]
            return (coords * (n // len(coords) + 1))[:n]
        if prob is not None:
            # O(1)-per-draw alias sampling (C++ when built; the
            # reference's np.random.choice is O(n) per draw). Cache the
            # O(n) alias-table build keyed by the cache FILENAME — the
            # array itself is freshly np.load-ed per _cut_patches call,
            # so id(prob) would never hit on an image revisit.
            from wcmc_tpu_torch.data.native_loader import AliasSampler

            ph, pw = prob.shape
            sampler = self._alias_samplers.get(prob_key)
            if sampler is None:
                sampler = AliasSampler(prob)
                if len(self._alias_samplers) >= 256:  # bound host memory
                    self._alias_samplers.clear()
                self._alias_samplers[prob_key] = sampler
            idx = sampler.sample(n, int(rng.integers(0, 2**63)))
            return [(int(i) // pw, int(i) % pw) for i in idx]
        xs = rng.integers(0, h - PATCH_SIZE + 1, n)
        ys = rng.integers(0, w - PATCH_SIZE + 1, n)
        return list(zip(xs.tolist(), ys.tolist()))

    def load_image_and_coords(self, img_idx: int,
                              rng: np.random.Generator | None = None):
        """Load one image dict plus its importance-sampled patch
        coordinates WITHOUT cutting any patches — the lazy half of the
        train loader.  Cutting 256 overlapping 128-px patches from a
        256-px image eagerly multiplies the image 64x (~6.3 GB per
        image with LLPM paths); patches are instead sliced per batch at
        serve time (``cut_patch``), so host memory holds images (~100 MB
        each), never patch inventories."""
        if rng is None:
            rng = self._rng
        sample, in_fn = self._load_image(img_idx)
        any_key = next(iter(sample))
        h, w = sample[any_key].shape[:2]
        prob = None
        prob_fn = None
        if self.sampling == "random":
            prob_fn = _cache_name(in_fn, "prob_imp")
            if os.path.isfile(prob_fn):
                prob = np.load(prob_fn)
        coords = self._sample_coords((h, w), prob, prob_key=prob_fn, rng=rng)
        return sample, coords

    def cut_patch(self, sample: dict, x: int, y: int,
                  rng: np.random.Generator | None = None) -> dict:
        """Slice one (x, y) patch out of a loaded image dict, in model
        layout; applies augmentation when the dataset has it on."""
        if self.augment:
            patch = {
                k: np.ascontiguousarray(v[x:x + PATCH_SIZE, y:y + PATCH_SIZE])
                for k, v in sample.items()
            }
            patch = self.random_rot(
                self.random_flip(patch, rng or self._rng), rng or self._rng
            )
            return self._to_model_layout(patch)
        # transpose-before-copy: one strided copy straight into model
        # layout (copying (H,W,S,C) first and transposing later costs a
        # second full copy at np.stack time — ~2x the serve bandwidth)
        out = {}
        for k, v in sample.items():
            p = v[x:x + PATCH_SIZE, y:y + PATCH_SIZE]
            if p.ndim == 4:
                p = np.transpose(p, (2, 0, 1, 3))
            out[k] = np.ascontiguousarray(p)
        return out

    def cut_patch_into(self, sample: dict, x: int, y: int,
                       out: dict, i: int) -> None:
        """Slice patch (x, y) directly into row ``i`` of a preallocated
        batch dict — ONE strided copy per key, no intermediate patch or
        np.stack pass. On a single-core host the serve path is pure
        memory bandwidth (~200 MB/batch with LLPM paths), so copy count
        is the loader's throughput."""
        for k, v in sample.items():
            p = v[x:x + PATCH_SIZE, y:y + PATCH_SIZE]
            if p.ndim == 4:
                p = np.transpose(p, (2, 0, 1, 3))
            np.copyto(out[k][i], p)

    def load_patches(self, img_idx: int,
                     rng: np.random.Generator | None = None) -> list:
        """Load one image and cut its patches; pure given ``rng`` (no
        dataset state mutated), so it is safe to call from loader
        worker threads (ShuffleLoader)."""
        if rng is None:
            rng = self._rng
        sample, in_fn = self._load_image(img_idx)
        any_key = next(iter(sample))
        h, w = sample[any_key].shape[:2]
        prob = None
        prob_fn = None
        if self.sampling == "random":
            prob_fn = _cache_name(in_fn, "prob_imp")
            if os.path.isfile(prob_fn):
                prob = np.load(prob_fn)
        coords = self._sample_coords((h, w), prob, prob_key=prob_fn, rng=rng)
        # threaded C++ gather with the sample-axis transpose fused
        # (numpy fallback inside when the native lib isn't built)
        from wcmc_tpu_torch.data.native_loader import extract_patches

        if self.augment:
            # augmentation needs (H, W, ...) layout; go patch by patch
            patches = []
            for x, y in coords:
                patch = {
                    k: np.ascontiguousarray(v[x:x + PATCH_SIZE, y:y + PATCH_SIZE])
                    for k, v in sample.items()
                }
                patch = self.random_rot(
                    self.random_flip(patch, rng), rng
                )
                patches.append(self._to_model_layout(patch))
            return patches
        # Each patch must OWN its memory: ShuffleLoader draws patches
        # uniformly from a cross-image buffer, so a single straggler
        # view would pin the whole (N, S, P, P, C) per-image gather —
        # ~6 GB/image with LLPM paths at spp 8 — until it is served
        # (observed: 130 GB RSS -> host OOM on the 33 GB disk corpus).
        # Copy key-by-key so only one image-sized array is live at a
        # time.
        patches: list = [{} for _ in coords]
        for k, v in sample.items():
            big = extract_patches(
                np.ascontiguousarray(v, np.float32), coords, PATCH_SIZE
            )
            for i in range(len(coords)):
                patches[i][k] = big[i].copy()
            del big
        return patches

    @staticmethod
    def random_flip(patch: dict, rng: np.random.Generator) -> dict:
        """Random horizontal/vertical flip of all spatial buffers.

        Defined-but-disabled augmentation, mirroring the reference
        (support/datasets.py:736-758; call commented out at 1142-1143).
        Enable via ``DenoiseDataset(..., augment=True)``.
        Operates on pre-transpose (H, W, ...) patches.
        """
        if rng.integers(0, 2):
            patch = {k: np.flip(v, axis=0).copy() for k, v in patch.items()}
        if rng.integers(0, 2):
            patch = {k: np.flip(v, axis=1).copy() for k, v in patch.items()}
        return patch

    @staticmethod
    def random_rot(patch: dict, rng: np.random.Generator) -> dict:
        """Random 90-degree rotation (reference support/datasets.py:718-734)."""
        k = int(rng.integers(0, 4))
        if k:
            patch = {
                k2: np.rot90(v, k, axes=(0, 1)).copy()
                for k2, v in patch.items()
            }
        return patch

    @staticmethod
    def _to_model_layout(patch: dict) -> dict:
        """(H, W, S, C) sample-space buffers -> (S, H, W, C); pixel
        buffers stay (H, W, C).  Channels-last throughout."""
        out = {}
        for k, v in patch.items():
            if v.ndim == 4:
                out[k] = np.transpose(v, (2, 0, 1, 3))
            else:
                out[k] = v
        return out

    def __getitem__(self, idx: int) -> dict:
        # lazy per-image cache: image dict + coords, patches sliced on
        # demand (sequential serving only needs the image and one slice
        # per access)
        img_idx = idx // self.patches_per_image
        pat_idx = idx % self.patches_per_image
        if self._cached_idx != img_idx or self._patches is None:
            self._patches = self.load_image_and_coords(img_idx)
            self._cached_idx = img_idx
        sample, coords = self._patches
        x, y = coords[pat_idx]
        return self.cut_patch(sample, x, y)

    def get_stats(self, keys=None, max_images: int | None = None):
        """Per-channel running mean/std/min/max over all images
        (reference support/datasets.py:912-1023).  Use for data
        standardization of custom datasets; do NOT standardize
        radiance/buffer/target channels.

        ``max_images`` caps the scan (evenly-strided subsample) — the
        full serial pass is fine for a 16-scene set but slow on a real
        corpus; channel statistics converge long before that."""
        if len(self.gt_files) == 0:
            raise RuntimeError("No data assigned for the DenoiseDataset")
        agg = {}
        n_pix = {}
        idxs = range(len(self.gt_files))
        if max_images is not None and max_images < len(self.gt_files):
            stride = len(self.gt_files) / max_images
            idxs = sorted({int(i * stride) for i in range(max_images)})
        for img_idx in idxs:
            sample, _ = self._load_image(img_idx)
            use = keys or list(sample)
            for k in use:
                v = np.asarray(sample[k], np.float64)
                flat = v.reshape(-1, v.shape[-1])
                a = agg.setdefault(
                    k,
                    {
                        "sum": 0.0, "sumsq": 0.0,
                        "min": np.full(v.shape[-1], np.inf),
                        "max": np.full(v.shape[-1], -np.inf),
                    },
                )
                a["sum"] = a["sum"] + flat.sum(axis=0)
                a["sumsq"] = a["sumsq"] + (flat**2).sum(axis=0)
                a["min"] = np.minimum(a["min"], flat.min(axis=0))
                a["max"] = np.maximum(a["max"], flat.max(axis=0))
                n_pix[k] = n_pix.get(k, 0) + flat.shape[0]
        stats = {}
        for k, a in agg.items():
            n = n_pix[k]
            mean = a["sum"] / n
            var = np.maximum(a["sumsq"] / n - mean**2, 0.0) * n / max(n - 1, 1)
            stats[k] = {
                "mean": mean.astype(np.float32),
                "std": np.sqrt(var).astype(np.float32),
                "min": a["min"].astype(np.float32),
                "max": a["max"].astype(np.float32),
            }
        return stats


class MSDenoiseDataset:
    """Multi-spp concatenation (spp 2..N; reference datasets.py:1149-1171)."""

    def __init__(self, root, spp, base_model="sbmc", mode="train",
                 batch_size=8, sampling="random", use_g_buf=True,
                 use_sbmc_buf=True, use_llpm_buf=False, pnet_out_size=3,
                 seed=0, patches_per_image=None, serve_paths_dtype=None):
        if spp < 2:
            raise RuntimeError(
                "spp too low to randomize sample count, should be at least 2."
            )
        self.datasets = [
            DenoiseDataset(root, s, base_model, mode, batch_size, sampling,
                           use_g_buf, use_sbmc_buf, use_llpm_buf,
                           pnet_out_size, seed + s, patches_per_image,
                           serve_paths_dtype=serve_paths_dtype)
            for s in range(2, spp + 1)
        ]
        self._lengths = [len(d) for d in self.datasets]
        self.dncnn_in_size = self.datasets[0].dncnn_in_size
        self.pnet_in_size = self.datasets[0].pnet_in_size
        self.pnet_out_size = self.datasets[0].pnet_out_size

    def __len__(self):
        return sum(self._lengths)

    def __getitem__(self, idx):
        for d, n in zip(self.datasets, self._lengths):
            if idx < n:
                return d[idx]
            idx -= n
        raise IndexError(idx)


class BatchLoader:
    """Minimal sequential batch collator (the reference uses a 1-worker
    torch DataLoader, train_kpcn.py:177-188).

    Multi-spp datasets serve examples whose sample axis differs between
    sub-datasets; a batch must therefore never mix shapes.  With the
    reference hyperparameters (patches_per_image a multiple of
    batch_size) boundaries align naturally; for other settings the
    loader starts a fresh batch at every shape change and drops the
    heterogeneous remainder.

    ``shard=(index, count)`` yields only shard ``index`` of each batch
    (``parallel.mesh.shard_slice``): a data-parallel rank stacks its own
    part of the global batch and nothing else.
    """

    def __init__(self, dataset, batch_size: int, drop_last: bool = True,
                 shard: tuple = (0, 1)):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.shard = shard

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    @staticmethod
    def _shapes(item):
        return tuple(sorted((k, v.shape) for k, v in item.items()))

    def _stack(self, items):
        items = items[shard_slice(len(items), *self.shard)]
        return {k: np.stack([it[k] for it in items], axis=0) for k in items[0]}

    def __iter__(self) -> Iterator[dict]:
        pending: list = []
        for i in range(len(self.dataset)):
            item = self.dataset[i]
            if pending and self._shapes(item) != self._shapes(pending[0]):
                if not self.drop_last:
                    # flush the partial batch at the shape boundary
                    yield self._stack(pending)
                pending = []
            pending.append(item)
            if len(pending) == self.batch_size:
                yield self._stack(pending)
                pending = []
        if pending and not self.drop_last:
            yield self._stack(pending)


class ShuffleLoader:
    """Cross-image shuffling batch loader with threaded image prefetch
    and LAZY patch cutting.

    Replaces :class:`BatchLoader` for training. Two weaknesses of the
    sequential loader (vs the reference's globally-shuffling torch
    DataLoader, reference train_kpcn.py:177-188):

    * patches were served consecutively per image, and the inter-image
      order was fixed per epoch — weaker shuffling than the reference's
      sampler;
    * a single thread alternated image loading (np.load + patch gather)
      with serving, so an accelerator stalls at every image boundary.

    Here images are visited in a fresh random order each epoch
    (``epoch`` is tracked internally per ``__iter__`` call), a
    ``workers``-thread pool prefetches the next IMAGES (dict + patch
    coordinates, no patches) while batches are served, and each served
    batch draws its patches across a window of ``window_images`` loaded
    images, slicing them out at serve time. Holding images instead of
    patch inventories is what bounds host memory: with 128-px patches
    at 256 per 256-px image, eager extraction inflates every image 64x
    (~6.3 GB with LLPM paths); lazy
    slicing keeps the window at ~window_images x image size.

    Deterministic given ``seed``: image order, per-image coordinates,
    and batch draws all come from seeded generators, and images are
    admitted to the window in submission order (never completion
    order), so thread scheduling cannot change what is served.

    ``shard=(index, count)`` cuts and yields only shard ``index`` of each
    batch (``parallel.mesh.shard_slice``): every data-parallel rank draws
    the global batch's patches from the same generators, so the ranks
    stay in step, and cuts its own.
    """

    def __init__(self, dataset, batch_size: int, window_images: int = 4,
                 workers: int = 2, seed: int = 0, drop_last: bool = True,
                 max_buffer_patches: int = 256, shard: tuple = (0, 1)):
        # image "units": MSDenoiseDataset contributes one unit per
        # (sub-dataset, image) so shuffling spans spp variants too —
        # like the reference's DataLoader over its ConcatDataset
        if hasattr(dataset, "datasets"):
            self._units = [
                (d, i)
                for d in dataset.datasets
                for i in range(len(d.gt_files))
            ]
        else:
            assert hasattr(dataset, "load_image_and_coords"), (
                "ShuffleLoader needs a DenoiseDataset-like dataset"
            )
            self._units = [
                (dataset, i) for i in range(len(dataset.gt_files))
            ]
        self.dataset = dataset
        self.batch_size = batch_size
        self.window_images = max(1, window_images)
        self.workers = max(1, workers)
        self.seed = seed
        self.drop_last = drop_last
        # bound host memory: llpm patches are ~19 MB each, so the
        # shuffle buffer must cap in PATCHES, not images
        self.max_buffer_patches = max_buffer_patches
        self.shard = shard
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    @staticmethod
    def _shape_key(item):
        return tuple(sorted((k, v.shape) for k, v in item.items()))

    def __iter__(self) -> Iterator[dict]:
        from concurrent.futures import ThreadPoolExecutor

        epoch = self._epoch
        self._epoch += 1
        n_images = len(self._units)
        order_rng = np.random.default_rng((self.seed, epoch))
        order = order_rng.permutation(n_images)
        draw_rng = np.random.default_rng((self.seed, epoch, 1))

        # window entries: one loaded image + its remaining coords,
        # keyed by patch shape (multi-spp datasets serve heterogeneous
        # sample axes; a batch must be homogeneous)
        class _Entry:
            __slots__ = ("ds", "sample", "coords", "rng", "key")

            def __init__(self, ds, sample, coords, rng):
                self.ds, self.sample, self.coords, self.rng = (
                    ds, sample, coords, rng)
                # probe shape without keeping the patch: sample-axis
                # dims identify the pool (S varies across sub-datasets)
                self.key = tuple(sorted(
                    (k, v.shape[2:]) for k, v in sample.items()))

        with ThreadPoolExecutor(self.workers) as ex:
            pending = []
            next_img = 0

            def submit_next():
                nonlocal next_img
                if next_img < n_images:
                    unit = int(order[next_img])
                    ds, img = self._units[unit]
                    rng = np.random.default_rng((self.seed, epoch, 2, unit))
                    pending.append(
                        (ds, rng, ex.submit(ds.load_image_and_coords,
                                            img, rng)))
                    next_img += 1

            def admit(window):
                ds, rng, fut = pending.pop(0)
                sample, coords = fut.result()
                coords = list(coords)
                draw_rng.shuffle(coords)
                window.append(_Entry(ds, sample, coords, rng))
                submit_next()

            def pop_batch(window, force=False):
                by_key: dict = {}
                for e in window:
                    by_key.setdefault(e.key, []).append(e)
                best = max(by_key.values(), default=None,
                           key=lambda es: sum(len(e.coords) for e in es))
                if best is None:
                    return None
                total = sum(len(e.coords) for e in best)
                if total < self.batch_size and (not force or self.drop_last):
                    return None
                take = min(self.batch_size, total)
                picks = []
                for _ in range(take):
                    # draw an image weighted by remaining coords, pop
                    # one of its (pre-shuffled) coordinates
                    counts = np.asarray([len(e.coords) for e in best])
                    pick = int(draw_rng.choice(len(best),
                                               p=counts / counts.sum()))
                    e = best[pick]
                    x, y = e.coords.pop()
                    picks.append((e, x, y))
                for e in [e for e in best if not e.coords]:
                    window.remove(e)
                mine = shard_slice(take, *self.shard)
                if any(p[0].ds.augment for p in picks):
                    # augment mutates per-entry rngs — keep it serial,
                    # and cut every pick so that each rank's rngs advance
                    # alike
                    items = [e.ds.cut_patch(e.sample, x, y, e.rng)
                             for e, x, y in picks][mine]
                    return {
                        k: np.stack([it[k] for it in items], axis=0)
                        for k in items[0]
                    }
                picks = picks[mine]
                take = len(picks)
                # preallocate the batch and cut straight into it: one
                # strided copy per patch, no intermediate + stack pass
                # (the first patch discovers the model-layout shapes)
                e0, x0, y0 = picks[0]
                first = e0.ds.cut_patch(e0.sample, x0, y0, e0.rng)
                out = {k: np.empty((take,) + v.shape, v.dtype)
                       for k, v in first.items()}
                for k, v in first.items():
                    out[k][0] = v
                for i, (e, x, y) in enumerate(picks[1:], 1):
                    e.ds.cut_patch_into(e.sample, x, y, out, i)
                return out

            for _ in range(self.window_images):
                submit_next()

            window: list = []
            while pending or window:
                # keep the window full while images remain (admission
                # happens in submission order — deterministic)
                while pending and len(window) < self.window_images:
                    admit(window)
                batch = pop_batch(window, force=not pending)
                if batch is not None:
                    yield batch
                elif pending:
                    admit(window)   # nothing servable yet: widen
                else:
                    break           # drained (drop_last leftovers)
