"""A corpus of full preprocessed frames staged on the card, cut into fresh
patches there at every step.

Counterpart of ``wcmc_tpu/data/device_corpus.py``.  The frames are
uploaded once; each batch is then a crop of the staged frames, device
memory to device memory, so a convergence run draws new patches every
step without moving them from the host again.  Patch offsets are drawn on
the host, uniform or from per-scene importance maps, with the reference's
numpy draws (the same coordinates from the same ``np.random.Generator``).

Layout contract: every batch key is ``(N, [S,] H, W, C)`` with H, W at
axes -3 / -2, the dicts ``batches.kpcn_batch_from_raw`` and
``sbmc_batch_from_raw`` give.
"""

from __future__ import annotations

import numpy as np
import torch

from wcmc_tpu_torch.data.prefetch import host_tensor
from wcmc_tpu_torch.utils.utils import resolve_device


def _crop_frames(frames: dict, ids, ys, xs, patch: int) -> dict:
    """``len(ids)`` patches of the staged corpus, each a view of its frame
    stacked into one tensor a key.

    frames: dict of (N, [S,] H, W, C) tensors; ids / ys / xs: (B,) host
    integers, every crop inside its frame.  Returns a dict of (B, [S,]
    patch, patch, C) tensors on the frames' device."""
    return {k: torch.stack([v[i, ..., y:y + patch, x:x + patch, :]
                            for i, y, x in zip(ids, ys, xs)])
            for k, v in frames.items()}


class DeviceCorpus:
    """Full-frame corpus staged on a device; serves freshly cropped
    batches.

    ``frames``: per-scene batch dicts with a leading axis of 1 (full-frame
    versions of the training batch keys), as numpy arrays or as tensors.
    Tensors are concatenated where they lie (they were made, and cast,
    there) and moved to ``device``; numpy frames are concatenated on the
    host, cast there by ``cast(key, tensor)`` (so the upload moves the
    narrow dtype) and uploaded.  ``device``: the card unless given.
    ``importance``: optional per-scene numpy maps over the valid crop
    offsets; with them the offsets are importance-sampled instead of
    uniform."""

    def __init__(self, frames: list[dict], patch: int,
                 importance: list[np.ndarray] | None = None, cast=None, device=None):
        if not frames:
            raise ValueError("empty corpus")
        device = resolve_device(device)
        keys = frames[0].keys()
        self.patch = patch
        self.frames = {}
        on_device = isinstance(frames[0][next(iter(keys))], torch.Tensor)
        for k in keys:
            if on_device:
                self.frames[k] = torch.cat([f[k] for f in frames], dim=0).to(device)
                continue
            stacked = host_tensor(np.concatenate([np.asarray(f[k]) for f in frames], axis=0))
            if cast is not None:
                stacked = cast(k, stacked)
            self.frames[k] = stacked.to(device)
        some = next(iter(self.frames.values()))
        self.n = some.shape[0]
        self.h, self.w = some.shape[-3], some.shape[-2]
        self.max_y = self.h - patch
        self.max_x = self.w - patch
        self._cdfs = None
        if importance is not None:
            if len(importance) != self.n:
                raise ValueError(f"{len(importance)} importance maps for {self.n} scenes")
            self._cdfs = []
            for m in importance:
                m = np.asarray(m, np.float64)[: self.max_y + 1, : self.max_x + 1]
                flat = np.maximum(m, 0).ravel()
                tot = flat.sum()
                flat = np.full_like(flat, 1.0 / flat.size) if tot <= 0 else flat / tot
                self._cdfs.append(np.cumsum(flat))

    def nbytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self.frames.values())

    def sample_coords(self, rng: np.random.Generator, batch_size: int):
        """(3, B) int array of fresh (scene id, y, x) crop coordinates:
        ids uniform, offsets uniform or importance-sampled."""
        ids = rng.integers(0, self.n, size=batch_size)
        if self._cdfs is None:
            ys = rng.integers(0, self.max_y + 1, size=batch_size)
            xs = rng.integers(0, self.max_x + 1, size=batch_size)
        else:
            ys = np.empty(batch_size, np.int64)
            xs = np.empty(batch_size, np.int64)
            w = self.max_x + 1
            for j, i in enumerate(ids):
                u = rng.random()
                flat = int(np.searchsorted(self._cdfs[i], u))
                ys[j], xs[j] = divmod(flat, w)
        return np.stack([ids, ys, xs])

    def sample_batch(self, rng: np.random.Generator, batch_size: int):
        """Fresh random patches (see sample_coords)."""
        ids, ys, xs = self.sample_coords(rng, batch_size)
        return self.crop(ids, ys, xs)

    def crop(self, ids, ys, xs) -> dict:
        """The patches at (scene id, y, x); ValueError for a crop that is
        not inside its frame."""
        ids, ys, xs = (np.asarray(a, np.int64).reshape(-1) for a in (ids, ys, xs))
        if not len(ids) == len(ys) == len(xs):
            raise ValueError(f"{len(ids)} ids, {len(ys)} ys and {len(xs)} xs")
        if ((ids < 0) | (ids >= self.n) | (ys < 0) | (ys > self.max_y) | (xs < 0)
                | (xs > self.max_x)).any():
            raise ValueError(f"crops outside the corpus of {self.n} frames of "
                             f"{self.h}x{self.w}: ids {ids}, ys {ys}, xs {xs}")
        return _crop_frames(self.frames, ids.tolist(), ys.tolist(), xs.tolist(), self.patch)

    def grid_batches(self, batch_size: int, stride: int | None = None):
        """Deterministic grid of patches (for fixed validation sets), the
        ragged tail as a last, smaller batch."""
        stride = stride or self.patch
        coords = [
            (i, y, x)
            for i in range(self.n)
            for y in range(0, self.max_y + 1, stride)
            for x in range(0, self.max_x + 1, stride)
        ]
        n_full = len(coords) // batch_size * batch_size
        for c0 in range(0, n_full, batch_size):
            ids, ys, xs = zip(*coords[c0:c0 + batch_size])
            yield self.crop(np.array(ids), np.array(ys), np.array(xs))
        if n_full < len(coords):
            ids, ys, xs = zip(*coords[n_full:])
            yield self.crop(np.array(ids), np.array(ys), np.array(xs))
