"""ctypes bindings for the native data-pipeline library (the port's copy of
``wcmc_tpu/data/native_loader.py``; host code, no JAX).

Build with ``make -C native`` (produces ``native/libwcmc_native.so``).
Every entry point has a NumPy fallback so the framework runs without
the native build; when present, patch extraction + importance sampling
run multithreaded in C++.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "native",
        "libwcmc_native.so",
    )
    if not os.path.isfile(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    c_f32p = ctypes.POINTER(ctypes.c_float)
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    lib.wn_extract_patches.argtypes = [
        c_f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, c_i32p, ctypes.c_int64, ctypes.c_int64, c_f32p,
        ctypes.c_int,
    ]
    lib.wn_alias_build.restype = ctypes.c_void_p
    lib.wn_alias_build.argtypes = [c_f32p, ctypes.c_int64]
    lib.wn_alias_sample.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64, c_i32p,
    ]
    lib.wn_alias_free.argtypes = [ctypes.c_void_p]
    lib.wn_sanitize.argtypes = [
        c_f32p, ctypes.c_int64, ctypes.c_float, ctypes.c_int,
    ]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _lib() is not None


_N_THREADS = min(8, os.cpu_count() or 1)


def extract_patches(src: np.ndarray, coords, patch: int) -> np.ndarray:
    """Gather patches with the sample-axis transpose fused.

    src: (H, W, S, C) or (H, W, C) float32.
    Returns (N, S, patch, patch, C) or (N, patch, patch, C).
    """
    pixel_space = src.ndim == 3
    if pixel_space:
        src = src[:, :, None, :]
    H, W, S, C = src.shape
    coords_arr = np.ascontiguousarray(np.asarray(coords, np.int32))
    n = coords_arr.shape[0]
    out = np.empty((n, S, patch, patch, C), np.float32)

    lib = _lib()
    if lib is not None and src.dtype == np.float32:
        src_c = np.ascontiguousarray(src)
        lib.wn_extract_patches(
            src_c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            H, W, S, C,
            coords_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n, patch,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            _N_THREADS,
        )
    else:
        for i, (y, x) in enumerate(coords_arr):
            out[i] = np.transpose(
                src[y:y + patch, x:x + patch], (2, 0, 1, 3)
            )
    if pixel_space:
        return out[:, 0]
    return out


class AliasSampler:
    """O(1)-per-draw importance sampler over a probability map."""

    def __init__(self, weights: np.ndarray):
        self.n = int(weights.size)
        w = np.ascontiguousarray(weights.reshape(-1), np.float32)
        lib = _lib()
        if lib is not None:
            self._handle = lib.wn_alias_build(
                w.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), self.n
            )
            self._np_weights = None
        else:
            self._handle = None
            total = w.sum()
            self._np_weights = (
                w / total if total > 0 else np.full(self.n, 1.0 / self.n)
            )

    def sample(self, count: int, seed: int) -> np.ndarray:
        lib = _lib()
        if self._handle is not None and lib is not None:
            out = np.empty(count, np.int32)
            lib.wn_alias_sample(
                self._handle, count, ctypes.c_uint64(seed),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
            return out
        rng = np.random.default_rng(seed)
        return rng.choice(self.n, size=count, p=self._np_weights).astype(
            np.int32
        )

    def __del__(self):
        try:
            if getattr(self, "_handle", None) is not None and _LIB is not None:
                _LIB.wn_alias_free(self._handle)
        except Exception:  # interpreter teardown
            pass
        self._handle = None


def sanitize_inplace(arr: np.ndarray, cap: float = 1.0e38) -> np.ndarray:
    lib = _lib()
    if lib is not None and arr.dtype == np.float32 and arr.flags.c_contiguous:
        lib.wn_sanitize(
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            arr.size, cap, _N_THREADS,
        )
        return arr
    np.copyto(arr, np.where(np.isfinite(arr), arr, cap))
    np.copyto(arr, np.clip(arr, -cap, cap))
    return arr
