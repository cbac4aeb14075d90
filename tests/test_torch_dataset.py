"""The port's disk pipeline against wcmc_tpu's, on the CPU.

* Importance map: ``_gaussian_blur`` and ``_sobel`` within 1e-5 of
  wcmc_tpu's relative to their max (and of scipy's ``gaussian_filter`` /
  ``sobel`` as ``tests/test_importance.py`` holds wcmc_tpu's); the
  gradient map and ``importance_map`` within 2e-4 of the max.  The map's
  gradient of a sigma-31 blur is small against the blurred values, so
  the blur's f32 rounding grows about a hundredfold in it: wcmc_tpu's f32
  map lies 8e-5 of its max from the float64 map the port computes (on
  the scenes here), and 1e-5 is out of reach of any summation order but
  XLA's own.
* Train/val caches: one synthetic corpus (160 px, 2 spp), copied, each
  package's ``offline_preprocess`` on its own copy: the same files, shapes
  and dtypes; values within ``test_torch_preprocess.py``'s tolerances,
  ``*_prob_imp.npy`` within 2e-4 of its max.
* Loaders: both packages' ``MSDenoiseDataset`` + ``ShuffleLoader`` and
  ``BatchLoader`` over the same (wcmc_tpu-written) cache files with the
  same seeds yield identical batches: keys, shapes, dtypes and bytes; with
  ``patches_per_image``, ``serve_paths_dtype="bfloat16"`` and the
  augmentations; KPCN, SBMC and LBMC layouts.
"""

import os
import shutil

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter, sobel

from wcmc_tpu.data import dataset as jds
from wcmc_tpu.data import importance as jimp
from wcmc_tpu.data import preprocess as jpp
from wcmc_tpu.data.synthetic import synthetic_ground_truth, synthetic_raw_sample
from wcmc_tpu_torch.data import dataset as tds
from wcmc_tpu_torch.data import importance as timp
from wcmc_tpu_torch.data.synthetic import build_synthetic_dataset

MAP_TOL = 2e-4
LLPM_RTOL, KPCN_RTOL = 1e-5, 2e-4   # test_torch_preprocess.py's


def _rel_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def test_blur_and_sobel_match_jax_and_scipy():
    img = np.random.default_rng(0).random((160, 176), dtype=np.float32)
    blur = timp._gaussian_blur(torch.from_numpy(img)).numpy()
    assert _rel_max(blur, jimp._gaussian_blur(img)) <= 1e-5
    np.testing.assert_allclose(blur, gaussian_filter(img, timp.GAUSS_SIGMA), rtol=1e-3,
                               atol=1e-4)
    for axis in (0, 1):
        got = timp._sobel(torch.from_numpy(img), axis).numpy()
        assert _rel_max(got, jimp._sobel(img, axis)) <= 1e-5
        np.testing.assert_allclose(np.abs(got), np.abs(sobel(img, axis=axis, mode="nearest")),
                                   rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("size", [160, 192])
def test_importance_map_matches_jax(size):
    rng = np.random.default_rng(size)
    gt = synthetic_ground_truth(rng, size, size)
    raw, _ = synthetic_raw_sample(rng, size, size, 2, gt=gt)
    s_buf, p_buf = (np.asarray(x) for x in jpp.preprocess_sbmc(raw))
    want = np.asarray(jimp.importance_map(gt, s_buf, p_buf))
    got = timp.importance_map(*(torch.from_numpy(np.array(x)) for x in (gt, s_buf, p_buf)))
    assert got.dtype == torch.float32 and got.shape == (size - 128, size - 128)
    assert _rel_max(got.numpy(), want) <= MAP_TOL
    lum = np.ascontiguousarray(gt[..., 0])
    assert _rel_max(timp.gradient_importance_map(torch.from_numpy(lum)).numpy(),
                    jimp.gradient_importance_map(lum)) <= MAP_TOL


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One 160-px 2-spp corpus (2 train scenes, 1 val), copied; each
    package caches its own copy (LLPM, SBMC, KPCN 2..8, importance)."""
    base = str(tmp_path_factory.mktemp("corpus"))
    build_synthetic_dataset(base, n_train=2, n_val=1, n_test=0, size=160, spp=2, seed=11)
    out = {}
    for name, mod, kw in (("jax", jds, {}), ("torch", tds, {"device": "cpu"})):
        root = str(tmp_path_factory.mktemp(name))
        shutil.copytree(base, root, dirs_exist_ok=True)
        for mode in ("train", "val"):
            mod.offline_preprocess(root, mode=mode, spp=8, sbmc=True, **kw)
        out[name] = root
    return out


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_train_val_caches_match_jax(trees):
    files = _files(trees["jax"])
    assert files == _files(trees["torch"])
    assert "train/input/scene0_prob_imp.npy" in files and "val/input/scene0_kpcn_8.npy" in files
    for rel in files:
        want = np.load(os.path.join(trees["jax"], rel))
        got = np.load(os.path.join(trees["torch"], rel))
        assert got.shape == want.shape and got.dtype == want.dtype == np.float32, rel
        if rel.endswith(("scene0.npy", "scene1.npy")) and "/input/" in rel:
            np.testing.assert_array_equal(got, want)   # the raw dumps, untouched
            continue
        if "prob_imp" in rel:
            assert _rel_max(got, want) <= MAP_TOL, rel
            assert abs(float(got.sum()) - 1.0) < 1e-3
            continue
        scale = np.maximum(np.abs(want.astype(np.float64)), 1.0)
        rtol = KPCN_RTOL if "kpcn" in rel else LLPM_RTOL
        assert np.max(np.abs(got - want.astype(np.float64)) / scale) <= rtol, rel


def _assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            assert g[k].tobytes() == w[k].tobytes(), k


LOADER_CASES = {
    # name: (base model, dataset kwargs)
    "kpcn_bf16": ("kpcn", dict(use_llpm_buf=True, use_sbmc_buf=False, pnet_out_size=3,
                               patches_per_image=2, serve_paths_dtype="bfloat16")),
    "sbmc": ("sbmc", dict(use_llpm_buf=True, use_sbmc_buf=True, pnet_out_size=0,
                          patches_per_image=2)),
    "lbmc": ("lbmc", dict(use_llpm_buf=True, use_sbmc_buf=False, pnet_out_size=0,
                          patches_per_image=1)),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_shuffle_and_batch_loaders_match_jax(trees, case):
    base, kw = LOADER_CASES[case]
    root = trees["jax"]
    args = (root, 8, base, "train", 2, "random")
    _assert_batches_equal(tds.ShuffleLoader(tds.MSDenoiseDataset(*args, seed=5, **kw), 2, seed=7),
                          jds.ShuffleLoader(jds.MSDenoiseDataset(*args, seed=5, **kw), 2, seed=7))
    kw = {k: v for k, v in kw.items() if k != "patches_per_image"}
    val = (root, 8, base, "val", 4, "grid")
    _assert_batches_equal(
        tds.BatchLoader(tds.MSDenoiseDataset(*val, seed=5, patches_per_image=4, **kw), 4),
        jds.BatchLoader(jds.MSDenoiseDataset(*val, seed=5, patches_per_image=4, **kw), 4))


def test_augmented_and_sequential_serving_match_jax(trees):
    """``augment=True`` (flips and rotations drawn per image) through the
    ShuffleLoader, and index-order serving (``__getitem__``) with the
    default ``patches_per_image``, ``load_patches`` and ``get_stats``."""
    root = trees["jax"]
    kw = dict(use_llpm_buf=True, use_sbmc_buf=False, pnet_out_size=3, seed=2)
    t = tds.DenoiseDataset(root, 4, "kpcn", "train", 8, "random", augment=True,
                           patches_per_image=4, **kw)
    j = jds.DenoiseDataset(root, 4, "kpcn", "train", 8, "random", augment=True,
                           patches_per_image=4, **kw)
    _assert_batches_equal(tds.ShuffleLoader(t, 2, seed=1), jds.ShuffleLoader(j, 2, seed=1))
    t = tds.DenoiseDataset(root, 2, "sbmc", "train", 64, "random", **kw)
    j = jds.DenoiseDataset(root, 2, "sbmc", "train", 64, "random", **kw)
    assert len(t) == len(j) == 2 * 256
    _assert_batches_equal([t[i] for i in (0, 1, 300)], [j[i] for i in (0, 1, 300)])
    _assert_batches_equal(t.load_patches(1, np.random.default_rng(4))[:3],
                          j.load_patches(1, np.random.default_rng(4))[:3])
    got, want = t.get_stats(max_images=1), j.get_stats(max_images=1)
    assert sorted(got) == sorted(want)
    for k in want:
        for s in ("mean", "std", "min", "max"):
            np.testing.assert_array_equal(got[k][s], want[k][s])


def test_flip_rot_and_valid_path(tmp_path):
    rng = np.random.default_rng(0)
    patch = {"a": rng.random((4, 4, 2, 3)), "b": rng.random((4, 4, 3))}
    for seed in range(6):
        got = tds.DenoiseDataset.random_rot(
            tds.DenoiseDataset.random_flip(patch, np.random.default_rng(seed)),
            np.random.default_rng(seed + 10))
        want = jds.DenoiseDataset.random_rot(
            jds.DenoiseDataset.random_flip(patch, np.random.default_rng(seed)),
            np.random.default_rng(seed + 10))
        for k in patch:
            np.testing.assert_array_equal(got[k], want[k])
    real = tmp_path / "b" / "train" / "gt"
    real.mkdir(parents=True)
    (real / "x.npy").write_bytes(b"")
    missing = str(tmp_path / "a" / "train" / "gt" / "x.npy")
    assert tds.get_valid_path(missing, [str(tmp_path / "b")]) == str(real / "x.npy")
    with pytest.raises(FileNotFoundError):
        tds.get_valid_path(missing, [str(tmp_path / "c")])


def test_offline_preprocess_rejects_unknown_split(tmp_path):
    with pytest.raises(ValueError, match="split"):
        tds.offline_preprocess(str(tmp_path), mode="training", device="cpu")
