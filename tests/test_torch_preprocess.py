"""Parity of the port's preprocessing and offline cache with wcmc_tpu.

Tolerances are the README golden-table bounds: 1e-5 relative for the
LLPM descriptor and the SBMC buffers, 2e-4 relative for the KPCN
statistics (f32 variance math summed in another order)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wcmc_tpu.data import dataset as jds
from wcmc_tpu.data import preprocess as jpp
from wcmc_tpu.data.synthetic import synthetic_raw_sample
from wcmc_tpu_torch.data import dataset as tds
from wcmc_tpu_torch.data import preprocess as tpp
from wcmc_tpu_torch.data.synthetic import build_synthetic_dataset

LLPM_RTOL = 1e-5
KPCN_RTOL = 2e-4


def _rel_close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.maximum(np.abs(want), 1.0)
    assert np.max(np.abs(got - want) / scale) <= rtol


@pytest.fixture(scope="module")
def raw():
    rng = np.random.default_rng(21)
    raw, gt = synthetic_raw_sample(rng, 24, 20, 4, nan_fraction=1e-3)
    return raw, gt


def test_sanitize(raw):
    x = raw[0].copy()
    x[0, 0, 0, :3] = [np.inf, -np.inf, 3e38]
    want = np.asarray(jpp.sanitize(jnp.asarray(x)))
    got = tpp.sanitize(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_preprocess_llpm(raw):
    x = np.array(jpp.sanitize(jnp.asarray(raw[0])))
    want = np.asarray(jpp.preprocess_llpm(jnp.asarray(x)))
    got = tpp.preprocess_llpm(torch.from_numpy(x)).numpy()
    _rel_close(got, want, LLPM_RTOL)


def test_preprocess_kpcn(raw):
    x = np.array(jpp.sanitize(jnp.asarray(raw[0])))
    want = np.asarray(jpp.preprocess_kpcn(jnp.asarray(x)))
    got = tpp.preprocess_kpcn(torch.from_numpy(x)).numpy()
    _rel_close(got, want, KPCN_RTOL)


def test_preprocess_sbmc(raw):
    x = np.array(jpp.sanitize(jnp.asarray(raw[0])))
    want = jpp.preprocess_sbmc(jnp.asarray(x))
    got = tpp.preprocess_sbmc(torch.from_numpy(x))
    assert [g.shape for g in got] == [(24, 20, 4, 27), (24, 20, 4, 66)]
    for g, w in zip(got, want):
        _rel_close(g.numpy(), np.asarray(w), LLPM_RTOL)


@pytest.mark.parametrize("use_g_buf,use_sbmc_buf", [(True, True), (True, False), (False, False)])
def test_sbmc_features(raw, use_g_buf, use_sbmc_buf):
    x = np.array(jpp.sanitize(jnp.asarray(raw[0])))
    s_buf, p_buf = (np.array(b) for b in jpp.preprocess_sbmc(jnp.asarray(x)))
    want = jpp.sbmc_features(jnp.asarray(s_buf), jnp.asarray(p_buf), use_g_buf, use_sbmc_buf)
    got = tpp.sbmc_features(torch.from_numpy(s_buf), torch.from_numpy(p_buf), use_g_buf,
                            use_sbmc_buf)
    assert set(got) == set(want) == {"radiance", "features"}
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError):
        tpp.sbmc_features(torch.from_numpy(s_buf), None, use_sbmc_buf=True)


def test_spatial_gradients(raw):
    buf = raw[1]
    want = np.asarray(jpp._spatial_gradients(jnp.asarray(buf)))
    got = tpp._spatial_gradients(torch.from_numpy(buf)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=0)


def test_kpcn_net_inputs_and_targets(raw):
    x = np.array(jpp.sanitize(jnp.asarray(raw[0])))
    buf = np.asarray(jpp.preprocess_kpcn(jnp.asarray(x)))
    want = jpp.kpcn_net_inputs(jnp.asarray(buf))
    got = tpp.kpcn_net_inputs(torch.from_numpy(buf))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    gt = raw[1]
    want_t = jpp.kpcn_targets(jnp.asarray(gt))
    got_t = tpp.kpcn_targets(torch.from_numpy(gt))
    assert set(got_t) == set(want_t)
    for k in want_t:
        _rel_close(got_t[k].numpy(), np.asarray(want_t[k]), LLPM_RTOL)


@pytest.fixture(scope="module")
def cache_trees(tmp_path_factory):
    """One synthetic scene (with an extra-spp part), cached by each
    package in its own copy of the tree."""
    trees = {}
    for name in ("jax", "torch"):
        root = str(tmp_path_factory.mktemp(f"cache_{name}"))
        build_synthetic_dataset(root, n_train=0, n_val=0, n_test=1, size=40,
                                spp=2, test_extra_parts=1, seed=5,
                                nan_fraction=1e-3)
        trees[name] = root
    jds.offline_preprocess(trees["jax"], mode="test", spp=2, sbmc=True,
                           test_spps=(2, 4))
    tds.offline_preprocess(trees["torch"], mode="test", spp=2, sbmc=True,
                           test_spps=(2, 4), device="cpu")
    return trees


@pytest.mark.parametrize("rel", [
    "test/input/scene0_llpm.npy", "test/input/scene0_llpm_1.npy",
    "test/input/scene0_kpcn_2.npy", "test/input/scene0_kpcn_4.npy",
    "test/input/scene0_sbmc_s.npy", "test/input/scene0_sbmc_p.npy",
    "test/input/scene0_sbmc_s_1.npy", "test/input/scene0_sbmc_p_1.npy",
    "test/gt/scene0.npy",
])
def test_offline_cache_matches_jax(cache_trees, rel):
    want = np.load(os.path.join(cache_trees["jax"], rel))
    got = np.load(os.path.join(cache_trees["torch"], rel))
    assert got.dtype == want.dtype == np.float32
    _rel_close(got, want, KPCN_RTOL if "kpcn" in rel else LLPM_RTOL)


def test_offline_cache_same_files(cache_trees):
    for sub in ("test/input", "test/gt"):
        assert (sorted(os.listdir(os.path.join(cache_trees["jax"], sub)))
                == sorted(os.listdir(os.path.join(cache_trees["torch"], sub))))


def test_synthetic_dataset_matches_script(tmp_path):
    """build_synthetic_dataset writes the same bytes as the reference's
    scripts/make_synthetic_dataset.py for one seed."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_synthetic_dataset",
        os.path.join(os.path.dirname(__file__), "..", "scripts",
                     "make_synthetic_dataset.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build(str(tmp_path / "a"), 1, 1, 1, size=16, spp=2, seed=3)
    build_synthetic_dataset(str(tmp_path / "b"), 1, 1, 1, size=16, spp=2, seed=3)
    for mode in ("train", "val", "test"):
        for sub in ("gt", "input"):
            da, db = tmp_path / "a" / mode / sub, tmp_path / "b" / mode / sub
            assert sorted(os.listdir(da)) == sorted(os.listdir(db))
            for f in os.listdir(da):
                np.testing.assert_array_equal(np.load(da / f), np.load(db / f))


def test_offline_preprocess_unported_modes_raise(tmp_path):
    """Splits other than train, val and test raise; the train/val caches
    are ported (``tests/test_torch_dataset.py``), and so are the test
    split's SBMC caches (``test_offline_cache_matches_jax``)."""
    for sbmc in (False, True):
        with pytest.raises(ValueError):
            tds.offline_preprocess(str(tmp_path), mode="training", sbmc=sbmc, device="cpu")
