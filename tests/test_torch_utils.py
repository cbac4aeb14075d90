"""The port's ``utils`` helpers against ``wcmc_tpu.utils`` on the CPU: the
margin crop (margin 0 included), plain Reinhard, the display transform and
the reference-style aliases, in f32 from the same numpy inputs (1e-6
relative: elementwise f32 math, a power by another library's pow)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wcmc_tpu.utils as jut
import wcmc_tpu_torch.utils as tut
from wcmc_tpu.utils import utils as ju
from wcmc_tpu_torch.utils import utils as tu

RTOL = 1e-6


def _hdr(seed, shape=(2, 9, 11, 3)):
    """HDR radiance with negatives and a few large values."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 2.0
    x.flat[::17] = 40.0
    return x


def _close(got, want):
    got = got.numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0)) <= RTOL


@pytest.mark.parametrize("margin", [0, 1, 3])
def test_crop_margin(margin):
    x = _hdr(0)
    got = tu.crop_margin(torch.from_numpy(x), margin)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ju.crop_margin(jnp.asarray(x), margin)))
    assert tuple(got.shape) == (2, 9 - 2 * margin, 11 - 2 * margin, 3)


def test_tonemap_reinhard():
    x = _hdr(1)
    got = tu.tonemap_reinhard(torch.from_numpy(x))
    _close(got, ju.tonemap_reinhard(jnp.asarray(x)))
    assert float(got.min()) == 0.0 and float(got.max()) < 1.0


def test_tonemap_batch():
    x = _hdr(2)
    got = tu.tonemap_batch(torch.from_numpy(x))
    _close(got, ju.tonemap_batch(jnp.asarray(x)))
    assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0


def test_aliases_and_exports():
    """``ToneMap``, ``LinearToSrgb`` and ``ToneMapBatch`` name the same
    transforms as the reference's, and the package exports its names."""
    x = _hdr(3)
    for name in ("ToneMap", "LinearToSrgb", "ToneMapBatch"):
        _close(getattr(tu, name)(torch.from_numpy(x)), getattr(ju, name)(jnp.asarray(x)))
    exported = [n for n in dir(jut) if not n.startswith("_") and callable(getattr(jut, n))]
    assert exported
    for name in exported:
        assert callable(getattr(tut, name))
