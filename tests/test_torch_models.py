"""Parity of the port's models with the flax modules of wcmc_tpu, on
parameters carried across by ``wcmc_tpu_torch.convert``.

Tolerance: 1e-4 of max |ref| in f32 — the same math, but summed in
another order through up to 9 stacked convolutions (and the U-Net's 16),
so rounding differences grow layer by layer past the 1e-5 of a single
op."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wcmc_tpu.models import blocks as jblocks
from wcmc_tpu.models.kpcn import KPCN as JKPCN
from wcmc_tpu.models.pathnet import PathNet as JPathNet
from wcmc_tpu.models.pathnet import dual_pathnet_apply as jdual
from wcmc_tpu_torch import convert
from wcmc_tpu_torch.models import blocks as tblocks
from wcmc_tpu_torch.models.kpcn import KPCN as TKPCN
from wcmc_tpu_torch.models.pathnet import PathNet as TPathNet
from wcmc_tpu_torch.models.pathnet import dual_pathnet_apply as tdual

TOL = 1e-4
IC = 16   # PathNet width, narrowed from 64 for CPU speed


def _close(got, want, tol=TOL):
    got = np.asarray(torch.as_tensor(got).detach().float(), np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want))


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


def _init(module, sample, seed):
    return module.init(jax.random.PRNGKey(seed), sample)["params"]


def test_convert_round_trip_and_mismatch():
    jm = JKPCN(n_in=7, ksize=3, depth=3, width=8)
    params = _init(jm, {k: jnp.zeros((1, 20, 20, 7 if "in" in k else 3)) for k in (
        "kpcn_diffuse_in", "kpcn_specular_in", "kpcn_diffuse_buffer",
        "kpcn_specular_buffer", "kpcn_albedo")}, 0)
    tm = convert.load_flax_params(TKPCN(n_in=7, ksize=3, depth=3, width=8), params)
    back = convert.to_flax(tm)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b)
    # a 4-D kernel goes HWIO -> OIHW
    k = np.asarray(params["diffuse"]["Conv_0"]["kernel"])
    np.testing.assert_array_equal(tm.diffuse.Conv_0.weight.detach().numpy(),
                                  k.transpose(3, 2, 0, 1))
    with pytest.raises(ValueError):
        convert.load_flax_params(TKPCN(n_in=7, ksize=3, depth=2, width=8), params)
    with pytest.raises(ValueError):
        convert.load_flax_params(TKPCN(n_in=6, ksize=3, depth=3, width=8), params)


def test_fresh_init_is_flax_like():
    """lecun_normal: truncated at 2 std, variance 1/fan_in; zero bias."""
    m = TPathNet(ic=36, intermc=64, generator=torch.Generator().manual_seed(0))
    w = m.embedding_w1.detach().numpy()
    std = np.sqrt(1.0 / 64) / 0.87962566103423978
    assert np.abs(w).max() <= 2 * std + 1e-6
    assert abs(w.std() - np.sqrt(1.0 / 64)) < 0.1 * np.sqrt(1.0 / 64)
    assert not m.embedding_b1.detach().numpy().any()
    c = m.propagation.Conv_0
    assert c.weight.shape == (64, 64, 3, 3) and not c.bias.detach().numpy().any()


def test_unet_and_dual_unet():
    rng = np.random.default_rng(0)
    ju = jblocks.UNet(IC, num_levels=3, width=IC)
    xa = rng.standard_normal((2, 16, 12, IC)).astype(np.float32)
    xb = rng.standard_normal((2, 16, 12, IC)).astype(np.float32)
    pa, pb = _init(ju, jnp.asarray(xa), 1), _init(ju, jnp.asarray(xb), 2)
    ta, tb = (convert.load_flax_params(tblocks.UNet(IC, IC, width=IC), p) for p in (pa, pb))
    want_a = ju.apply({"params": pa}, jnp.asarray(xa))
    _close(_nhwc(ta(_nchw(xa))), want_a)
    wa, wb = jblocks.dual_unet_apply(ju, pa, pb, jnp.asarray(xa), jnp.asarray(xb))
    ga, gb = tblocks.dual_unet_apply(ta, tb, _nchw(xa), _nchw(xb))
    _close(_nhwc(ga), wa)
    _close(_nhwc(gb), wb)


def test_conv_chain():
    rng = np.random.default_rng(1)
    jc = jblocks.ConvChain(11, width=20, depth=3, ksize=5)
    x = rng.standard_normal((2, 20, 18, 6)).astype(np.float32)
    p = _init(jc, jnp.asarray(x), 3)
    tc = convert.load_flax_params(tblocks.ConvChain(6, 11, width=20, depth=3, ksize=5), p)
    _close(_nhwc(tc(_nchw(x))), jc.apply({"params": p}, jnp.asarray(x)))


@pytest.fixture(scope="module")
def pathnets():
    rng = np.random.default_rng(2)
    paths = rng.standard_normal((2, 3, 16, 12, 36)).astype(np.float32)
    jm = JPathNet(ic=36, intermc=IC, outc=3)
    pd = _init(jm, {"paths": jnp.asarray(paths)}, 4)
    ps = _init(jm, {"paths": jnp.asarray(paths)}, 5)
    td, ts = (convert.load_flax_params(TPathNet(ic=36, intermc=IC, outc=3), p)
              for p in (pd, ps))
    return paths, jm, pd, ps, td, ts


def test_pathnet(pathnets):
    paths, jm, pd, _, td, _ = pathnets
    want = jm.apply({"params": pd}, {"paths": jnp.asarray(paths)})
    with torch.no_grad():
        got = td({"paths": torch.from_numpy(paths)})
    _close(got, want)


@pytest.mark.parametrize("cmajor", [False, True])
def test_dual_pathnet_with_moments(pathnets, cmajor):
    paths, jm, pd, ps, td, ts = pathnets
    want = jdual(jm, pd, jm, ps, {"paths": jnp.asarray(paths)}, with_moments=True,
                 cmajor=cmajor)
    with torch.no_grad():
        got = tdual(td, ts, {"paths": torch.from_numpy(paths)}, with_moments=True,
                    cmajor=cmajor)
    _close(got[0], want[0])
    _close(got[1], want[1])
    for g, w in zip(got[2], want[2]):
        _close(g, w)
    with torch.no_grad():
        plain = tdual(td, ts, {"paths": torch.from_numpy(paths)}, cmajor=cmajor)
    torch.testing.assert_close(plain[0], got[0], rtol=0, atol=0)


@pytest.mark.parametrize("ksize", [5, 21])
def test_kpcn(ksize):
    rng = np.random.default_rng(6)
    size = 36 + ksize - 1 + 6
    n_in = 39
    batch = {
        "kpcn_diffuse_in": rng.standard_normal((2, size, size, n_in)),
        "kpcn_specular_in": rng.standard_normal((2, size, size, n_in)),
        "kpcn_diffuse_buffer": rng.random((2, size, size, 3)),
        "kpcn_specular_buffer": rng.random((2, size, size, 3)),
        "kpcn_albedo": rng.random((2, size, size, 3)),
    }
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    jm = JKPCN(n_in=n_in, ksize=ksize)
    params = _init(jm, {k: jnp.asarray(v) for k, v in batch.items()}, 7)
    tm = convert.load_flax_params(TKPCN(n_in=n_in, ksize=ksize), params)
    want = jm.apply({"params": params}, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = tm({k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == (2, 6, 6, 3)
        _close(got[k], want[k])
