"""Parity of the port's losses with wcmc_tpu.losses, in f32.

The reconstruction losses within 1e-6 relative (value and gradient).
The manifold losses (FeatureMSE in rgb and hls, local and non-local;
GRS), in both pairings and both layouts, replay the reference's random
draws: the test splits the key as ``wcmc_tpu.losses`` does and passes
the shifts or the permutation to the port.  Loss and d(loss)/d(p_buffer)
within 1e-5 of max |ref|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wcmc_tpu import losses as jl
from wcmc_tpu.ops import colors as jcolors
from wcmc_tpu_torch import losses as tl
from wcmc_tpu_torch.ops import colors as tcolors

RECON_TOL, MANIF_TOL = 1e-6, 1e-5


def jax_draws(key, p_shape, pairing, cmajor):
    """The draws wcmc_tpu's manifold losses take from ``key``."""
    n_patch, n_batch = tl.positions(p_shape, cmajor)
    k_patch, k_batch = jax.random.split(key)

    def one(k, n):
        if pairing == "permutation":
            return torch.from_numpy(np.array(jax.random.permutation(k, n)))
        k1, k2 = jax.random.split(k)
        return int(jax.random.randint(k1, (), 0, n)), int(jax.random.randint(k2, (), 1, n))

    return {"patch": one(k_patch, n_patch), "batch": one(k_batch, n_batch)}


def _close(got, want, tol):
    got = np.asarray(torch.as_tensor(got).detach().double())
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * max(np.max(np.abs(want)), 1e-30)


@pytest.mark.parametrize("name", ["l1", "smape", "tonemapped_mse",
                                  "tonemapped_relative_mse", "relative_mse"])
def test_reconstruction_losses(name):
    rng = np.random.default_rng(0)
    im = (2 * rng.standard_normal((2, 9, 7, 3))).astype(np.float32)
    ref = rng.random((2, 9, 7, 3)).astype(np.float32)
    jfn, tfn = getattr(jl, name), getattr(tl, name)
    want, jgrad = jax.value_and_grad(lambda x: jfn(x, jnp.asarray(ref)))(jnp.asarray(im))
    x = torch.from_numpy(im).requires_grad_()
    got = tfn(x, torch.from_numpy(ref))
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= RECON_TOL * abs(float(want))
    _close(x.grad, jgrad, RECON_TOL)


def test_colors():
    rng = np.random.default_rng(1)
    img = rng.random((4, 5, 3)).astype(np.float32)
    img[0, 0] = 0.5                      # grey: zero delta
    img[0, 1] = (1.0, 0.2, 0.2)          # red max
    img[0, 2] = (0.2, 1.0, 0.2)          # green max
    img[0, 3] = (0.1, 0.2, 1.0)          # blue max
    want = jcolors.hls_cartesian(jcolors.rgb_to_hls(jnp.asarray(img)))
    got = tcolors.hls_cartesian(tcolors.rgb_to_hls(torch.from_numpy(img)))
    _close(got, want, RECON_TOL)


def _manif_case(shape, cmajor, seed=2):
    rng = np.random.default_rng(seed)
    b, s, h, w, c = shape
    # positive embeddings: the hls path differentiates x ** (1 / 2.2) at x
    p = (0.05 + rng.random((b, s, c, h, w) if cmajor else shape)).astype(np.float32)
    ref = (2 * rng.random((b, h, w, 3))).astype(np.float32)
    return p, ref


def _check_manifold(jfn, tfn, shape, pairing, cmajor, **kw):
    p, ref = _manif_case(shape, cmajor)
    key = jax.random.PRNGKey(7)
    want, jgrad = jax.value_and_grad(
        lambda x: jfn(key, x, jnp.asarray(ref), pairing=pairing, cmajor=cmajor, **kw)
    )(jnp.asarray(p))
    x = torch.from_numpy(p).requires_grad_()
    got = tfn(x, torch.from_numpy(ref), jax_draws(key, p.shape, pairing, cmajor),
              pairing=pairing, cmajor=cmajor, **kw)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= MANIF_TOL * abs(float(want))
    _close(x.grad, jgrad, MANIF_TOL)


@pytest.mark.parametrize("cmajor", [False, True])
@pytest.mark.parametrize("pairing", ["roll", "permutation"])
@pytest.mark.parametrize("non_local", [True, False])
@pytest.mark.parametrize("color", ["rgb", "hls"])
def test_feature_mse(color, non_local, pairing, cmajor):
    # S*H*W = 90 and B*S*H*W = 180: block-transpose divisor 6
    _check_manifold(jl.feature_mse, tl.feature_mse, (2, 3, 6, 5, 3), pairing, cmajor,
                    color=color, non_local=non_local)


@pytest.mark.parametrize("cmajor", [False, True])
@pytest.mark.parametrize("pairing", ["roll", "permutation"])
def test_global_relative_similarity(pairing, cmajor):
    # S*H*W = 72 and B*S*H*W = 144: block-transpose divisor 8
    _check_manifold(jl.global_relative_similarity, tl.global_relative_similarity,
                    (2, 2, 6, 6, 3), pairing, cmajor)


@pytest.mark.parametrize("name", ["FMSE", "GRS"])
def test_make_manifold_loss(name):
    """The factory's loss with its own generator-drawn pairings equals
    the plain function given the same draws; unknown names raise."""
    loss = tl.make_manifold_loss(name, non_local=True, pairing="roll")
    p, ref = _manif_case((2, 2, 4, 4, 3), True)
    p, ref = torch.from_numpy(p), torch.from_numpy(ref)
    draws = loss.draw(torch.Generator().manual_seed(0), tuple(p.shape), cmajor=True)
    n_patch, n_batch = tl.positions(tuple(p.shape), cmajor=True)
    assert 0 <= draws["patch"][0] < n_patch and 1 <= draws["batch"][1] < n_batch
    fn = tl.feature_mse if name == "FMSE" else tl.global_relative_similarity
    assert float(loss(p, ref, draws, cmajor=True)) == float(
        fn(p, ref, draws, pairing="roll", cmajor=True))
    with pytest.raises(ValueError):
        tl.make_manifold_loss("MSE")
    with pytest.raises(ValueError):
        tl.make_manifold_loss("FMSE", pairing="shuffle")
