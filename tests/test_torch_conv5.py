"""The fused convolution (K6's plain version and its autograd Function),
``ConvChain``'s fused route and ``denoise``'s tile clamp against
wcmc_tpu.

* f32: ``conv2d`` on the CPU against wcmc_tpu's ``conv2d`` with the
  Pallas kernel interpreted, at ``tests/test_conv5.py``'s cases plus a
  KPCN-layer-1-like (Cin 39) and a layer-9-like (Cout 441) case: within
  1e-4 of max |ref| (the same f32 math summed in another order, as
  ``tests/test_conv5.py`` holds the kernel to XLA).
* bf16: against wcmc_tpu's ``_conv_xla``, the oracle, which rounds once
  after bias and activation as the port does: within 1e-2 of max |ref|
  (f32 sums in another order can round to a neighbouring bf16 value, one
  step being 2^-8 relative).
* The VJP (d x, d w, d b) against ``jax.grad`` through wcmc_tpu's
  ``conv2d``: within 1e-3 of max |ref|.
* ``ConvChain``'s fused route against wcmc_tpu's ``ConvChain(fused=True)``
  on parameters carried by ``convert.py``, in f32 (1e-4) and bf16 (1e-2);
  the chain's ``state_dict`` is the unfused chain's, and its unfused route
  on the same parameters agrees in f32 (1e-4).
* ``denoise``'s tile clamp, as ``tests/test_evaluate.py`` checks wcmc_tpu's.
"""

import importlib
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wcmc_tpu import evaluate as jev
from wcmc_tpu.models.blocks import ConvChain as JConvChain
from wcmc_tpu_torch import convert
from wcmc_tpu_torch import evaluate as tev
from wcmc_tpu_torch.models.blocks import ConvChain as TConvChain
from wcmc_tpu_torch.ops import _build
from wcmc_tpu_torch.ops import conv5 as tc5

jc5 = importlib.import_module("wcmc_tpu.ops.conv5")
jmf = importlib.import_module("wcmc_tpu.ops.mlp_fused")
jpk = importlib.import_module("wcmc_tpu.ops.pallas_kernels")

F32_TOL, BF16_TOL, GRAD_TOL = 1e-4, 1e-2, 1e-3

CASES = [
    (2, 20, 20, 7, 13, 5, "relu"),
    (1, 36, 28, 100, 32, 5, "relu"),   # non-square, KPCN-like channels
    (2, 17, 19, 5, 9, 3, None),        # 3x3, odd sizes
    (1, 12, 12, 4, 6, 5, "leaky_relu"),
    (2, 21, 18, 39, 100, 5, "relu"),   # KPCN layer 1 (n_in 39), partial tiles
    (1, 13, 11, 100, 441, 5, None),    # KPCN layer 9 (K^2 = 441 logits)
]


@pytest.fixture
def interpret():
    jpk.INTERPRET, old_i = True, jpk.INTERPRET
    jmf.FORCE_PALLAS, old_f = True, jmf.FORCE_PALLAS
    try:
        yield
    finally:
        jpk.INTERPRET = old_i
        jmf.FORCE_PALLAS = old_f


def _close(got, want, tol):
    got = np.asarray(torch.as_tensor(got).detach().float(), np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want))
    assert err <= tol * np.max(np.abs(want)), err


def _case(b, h, w, cin, cout, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wgt = (rng.standard_normal((k, k, cin, cout)) / np.sqrt(k * k * cin)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    return x, wgt, bias


@pytest.mark.parametrize("b,h,w,cin,cout,k,act", CASES)
def test_conv2d_f32_against_pallas(interpret, b, h, w, cin, cout, k, act):
    x, wgt, bias = _case(b, h, w, cin, cout, k, 0)
    want = jc5.conv2d(jnp.asarray(x), jnp.asarray(wgt), jnp.asarray(bias), k, act)
    _build.reset_counts()
    got = tc5.conv2d(torch.from_numpy(x), torch.from_numpy(wgt), torch.from_numpy(bias), k, act)
    assert dict(_build.plain_calls) == {"conv5": 1} and not _build.launches
    assert got.dtype == torch.float32 and got.is_contiguous()
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("b,h,w,cin,cout,k,act", CASES)
def test_conv2d_bf16_against_xla(b, h, w, cin, cout, k, act):
    x, wgt, bias = _case(b, h, w, cin, cout, k, 1)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = jc5._conv_xla(xb, jnp.asarray(wgt), jnp.asarray(bias), k, act)
    got = tc5.conv2d(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(wgt),
                     torch.from_numpy(bias), k, act)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_TOL)


@pytest.mark.parametrize("b,h,w,cin,cout,k,act", CASES[:3] + CASES[4:])
def test_conv2d_vjp_against_jax(interpret, b, h, w, cin, cout, k, act):
    x, wgt, bias = _case(b, h, w, cin, cout, k, 2)

    def f(x_, w_, b_):
        return jnp.sum(jnp.sin(jc5.conv2d(x_, w_, b_, k, act)))

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(wgt), jnp.asarray(bias))
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, wgt, bias))
    torch.sin(tc5.conv2d(xt, wt, bt, k, act)).sum().backward()
    for got, ref in zip((xt.grad, wt.grad, bt.grad), want):
        _close(got, ref, GRAD_TOL)


def test_conv2d_refuses_what_it_does_not_compute():
    x, wgt, bias = (torch.from_numpy(a) for a in _case(1, 8, 8, 3, 4, 5, 3))
    with pytest.raises(ValueError, match="activations"):
        tc5.conv2d(x, wgt, bias, 5, "elu")
    with pytest.raises(ValueError, match="weight"):
        tc5.conv2d(x, wgt, bias, 3, None)
    with pytest.raises(ValueError, match="smaller"):
        tc5.conv2d(x[:, :4], wgt, bias, 5, None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_chain_against_jax(interpret, dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 30, 26, 7)).astype(np.float32)
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = None if dtype == "float32" else torch.bfloat16
    jchain = JConvChain(11, width=16, depth=3, ksize=5, pad=False, fused=True, dtype=jdt)
    params = jchain.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = jchain.apply({"params": params}, jnp.asarray(x))
    chain = TConvChain(7, 11, width=16, depth=3, ksize=5, dtype=tdt)
    convert.load_flax_params(chain, params)
    # the parameters of the unfused chain the flax tree maps to
    assert list(chain.state_dict()) == [f"Conv_{i}.{n}" for i in range(3)
                                        for n in ("weight", "bias")]
    assert tuple(convert.to_flax(chain)["Conv_0"]["kernel"].shape) == (5, 5, 7, 16)
    _build.reset_counts()
    got = chain(torch.from_numpy(x), fused=True)
    assert dict(_build.plain_calls) == {"conv5": 3}
    _close(got, want, F32_TOL if dtype == "float32" else BF16_TOL)
    # the same parameters through the unfused route
    nchw = chain(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert tuple(nchw.shape) == tuple(got.shape)
    if dtype == "float32":
        _close(nchw, want, F32_TOL)


def test_large_square_tile_clamped(monkeypatch):
    """The reference's clamp, checked as ``tests/test_evaluate.py`` checks
    it, and the port's beside it on the same inputs."""
    monkeypatch.delenv("WCMC_ALLOW_LARGE_TILES", raising=False)
    for clamp in (jev._clamp_pathological_tile, tev._clamp_pathological_tile):
        with pytest.warns(UserWarning, match="clamped to 256"):
            assert clamp(512, 512) == (256, 256)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert clamp(128, 1920) == (128, 1920)
            assert clamp(256, 256) == (256, 256)
            assert clamp(None, None) == (None, None)
            assert clamp(385, 384) == (385, 384)
    monkeypatch.setenv("WCMC_ALLOW_LARGE_TILES", "1")
    assert tev._clamp_pathological_tile(512, 512) == (512, 512)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("allow", [False, True])
def test_denoise_clamps_its_tiles(tmp_path, monkeypatch, allow):
    """``denoise`` hands the clamped tile to its dataset."""
    for d in ("input", "gt"):
        os.makedirs(tmp_path / d)
    np.save(tmp_path / "gt" / "scene0.npy", np.zeros(1, np.float32))
    seen = []

    def dataset(*args, **kw):
        seen.append((kw["tile_h"], kw["tile_w"]))
        raise _Stop

    monkeypatch.setattr(tev, "FullImageDataset", dataset)
    if allow:
        monkeypatch.setenv("WCMC_ALLOW_LARGE_TILES", "1")
    else:
        monkeypatch.delenv("WCMC_ALLOW_LARGE_TILES", raising=False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with pytest.raises(_Stop):
            tev.denoise(None, str(tmp_path / "input"), "kpcn", use_llpm_buf=True,
                        output_dir=str(tmp_path / "out"), tile_h=512, tile_w=512)
    clamped = [w for w in caught if "clamped to 256" in str(w.message)]
    assert seen == ([(512, 512)] if allow else [(256, 256)])
    assert len(clamped) == (0 if allow else 1)
