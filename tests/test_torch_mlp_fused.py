"""The fused per-pixel MLP (K10's plain versions and its autograd
Function) and ``PixelMLP`` against wcmc_tpu.

* f32: ``fused_mlp`` forward and backward (d x on and off) against
  wcmc_tpu's ``fused_mlp`` and ``jax.vjp`` of its XLA chain, C0 = 27 and
  32, relu / leaky relu / linear layers: within 1e-5 of max |ref| (the
  same f32 math summed in another order).
* bf16: ``_mlp_fwd_plain`` and ``_mlp_bwd_plain`` against the Pallas
  kernels ``_mlp_fwd_pallas`` / ``_mlp_bwd_pallas`` in interpret mode:
  within 2e-2 of max |ref| (both round at the same points; a bf16 value
  summed in another order can round to a neighbouring one).
* ``PixelMLP`` against wcmc_tpu's on converted parameters, in f32: output
  and every gradient within 1e-5 of max |ref|.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wcmc_tpu.models.blocks import PixelMLP as JPixelMLP
from wcmc_tpu_torch import convert
from wcmc_tpu_torch.models.blocks import PixelMLP as TPixelMLP
from wcmc_tpu_torch.ops import _build
from wcmc_tpu_torch.ops import mlp_fused as tmf

jmf = importlib.import_module("wcmc_tpu.ops.mlp_fused")
jpk = importlib.import_module("wcmc_tpu.ops.pallas_kernels")

F32_TOL, BF16_TOL = 1e-5, 2e-2
ACT_SETS = [("relu", "leaky_relu", "linear"), ("leaky_relu",) * 3]
WIDTHS = (32, 16, 32)


def _close(got, want, tol):
    got = np.asarray(torch.as_tensor(got).detach().float(), np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * max(np.max(np.abs(want)), 1e-30)


def _case(c0, seed, n=300):
    rng = np.random.default_rng(seed)
    dims = (c0,) + WIDTHS
    x = rng.standard_normal((n, c0)).astype(np.float32)
    ws = [(rng.standard_normal((ci, co)) / np.sqrt(ci)).astype(np.float32)
          for ci, co in zip(dims[:-1], dims[1:])]
    bs = [(0.1 * rng.standard_normal(co)).astype(np.float32) for co in dims[1:]]
    g = rng.standard_normal((n, dims[-1])).astype(np.float32)
    return x, ws, bs, g


@pytest.mark.parametrize("compute_dx", [True, False])
@pytest.mark.parametrize("acts", ACT_SETS)
@pytest.mark.parametrize("c0", [27, 32])
def test_fused_mlp_f32_against_xla(c0, acts, compute_dx):
    x, ws, bs, g = _case(c0, 0)
    y_j, vjp = jax.vjp(lambda x_, ws_, bs_: jmf.fused_mlp(x_, ws_, bs_, acts, compute_dx),
                       jnp.asarray(x), [jnp.asarray(w) for w in ws],
                       [jnp.asarray(b) for b in bs])
    dx_j, dws_j, dbs_j = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    wt = [torch.from_numpy(w).requires_grad_() for w in ws]
    bt = [torch.from_numpy(b).requires_grad_() for b in bs]
    _build.reset_counts()
    y = tmf.fused_mlp(xt, wt, bt, acts, compute_dx)
    y.backward(torch.from_numpy(g))
    assert dict(_build.plain_calls) == {"mlp_fused": 1, "mlp_fused_bwd": 1}
    assert not _build.launches
    _close(y, y_j, F32_TOL)
    _close(xt.grad, dx_j, F32_TOL)
    if not compute_dx:
        assert not xt.grad.any()
    for got, want in zip([t.grad for t in wt + bt], list(dws_j) + list(dbs_j)):
        _close(got, want, F32_TOL)


@pytest.mark.parametrize("acts", ACT_SETS)
@pytest.mark.parametrize("c0", [27, 32])
def test_fused_mlp_bf16_against_pallas(c0, acts):
    x, ws, bs, g = _case(c0, 1)
    xj = jnp.asarray(x, jnp.bfloat16)
    wj, bj, gj = [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs], jnp.asarray(g)
    jpk.INTERPRET = True
    try:
        y_j = jmf._mlp_fwd_pallas(xj, wj, bj, acts)
        dx_j, dws_j, dbs_j = jmf._mlp_bwd_pallas(xj, gj, wj, bj, acts, True)
    finally:
        jpk.INTERPRET = False
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    wt, bt = [torch.from_numpy(w) for w in ws], [torch.from_numpy(b) for b in bs]
    y = tmf._mlp_fwd_plain(xt, wt, bt, acts)
    assert y.dtype == torch.bfloat16
    _close(y, y_j, BF16_TOL)
    dx, dws, dbs = tmf._mlp_bwd_plain(xt, torch.from_numpy(g), wt, bt, acts, True)
    assert dx.dtype == torch.bfloat16 and all(d.dtype == torch.float32 for d in dws + dbs)
    _close(dx, dx_j, BF16_TOL)
    for got, want in zip(dws + dbs, list(dws_j) + list(dbs_j)):
        _close(got, want.reshape(got.shape), BF16_TOL)
    # without d(x): the same weight gradients
    none, dws2, dbs2 = tmf.mlp_fused_bwd(xt, torch.from_numpy(g), wt, bt, acts, False)
    assert none is None
    for a, b in zip(dws + dbs, dws2 + dbs2):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the autograd Function runs the same plain versions
    params = [w.clone().requires_grad_() for w in wt + bt]
    xg = xt.clone().requires_grad_()
    out = tmf.fused_mlp(xg, params[:3], params[3:], acts)
    grads = torch.autograd.grad(out, [xg] + params, torch.from_numpy(g).to(torch.bfloat16))
    torch.testing.assert_close(out, y, rtol=0, atol=0)
    for a, b in zip(grads, [dx] + dws + dbs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_fused_mlp_rejects_mismatched_lists():
    x, ws, bs, _ = _case(32, 2, n=8)
    with pytest.raises(ValueError):
        tmf.fused_mlp(torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
                      [torch.from_numpy(b) for b in bs], ("relu",))
    with pytest.raises(ValueError):
        tmf._act("gelu", torch.zeros(1))


@pytest.mark.parametrize("compute_dx", [True, False])
def test_pixel_mlp(compute_dx):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 5, 4, 29)).astype(np.float32)
    feats, acts = (32, 32, 32), ("leaky_relu",) * 3
    jm = JPixelMLP(feats, acts, compute_dx=compute_dx)
    params = jm.init(jax.random.PRNGKey(4), jnp.asarray(x))["params"]
    tm = convert.load_flax_params(TPixelMLP(29, feats, acts, compute_dx=compute_dx), params)
    assert [p for p, _ in jax.tree_util.tree_leaves_with_path(convert.to_flax(tm))] == \
        [p for p, _ in jax.tree_util.tree_leaves_with_path(params)]
    g = rng.standard_normal((2, 3, 5, 4, 32)).astype(np.float32)
    y_j, vjp = jax.vjp(lambda p, x_: jm.apply({"params": p}, x_), params, jnp.asarray(x))
    dp_j, dx_j = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    y = tm(xt)
    y.backward(torch.from_numpy(g))
    _close(y, y_j, F32_TOL)
    _close(xt.grad, dx_j, F32_TOL)
    got = jax.tree_util.tree_leaves(convert.grads_to_flax(tm))
    for a, b in zip(got, jax.tree_util.tree_leaves(dp_j)):
        _close(a, b, F32_TOL)
