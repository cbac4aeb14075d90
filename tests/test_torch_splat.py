"""Parity of the port's splat with wcmc_tpu: the splat primitive (kernel
K7's plain version ``scatter_plain``) and its CPU VJP, the plain weighted
gather, and the normalized splats of ``ops/splat.py``.

* ``scatter_plain`` and ``kernel_scatter``'s VJP against the XLA
  reference ``_scatter_xla`` / ``jax.vjp(kernel_scatter)``, and the
  forward against the Pallas kernel ``scatter_tpu`` in interpret mode: f32,
  within 1e-5 of max |ref| (the same products summed in another order).
* ``kernel_apply(softmax=False)`` (the plain weighted gather,
  ``kernel_gather``) and its VJP against ``jax.vjp(kernel_gather)``:
  1e-5.
* ``kernel_splat``, ``splat_normalized`` and ``splat_normalized_logits``
  (outputs and the VJP in values and logits) against
  ``wcmc_tpu.ops.splat``, with ordinary logits, large ones (one spike
  40 above the rest, which the per-pixel stabilization must absorb) and
  all logits shifted by +123 (the output is shift-invariant): f32, 1e-5.

K = 5 throughout; interpreting the 441-tap Pallas scatter takes minutes.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wcmc_tpu_torch.ops import _build
from wcmc_tpu_torch.ops import kernel_apply as tka
from wcmc_tpu_torch.ops import splat as tsp

# the wcmc_tpu.ops package re-exports a function named kernel_apply
jka = importlib.import_module("wcmc_tpu.ops.kernel_apply")
jmf = importlib.import_module("wcmc_tpu.ops.mlp_fused")
jpk = importlib.import_module("wcmc_tpu.ops.pallas_kernels")
jsp = importlib.import_module("wcmc_tpu.ops.splat")

TOL = 1e-5
K = 5


def _close(got, want, tol=TOL):
    got = np.asarray(torch.as_tensor(got).detach(), np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want))


def _splat_inputs(seed, b=2, h=11, w=13, c=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    wt = rng.random((b, h, w, K * K)).astype(np.float32)
    g = rng.standard_normal((b, h + K - 1, w + K - 1, c)).astype(np.float32)
    return x, wt, g


def test_scatter_plain_matches_xla():
    x, wt, _ = _splat_inputs(0)
    want = jka._scatter_xla(jnp.asarray(x), jnp.asarray(wt), K)
    _build.reset_counts()
    got = tka.kernel_scatter(torch.from_numpy(x), torch.from_numpy(wt), K)
    assert dict(_build.plain_calls) == {"scatter": 1} and not _build.launches
    assert got.shape == (2, 11 + K - 1, 13 + K - 1, 4) and got.dtype == torch.float32
    _close(got, want)


def test_scatter_plain_matches_pallas_interpret():
    x, wt, _ = _splat_inputs(1, h=16, w=12)
    jpk.INTERPRET, jmf.FORCE_PALLAS = True, True
    try:
        want = jpk.scatter_tpu(jnp.asarray(x), jnp.asarray(wt), K)
    finally:
        jpk.INTERPRET, jmf.FORCE_PALLAS = False, False
    _close(tka.scatter_plain(torch.from_numpy(x), torch.from_numpy(wt), K), want)


def test_scatter_vjp_matches_jax():
    """``dx = gather(g, w)`` and ``dw = outer(x, g)``, as the reference's
    ``_scatter_bwd`` composes them."""
    x, wt, g = _splat_inputs(2)
    _, vjp = jax.vjp(lambda a, b: jka.kernel_scatter(a, b, K), jnp.asarray(x), jnp.asarray(wt))
    want_dx, want_dw = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    wtt = torch.from_numpy(wt).requires_grad_()
    out = tka.kernel_scatter(xt, wtt, K)
    _build.reset_counts()
    dx, dw = torch.autograd.grad(out, [xt, wtt], torch.from_numpy(g))
    assert dict(_build.plain_calls) == {"gather": 1, "outer": 1} and not _build.launches
    _close(dx, want_dx)
    _close(dw, want_dw)


def test_weighted_gather_and_its_vjp_match_jax():
    rng = np.random.default_rng(3)
    buf = rng.standard_normal((2, 9 + K - 1, 10 + K - 1, 3)).astype(np.float32)
    wt = rng.standard_normal((2, 9, 10, K * K)).astype(np.float32)
    g = rng.standard_normal((2, 9, 10, 3)).astype(np.float32)
    want, vjp = jax.vjp(lambda a, b: jka.kernel_apply(a, b, K, softmax=False),
                        jnp.asarray(buf), jnp.asarray(wt))
    want_db, want_dw = vjp(jnp.asarray(g))
    bt = torch.from_numpy(buf).requires_grad_()
    wtt = torch.from_numpy(wt).requires_grad_()
    _build.reset_counts()
    out = tka.kernel_apply(bt, wtt, K, softmax=False)
    db, dw = torch.autograd.grad(out, [bt, wtt], torch.from_numpy(g))
    # kernel_gather's VJP: d(buf) by the splat, d(w) by the outer product
    assert dict(_build.plain_calls) == {"gather": 1, "scatter": 1, "outer": 1}
    _close(out, want)
    _close(db, want_db)
    _close(dw, want_dw)


def test_kernel_splat_matches_jax():
    x, wt, _ = _splat_inputs(4)
    want = jsp.kernel_splat(jnp.asarray(x), jnp.asarray(wt), K)
    got = tsp.kernel_splat(torch.from_numpy(x), torch.from_numpy(wt), K)
    assert got.shape == x.shape
    _close(got, want)


def _sample_inputs(seed, case, b=2, s=3, h=12, w=10):
    rng = np.random.default_rng(seed)
    values = (2.0 * rng.random((b, s, h, w, 3))).astype(np.float32)
    logits = (3.0 * rng.standard_normal((b, s, h, w, K * K))).astype(np.float32)
    if case == "spike":
        logits[0, 1, 5, 4, 7] += 40.0
    elif case == "shift":
        logits += 123.0
    g = rng.standard_normal((b, h, w, 3)).astype(np.float32)
    return values, logits, g


def test_splat_normalized_matches_jax():
    values, logits, g = _sample_inputs(5, "plain")
    weights = np.exp(logits / 3.0).astype(np.float32)
    fn_j = lambda v, wt: jsp.splat_normalized(v, wt, K)  # noqa: E731
    want, vjp = jax.vjp(fn_j, jnp.asarray(values), jnp.asarray(weights))
    vt = torch.from_numpy(values).requires_grad_()
    wtt = torch.from_numpy(weights).requires_grad_()
    got = tsp.splat_normalized(vt, wtt, K)
    _close(got, want)
    for a, b in zip(torch.autograd.grad(got, [vt, wtt], torch.from_numpy(g)),
                    vjp(jnp.asarray(g))):
        _close(a, b)


@pytest.mark.parametrize("case", ["plain", "spike", "shift"])
def test_splat_normalized_logits_matches_jax(case):
    values, logits, g = _sample_inputs(6, case)
    fn_j = lambda v, lg: jsp.splat_normalized_logits(v, lg, K, eps=1e-12)  # noqa: E731
    want, vjp = jax.vjp(fn_j, jnp.asarray(values), jnp.asarray(logits))
    vt = torch.from_numpy(values).requires_grad_()
    lt = torch.from_numpy(logits).requires_grad_()
    got = tsp.splat_normalized_logits(vt, lt, K, eps=1e-12)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    _close(got, want)
    for a, b in zip(torch.autograd.grad(got, [vt, lt], torch.from_numpy(g)),
                    vjp(jnp.asarray(g))):
        _close(a, b)
    if case == "shift":   # the +123 shift cancels in the normalized ratio
        plain = _sample_inputs(6, "plain")[1]
        ref = tsp.splat_normalized_logits(vt.detach(), torch.from_numpy(plain), K, eps=1e-12)
        _close(got, ref.numpy(), 1e-5)


def test_splat_checks_its_geometry():
    x, wt, _ = _splat_inputs(7)
    with pytest.raises(ValueError):
        tka.kernel_scatter(torch.from_numpy(x), torch.from_numpy(wt[..., :-1]), K)
    with pytest.raises(ValueError):
        tka.kernel_scatter(torch.from_numpy(x), torch.from_numpy(wt), 4)
