"""Parity of the softmax gather's backward in the port (the plain
versions of kernels K2 and K3, and the autograd Function around K1) with
wcmc_tpu.

* ``outer_softmax_plain`` (d logits) and ``scatter_softmax_plain``
  (d buf) against the XLA composition of ``_gather_sm_bwd`` at K = 5
  and K = 21, f32: within 1e-5 of max |ref| (same math, other order).
* The same against ``outer_softmax_tpu`` and ``scatter_tpu(softmax=True)``
  in interpret mode at K = 5 with bf16 logits: d buf (f32 from the same
  bf16 logit values) within 1e-5; d logits, rounded once to bf16 on both
  sides, within 1e-2 (an f32 value summed in another order can round to
  the neighbouring bf16 value, 2^-8 relative).
* ``torch.autograd.grad`` of the port's ``kernel_gather_softmax`` with
  the buffer requiring grad against ``jax.vjp`` of wcmc_tpu's, f32,
  within 1e-5.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wcmc_tpu_torch.ops import _build
from wcmc_tpu_torch.ops import kernel_apply as tka

# the wcmc_tpu.ops package re-exports a function named kernel_apply
jka = importlib.import_module("wcmc_tpu.ops.kernel_apply")
jmf = importlib.import_module("wcmc_tpu.ops.mlp_fused")
jpk = importlib.import_module("wcmc_tpu.ops.pallas_kernels")

F32_TOL, BF16_OUT_TOL = 1e-5, 1e-2


def _inputs(ksize, h, w, dtype="float32", seed=0, b=2, c=3):
    rng = np.random.default_rng(seed)
    buf = rng.standard_normal((b, h + ksize - 1, w + ksize - 1, c)).astype(np.float32)
    logits = (2.0 * rng.standard_normal((b, h, w, ksize * ksize))).astype(np.float32)
    g = rng.standard_normal((b, h, w, c)).astype(np.float32)
    lt = torch.from_numpy(logits).to(getattr(torch, dtype))
    return buf, lt.float().numpy(), g, lt


def _close(got, want, tol):
    got = np.asarray(torch.as_tensor(got).detach().float(), np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want))


@pytest.mark.parametrize("ksize,h,w", [(5, 9, 11), (21, 6, 5)])
def test_plain_backward_matches_xla(ksize, h, w):
    buf, logits, g, lt = _inputs(ksize, h, w)
    want_dbuf, want_dlogits = jka._gather_sm_bwd(
        ksize, (jnp.asarray(buf), jnp.asarray(logits)), jnp.asarray(g))
    _close(tka.outer_softmax_plain(torch.from_numpy(g), torch.from_numpy(buf), lt, ksize),
           want_dlogits, F32_TOL)
    _close(tka.scatter_softmax_plain(torch.from_numpy(g), lt, ksize), want_dbuf, F32_TOL)


def _pallas(fn, *args, **kw):
    jpk.INTERPRET, jmf.FORCE_PALLAS = True, True
    try:
        return fn(*args, **kw)
    finally:
        jpk.INTERPRET, jmf.FORCE_PALLAS = False, False


def test_plain_backward_matches_pallas_bf16():
    ksize = 5
    buf, _, g, lt = _inputs(ksize, 16, 12, "bfloat16", seed=1)
    jl = jnp.asarray(lt.float().numpy(), jnp.bfloat16)
    want_dlogits = _pallas(jpk.outer_softmax_tpu, jnp.asarray(g), jnp.asarray(buf), jl, ksize)
    want_dbuf = _pallas(jpk.scatter_tpu, jnp.asarray(g), jl, ksize, softmax=True)
    got = tka.outer_softmax_plain(torch.from_numpy(g), torch.from_numpy(buf), lt, ksize)
    assert got.dtype == torch.bfloat16 and want_dlogits.dtype == jnp.bfloat16
    _close(got, want_dlogits, BF16_OUT_TOL)
    _close(tka.scatter_softmax_plain(torch.from_numpy(g), lt, ksize), want_dbuf, F32_TOL)


@pytest.mark.parametrize("ksize", [5, 21])
def test_autograd_matches_jax_vjp(ksize):
    buf, logits, g, _ = _inputs(ksize, 7, 6, seed=2)
    _, vjp = jax.vjp(lambda b, lg: jka.kernel_gather_softmax(b, lg, ksize),
                     jnp.asarray(buf), jnp.asarray(logits))
    want_dbuf, want_dlogits = vjp(jnp.asarray(g))
    tb = torch.from_numpy(buf).requires_grad_()
    tlg = torch.from_numpy(logits).requires_grad_()
    out = tka.kernel_gather_softmax(tb, tlg, ksize)
    _build.reset_counts()
    dbuf, dlogits = torch.autograd.grad(out, [tb, tlg], torch.from_numpy(g))
    assert dict(_build.plain_calls) == {"outer_softmax": 1, "scatter_softmax": 1}
    assert not _build.launches
    _close(dbuf, want_dbuf, F32_TOL)
    _close(dlogits, want_dlogits, F32_TOL)


def test_data_buffer_skips_the_buffer_gradient():
    """A buffer that does not require grad (the KPCN case) runs only the
    d(logits) half; a strided crop of the logits gets its gradient back
    through the crop."""
    buf, logits, g, _ = _inputs(5, 6, 7, seed=3)
    full = torch.zeros((2, 10, 11, 25)).requires_grad_()
    with torch.no_grad():
        full[:, 2:8, 1:8] = torch.from_numpy(logits)
    crop = full[:, 2:8, 1:8]
    out = tka.kernel_gather_softmax(torch.from_numpy(buf), crop, 5)
    _build.reset_counts()
    (dfull,) = torch.autograd.grad(out, [full], torch.from_numpy(g))
    assert dict(_build.plain_calls) == {"outer_softmax": 1}
    want = tka.outer_softmax_plain(torch.from_numpy(g), torch.from_numpy(buf),
                                   torch.from_numpy(logits), 5)
    torch.testing.assert_close(dfull[:, 2:8, 1:8], want, rtol=0, atol=0)
    outside = dfull.clone()
    outside[:, 2:8, 1:8] = 0
    assert not outside.any()


def test_backward_kernels_refuse_mixed_devices():
    buf, logits, g, _ = _inputs(5, 4, 4)
    with pytest.raises(ValueError):
        tka.outer_softmax(torch.from_numpy(g), torch.from_numpy(buf),
                          torch.from_numpy(logits).to("meta"), 5)
    with pytest.raises(ValueError):
        tka.scatter_softmax(torch.from_numpy(g), torch.from_numpy(logits)[:, :3], 5)
