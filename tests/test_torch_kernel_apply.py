"""Parity of the port's softmax gather (kernel K1's plain version) with
wcmc_tpu: the XLA reference ``kernel_apply_reference`` and the Pallas
kernel ``gather_tpu(softmax=True)`` in interpret mode.

Tolerances: 1e-5 relative (of max |ref|) with f32 logits — the same
math summed in another order; 1e-3 with bf16 logits, where the
reference's softmax runs in bf16 (XLA path) or the logits are read as
bf16 and summed in another order (Pallas path).

K=21 is held against the XLA reference; the interpret-mode Pallas legs
use K=5 and K=9, because interpreting the 441-tap kernel takes minutes
on a CPU."""

import importlib

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

TOL = {"float32": 1e-5, "bfloat16": 1e-3}


def _inputs(ksize, h, w, dtype, seed=0, b=2, c=3):
    rng = np.random.default_rng(seed)
    buf = rng.standard_normal((b, h + ksize - 1, w + ksize - 1, c)).astype(np.float32)
    logits = (2.0 * rng.standard_normal((b, h, w, ksize * ksize))).astype(np.float32)
    lt = torch.from_numpy(logits).to(getattr(torch, dtype))
    # both sides see the same (possibly bf16-rounded) logit values
    logits = lt.float().numpy()
    return buf, logits, lt


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ksize,h,w", [(5, 11, 13), (21, 9, 12)])
def test_plain_matches_xla_reference(ksize, h, w, dtype):
    buf, logits, lt = _inputs(ksize, h, w, dtype)
    jl = jnp.asarray(logits, dtype=getattr(jnp, dtype))
    want = jka.kernel_apply_reference(jnp.asarray(buf), jl.astype(jnp.float32), ksize)
    got = tka.kernel_gather_softmax(torch.from_numpy(buf), lt, ksize)
    assert got.dtype == torch.float32
    _close(got.numpy(), want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ksize,h,w", [(5, 11, 13), (9, 12, 12)])
def test_plain_matches_pallas_interpret(ksize, h, w, dtype):
    buf, logits, lt = _inputs(ksize, h, w, dtype, seed=1)
    jpk.INTERPRET, jmf.FORCE_PALLAS = True, True
    try:
        want = jpk.gather_tpu(jnp.asarray(buf),
                              jnp.asarray(logits, dtype=getattr(jnp, dtype)),
                              ksize, softmax=True)
    finally:
        jpk.INTERPRET, jmf.FORCE_PALLAS = False, False
    got = tka.kernel_gather_softmax(torch.from_numpy(buf), lt, ksize)
    _close(got.numpy(), want, TOL[dtype])


def test_reference_api_matches_jax():
    """kernel_apply_reference (softmax in the logits' dtype) and
    kernel_apply, with and without the softmax, agree with their wcmc_tpu
    counterparts."""
    buf, logits, lt = _inputs(5, 7, 9, "float32", seed=2)
    want = jka.kernel_apply_reference(jnp.asarray(buf), jnp.asarray(logits), 5)
    got = tka.kernel_apply_reference(torch.from_numpy(buf), lt, 5)
    _close(got.numpy(), want, TOL["float32"])
    got2 = tka.kernel_apply(torch.from_numpy(buf), lt, 5)
    _close(got2.numpy(), want, TOL["float32"])
    want3 = jka.kernel_apply(jnp.asarray(buf), jnp.asarray(logits), 5, softmax=False)
    got3 = tka.kernel_apply(torch.from_numpy(buf), lt, 5, softmax=False)
    _close(got3.numpy(), want3, TOL["float32"])


def test_strided_logits_view():
    """The logits may be a cropped view with contiguous taps (what the
    KPCN convolution hands over)."""
    buf, logits, lt = _inputs(5, 8, 8, "float32", seed=3)
    big = torch.zeros((2, 12, 14, 25))
    big[:, 2:10, 3:11] = lt
    view = big[:, 2:10, 3:11]
    assert not view.is_contiguous() and view.stride(-1) == 1
    got = tka.kernel_gather_softmax(torch.from_numpy(buf), view, 5)
    want = tka.kernel_gather_softmax(torch.from_numpy(buf), lt, 5)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_plain_version_counts_and_geometry_checks():
    buf, logits, lt = _inputs(5, 4, 4, "float32")
    _build.reset_counts()
    tka.kernel_gather_softmax(torch.from_numpy(buf), lt, 5)
    assert _build.plain_calls["gather_softmax"] == 1
    assert _build.launches["gather_softmax"] == 0
    with pytest.raises(ValueError):
        tka.kernel_gather_softmax(torch.from_numpy(buf), lt[:, :3], 5)
