"""K2 (the softmax gather's d logits) and K8 (the tap-wise outer product)
above K = 21, on the CPU (the kernels run only on the card:
``tests/test_torch_kernels_gpu.py``).

* ``outer_plain`` against ``wcmc_tpu``'s ``_outer_xla``, and
  ``outer_softmax_plain`` against ``wcmc_tpu``'s XLA VJP of the softmax
  gather (``_gather_sm_bwd``), at K = 23, 25 and 31: f32 within 1e-5 of
  max |ref| (the same f32 products summed in another order); d logits of
  bf16 logits, rounded once to bf16 on both sides, within 1e-2 (an f32
  value summed in another order can round to the neighbouring bf16 value).
  The Pallas kernels are not interpreted at these K: that takes minutes.
* ``outer_plan``, ``outer_softmax_plan`` and ``outer_softmax_route``: the
  tiled bodies up to K = 21, the first bodies above, up to K = 129, even K
  included; the refusals at K = 130 and 131.
* The softmax gather's gradient through autograd at K = 23 (the plain
  versions on the CPU) against ``jax.vjp`` of ``wcmc_tpu``'s
  ``kernel_gather_softmax``, and the splat's at K = 25 against
  ``kernel_scatter``'s.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wcmc_tpu_torch.ops import _build
from wcmc_tpu_torch.ops import kernel_apply as ka

# the wcmc_tpu.ops package re-exports a function named kernel_apply
jka = importlib.import_module("wcmc_tpu.ops.kernel_apply")

TOL, BF16_OUT_TOL = 1e-5, 1e-2
LARGE_K = (23, 25, 31)


def _close(got, want, tol=TOL):
    got = np.asarray(torch.as_tensor(got).detach().float(), np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want))


def _inputs(seed, b, h, w, k, c=3):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((b, h, w, c)).astype(np.float32)
    buf = rng.standard_normal((b, h + k - 1, w + k - 1, c)).astype(np.float32)
    logits = (2 * rng.standard_normal((b, h, w, k * k))).astype(np.float32)
    return g, buf, logits


@pytest.mark.parametrize("c", [1, 4, 8])
@pytest.mark.parametrize("k", LARGE_K)
def test_outer_plain_above_k21_is_the_reference(k, c):
    g, buf, _ = _inputs(k + c, 2, 5, 7, k, c)
    got = ka.outer_plain(torch.from_numpy(g), torch.from_numpy(buf), k)
    _close(got, jka._outer_xla(jnp.asarray(g), jnp.asarray(buf), k))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", LARGE_K)
def test_outer_softmax_plain_above_k21_is_the_reference(k, dtype):
    g, buf, logits = _inputs(k, 2, 6, 5, k)
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    got = ka.outer_softmax_plain(torch.from_numpy(g), torch.from_numpy(buf), tl, k)
    assert got.dtype == tl.dtype
    jl = jnp.asarray(tl.float().numpy()).astype(getattr(jnp, dtype))
    _, want = jka._gather_sm_bwd(k, (jnp.asarray(buf), jl), jnp.asarray(g))
    assert want.dtype == jl.dtype
    _close(got, want, TOL if dtype == "float32" else BF16_OUT_TOL)


@pytest.mark.parametrize("k", [5, 13, 20, 21, 22, 23, 24, 25, 31, 64, 129])
def test_plans_pick_the_body_by_k(k):
    """The tiled bodies up to K = 21 (14 taps a lane), the first bodies
    (O(1) taps a lane) above, up to the reference's 129; an even K is no
    refusal."""
    body = "tiled" if k <= ka.SOFTMAX_MAX_K else "warp"
    for es in (2, 4):
        plan = ka.outer_softmax_plan(2, 16, 16, 3, k, es)
        assert plan.body == body
        if body == "warp":
            assert plan == ka.OuterSoftmaxPlan("warp", 0, 0, 0, 0, 0, 0, (), 0)
    for c in range(1, 9):
        plan = ka.outer_plan(c, k)
        assert plan.body == body
        if body == "warp":
            assert plan == ka.OuterPlan("warp", 0, 0, 0, (), 0)
        else:
            assert plan.total > 0


@pytest.mark.parametrize("k", [22, 23, 25, 129])
def test_outer_softmax_route_above_k21(k):
    """K2's route above K = 21 is the first body's, whatever the view."""
    b, h, w = 1, 3, 4
    g, buf = torch.zeros((b, h, w, 3)), torch.zeros((b, h + k - 1, w + k - 1, 3))
    full = torch.zeros((b, k * k, h + 2, w + 2)).to(torch.bfloat16)
    crop = full.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)[:, 1:-1, 1:-1]
    for lg in (torch.zeros((b, h, w, k * k)), crop):
        assert ka.outer_softmax_route(g, buf, lg, k) == ka.SoftmaxRoute("warp", (), "")


@pytest.mark.parametrize("k", [130, 131])
def test_plans_refuse_above_k129(k):
    with pytest.raises(ValueError):
        ka.outer_plan(4, k)
    for es in (2, 4):
        with pytest.raises(ValueError):
            ka.outer_softmax_plan(2, 4, 4, 3, k, es)


def test_softmax_gather_grad_at_k23_is_the_reference():
    """d logits and d buf of the softmax gather at K = 23 through autograd
    (the plain versions of K1, K2 and K3 on the CPU) against ``jax.vjp`` of
    ``wcmc_tpu``'s ``kernel_gather_softmax`` (its XLA path), in f32."""
    k = 23
    g, buf, logits = _inputs(5, 2, 4, 6, k)
    tb, tl = torch.from_numpy(buf).requires_grad_(), torch.from_numpy(logits).requires_grad_()
    _build.reset_counts()
    out = ka.kernel_gather_softmax(tb, tl, k)
    dbuf, dlogits = torch.autograd.grad(out, [tb, tl], torch.from_numpy(g))
    assert dict(_build.plain_calls) == {"gather_softmax": 1, "outer_softmax": 1,
                                        "scatter_softmax": 1}
    jout, vjp = jax.vjp(lambda b_, l_: jka.kernel_gather_softmax(b_, l_, k),
                        jnp.asarray(buf), jnp.asarray(logits))
    jbuf, jlogits = vjp(jnp.asarray(g))
    _close(out, jout)
    _close(dbuf, jbuf)
    _close(dlogits, jlogits)


def test_splat_grad_at_k25_is_the_reference():
    """d weights (K8's plain version) and d values (K9's) of the splat at K =
    25 through autograd against ``jax.vjp`` of ``kernel_scatter``, in f32."""
    k = 25
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 5, 4, 4)).astype(np.float32)
    wt = rng.random((1, 5, 4, k * k)).astype(np.float32)
    gc = rng.standard_normal((1, 5 + k - 1, 4 + k - 1, 4)).astype(np.float32)
    tx, tw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(wt).requires_grad_()
    _build.reset_counts()
    dx, dw = torch.autograd.grad(ka.kernel_scatter(tx, tw, k), [tx, tw], torch.from_numpy(gc))
    assert dict(_build.plain_calls) == {"scatter": 1, "outer": 1, "gather": 1}
    _, vjp = jax.vjp(lambda x_, w_: jka.kernel_scatter(x_, w_, k), jnp.asarray(x),
                     jnp.asarray(wt))
    jdx, jdw = vjp(jnp.asarray(gc))
    _close(dx, jdx)
    _close(dw, jdw)
