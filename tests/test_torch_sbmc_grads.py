"""Parity of the SBMC training step's backward pieces in the port with
wcmc_tpu: the plain versions of kernels K8 (the splat's weight gradient)
and K9 (the weighted gather), the weighted gather's VJP, and the SBMC
forms of K4-bwd and K5-bwd.

* ``outer_plain`` and ``gather_plain`` against ``_outer_xla`` /
  ``_gather_xla`` and against ``outer_tpu`` / ``gather_tpu(softmax=False)``
  in interpret mode (``pk.INTERPRET``, reset in ``finally``), f32: within
  1e-5 of max |ref| (the same products summed in another order).
* ``kernel_apply(softmax=False)`` (``kernel_gather``) and its gradients
  against ``jax.vjp`` of ``wcmc_tpu``'s ``kernel_apply(softmax=False)``
  with f32 weights (1e-5) and bf16 weights (the output and d(buf) 1e-5:
  the weights are read exactly and the math is f32; d(w) 1e-2, one
  rounding of an f32 value to bf16, which another summation order can
  move by one bf16 step).
* The Multisteps embedding backward (95 -> 32 -> 32 -> 32, leaky relu x 3,
  ``compute_dx=True``) and update-chain backward ([32 | 32] -> 32 -> 32,
  leaky relu, Cout 32, a channels-last output cotangent in the compute
  dtype, the ``gsum`` cotangent without ``gsq``, or no moments): f32
  against ``jax.vjp`` of ``wcmc_tpu``'s ``pathnet_embed`` /
  ``pathnet_head`` (its XLA path), within 1e-5 of max |ref|; bf16
  against ``_embed_bwd_pallas`` / ``_head_bwd_pallas`` in interpret mode,
  within 2e-2 of max |ref| (a bf16 hidden or cotangent summed in another
  order can round to a neighbouring value).

K = 5 and widths of 32 keep the interpreted kernels cheap.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wcmc_tpu_torch.ops import _build
from wcmc_tpu_torch.ops import kernel_apply as tka
from wcmc_tpu_torch.ops import pathnet_fused as tpf

# the wcmc_tpu.ops package re-exports a function named kernel_apply
jka = importlib.import_module("wcmc_tpu.ops.kernel_apply")
jmf = importlib.import_module("wcmc_tpu.ops.mlp_fused")
jpf = importlib.import_module("wcmc_tpu.ops.pathnet_fused")
jpk = importlib.import_module("wcmc_tpu.ops.pallas_kernels")

F32_TOL, BF16_TOL, BF16_ROUND_TOL = 1e-5, 2e-2, 1e-2
K = 5
LEAKY = ("leaky_relu",) * 3
B, S, HW, C = 2, 3, 40, 32


def _close(got, want, tol):
    got = np.asarray(torch.as_tensor(got).detach().float(), np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want))


def _pallas(fn, *args, **kw):
    jpk.INTERPRET, jmf.FORCE_PALLAS = True, True
    try:
        return fn(*args, **kw)
    finally:
        jpk.INTERPRET, jmf.FORCE_PALLAS = False, False


def _params(rng, dims):
    ws = [(rng.standard_normal((ci, co)) / np.sqrt(ci)).astype(np.float32)
          for ci, co in zip(dims[:-1], dims[1:])]
    bs = [(0.1 * rng.standard_normal(co)).astype(np.float32) for co in dims[1:]]
    return ws, bs


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _t(arrs, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrs]


# ---------------------------------------------------------------------------
# K8 and K9: the outer product and the weighted gather
# ---------------------------------------------------------------------------

def _gather_case(seed, b=2, h=12, w=11, c=4):
    rng = np.random.default_rng(seed)
    buf = rng.standard_normal((b, h + K - 1, w + K - 1, c)).astype(np.float32)
    wt = rng.random((b, h, w, K * K)).astype(np.float32)
    g = rng.standard_normal((b, h, w, c)).astype(np.float32)
    return buf, wt, g


@pytest.mark.parametrize("oracle", ["xla", "pallas"])
def test_outer_plain_matches_reference(oracle):
    """dw[p, d] = sum_c g[p, c] buf[p + d, c], as the splat's backward
    calls it: outer(x, canvas cotangent)."""
    buf, _, g = _gather_case(0, h=16, w=12)
    if oracle == "xla":
        want = jka._outer_xla(jnp.asarray(g), jnp.asarray(buf), K)
    else:
        want = _pallas(jpk.outer_tpu, jnp.asarray(g), jnp.asarray(buf), K)
    _build.reset_counts()
    got = tka.outer(torch.from_numpy(g), torch.from_numpy(buf), K)
    assert dict(_build.plain_calls) == {"outer": 1} and not _build.launches
    assert got.shape == (2, 16, 12, K * K) and got.dtype == torch.float32
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("oracle", ["xla", "pallas"])
def test_gather_plain_matches_reference(oracle):
    buf, wt, _ = _gather_case(1)
    if oracle == "xla":
        want = jka._gather_xla(jnp.asarray(buf), jnp.asarray(wt), K)
    else:
        want = _pallas(jpk.gather_tpu, jnp.asarray(buf), jnp.asarray(wt), K, softmax=False)
    _build.reset_counts()
    got = tka.gather(torch.from_numpy(buf), torch.from_numpy(wt), K)
    assert dict(_build.plain_calls) == {"gather": 1} and not _build.launches
    assert got.dtype == torch.float32
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_gather_vjp_matches_jax(dtype):
    buf, wt, g = _gather_case(2, h=9, w=13, c=3)
    tw = torch.from_numpy(wt).to(getattr(torch, dtype))
    jw = jnp.asarray(wt, getattr(jnp, dtype))
    want, vjp = jax.vjp(lambda a, b: jka.kernel_apply(a, b, K, softmax=False),
                        jnp.asarray(buf), jw)
    want_db, want_dw = vjp(jnp.asarray(g))
    tb = torch.from_numpy(buf).requires_grad_()
    tw.requires_grad_()
    _build.reset_counts()
    out = tka.kernel_apply(tb, tw, K, softmax=False)
    db, dw = torch.autograd.grad(out, [tb, tw], torch.from_numpy(g))
    assert dict(_build.plain_calls) == {"gather": 1, "scatter": 1, "outer": 1}
    assert out.dtype == torch.float32 and db.dtype == torch.float32
    assert dw.dtype == tw.dtype and want_dw.dtype == jw.dtype
    _close(out, want, F32_TOL)
    _close(db, want_db, F32_TOL)
    _close(dw, want_dw, F32_TOL if dtype == "float32" else BF16_ROUND_TOL)


def test_kernel_gather_checks_its_geometry():
    buf, wt, _ = _gather_case(3)
    with pytest.raises(ValueError):
        tka.kernel_gather(torch.from_numpy(buf), torch.from_numpy(wt[..., :-1]), K)
    with pytest.raises(ValueError):
        tka.outer(torch.from_numpy(buf[:, :3]), torch.from_numpy(buf), K)


# ---------------------------------------------------------------------------
# the SBMC forms of K4-bwd and K5-bwd
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def embed_case():
    rng = np.random.default_rng(17)
    x = rng.standard_normal((B, S, HW, 95)).astype(np.float32)
    ws, bs = _params(rng, (95, C, C, C))
    ge = rng.standard_normal((B, S, HW, C)).astype(np.float32)
    gmean = rng.standard_normal((B, HW, C)).astype(np.float32)
    return x, ws, bs, ge, gmean


def _torch_embed_grads(x, ws, bs, ge, gmean, dtype):
    tx = torch.from_numpy(x).to(dtype).requires_grad_()
    tws, tbs = _t(ws, True), _t(bs, True)
    e, mean = tpf.pathnet_embed(tx, tws, tbs, LEAKY, compute_dx=True)
    _build.reset_counts()
    grads = torch.autograd.grad([e, mean], [tx, *tws, *tbs],
                                [torch.from_numpy(ge).to(dtype), torch.from_numpy(gmean)])
    assert dict(_build.plain_calls) == {"pathnet_embed_bwd": 1}
    assert grads[0].dtype == dtype
    return grads


def test_leaky_embed_backward_matches_xla_f32(embed_case):
    x, ws, bs, ge, gmean = embed_case
    _, vjp = jax.vjp(lambda x_, w_, b_: jpf.pathnet_embed(x_, w_, b_, LEAKY, True),
                     jnp.asarray(x), _j(ws), _j(bs))
    jdx, jws, jbs = vjp((jnp.asarray(ge), jnp.asarray(gmean)))
    got = _torch_embed_grads(x, ws, bs, ge, gmean, torch.float32)
    for g, w in zip(got, [jdx, *jws, *jbs]):
        _close(g, w, F32_TOL)


def test_leaky_embed_backward_matches_pallas_bf16(embed_case):
    x, ws, bs, ge, gmean = embed_case
    jdx, jws, jbs = _pallas(jpf._embed_bwd_pallas, jnp.asarray(x, jnp.bfloat16),
                            jnp.asarray(ge, jnp.bfloat16), jnp.asarray(gmean), _j(ws), _j(bs),
                            LEAKY, True)
    got = _torch_embed_grads(x, ws, bs, ge, gmean, torch.bfloat16)
    for g, w in zip(got, [jdx, *jws, *jbs]):
        _close(g, w, BF16_TOL)


@pytest.fixture(scope="module")
def head_case():
    rng = np.random.default_rng(18)
    e = rng.standard_normal((B, S, HW, C)).astype(np.float32)
    ctx = rng.standard_normal((B, HW, C)).astype(np.float32)
    ws, bs = _params(rng, (2 * C, C, C))
    g = rng.standard_normal((B, S, HW, C)).astype(np.float32)      # channels-last
    gsum = rng.standard_normal((B, HW, C)).astype(np.float32)
    return e, ctx, ws, bs, g, gsum


def _torch_head_grads(case, dtype, moments):
    e, ctx, ws, bs, g, gsum = case
    te = torch.from_numpy(e).to(dtype).requires_grad_()
    tctx = torch.from_numpy(ctx).requires_grad_()
    tws, tbs = _t(ws, True), _t(bs, True)
    res = tpf.pathnet_head(te, tctx, tws, tbs, LEAKY[:2], moments, out_dtype=dtype)
    # the update chain's sum of squares is unused: its cotangent is None
    outs, cots = ((res[0], res[1]), (torch.from_numpy(g).to(dtype), torch.from_numpy(gsum))
                  ) if moments else ((res,), (torch.from_numpy(g).to(dtype),))
    _build.reset_counts()
    grads = torch.autograd.grad(outs, [te, tctx, *tws, *tbs], cots)
    assert dict(_build.plain_calls) == {"pathnet_head_bwd": 1}
    assert grads[0].dtype == dtype
    return grads


@pytest.mark.parametrize("moments", [True, False])
def test_wide_head_backward_matches_xla_f32(head_case, moments):
    e, ctx, ws, bs, g, gsum = head_case
    _, vjp = jax.vjp(lambda e_, c_, w_, b_: jpf.pathnet_head(e_, c_, w_, b_, LEAKY[:2], moments,
                                                             jnp.float32),
                     jnp.asarray(e), jnp.asarray(ctx), _j(ws), _j(bs))
    cot = (jnp.asarray(g), jnp.asarray(gsum), jnp.zeros_like(jnp.asarray(gsum))) if moments \
        else jnp.asarray(g)
    jde, jdctx, jws, jbs = vjp(cot)
    got = _torch_head_grads(head_case, torch.float32, moments)
    for gt, w in zip(got, [jde, jdctx, *jws, *jbs]):
        _close(gt, w, F32_TOL)


@pytest.mark.parametrize("moments", [True, False])
def test_wide_head_backward_matches_pallas_bf16(head_case, moments):
    e, ctx, ws, bs, g, gsum = head_case
    gb = jnp.asarray(g, jnp.bfloat16)
    gs, gq = (jnp.asarray(gsum), jnp.zeros((B, HW, C), jnp.float32)) if moments else (None, None)
    jde, jdctx, jws, jbs = _pallas(jpf._head_bwd_pallas, jnp.asarray(e, jnp.bfloat16),
                                   jnp.asarray(ctx), gb, gs, gq, _j(ws), _j(bs), LEAKY[:2],
                                   moments, False)
    got = _torch_head_grads(head_case, torch.bfloat16, moments)
    for gt, w in zip(got, [jde, jdctx, *jws, *jbs]):
        _close(gt, w, BF16_TOL)


def test_backward_forms_on_the_card_are_checked():
    """What the card's K4-bwd and K5-bwd compute is decided on the host,
    before anything launches: a chain of neither form raises ValueError."""
    assert tpf._embed_bwd_form(tpf.EMBED_ACTS, False) == ((1, 1, 0), False)
    assert tpf._embed_bwd_form(LEAKY, True) == ((2, 2, 2), True)
    assert tpf._embed_bwd_form(LEAKY, False) == ((2, 2, 2), True)
    with pytest.raises(ValueError):
        tpf._embed_bwd_form(("leaky_relu", "relu", "linear"), False)
    with pytest.raises(ValueError):   # PathNet's paths are data: no d(x)
        tpf._embed_bwd_form(tpf.EMBED_ACTS, True)
    assert tpf._head_bwd_form(tpf.HEAD_ACTS, 6, torch.float32) == (16, torch.float32)
    assert tpf._head_bwd_form(LEAKY[:2], 128, torch.bfloat16) == (128, torch.bfloat16)
    assert tpf._head_bwd_form(LEAKY[:2], 128, None) == (128, torch.bfloat16)
    with pytest.raises(ValueError):   # relu-relu is PathNet's form, with Cout <= 16
        tpf._head_bwd_form(tpf.HEAD_ACTS, 32, torch.float32)
    with pytest.raises(ValueError):   # Multisteps' cotangent is bf16
        tpf._head_bwd_form(LEAKY[:2], 128, torch.float32)
    with pytest.raises(ValueError):
        tpf._head_bwd_form(("leaky_relu", "relu"), 8, torch.float32)
