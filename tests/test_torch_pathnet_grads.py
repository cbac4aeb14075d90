"""Parity of the backward of the port's PathNet embedding and head (the
plain versions of kernels K4-bwd and K5-bwd, through their autograd
Functions) with wcmc_tpu.

* ``jax.vjp`` of ``pathnet_embed`` / ``pathnet_head`` (XLA path; the head
  with moments and channel-major output, and the output, sum and sum of
  squares cotangents all non-zero), f32: within 1e-5 of max |ref|.
* ``_embed_bwd_pallas`` / ``_head_bwd_pallas`` in interpret mode, bf16:
  within 2e-2 of max |ref| (a bf16 hidden or cotangent summed in another
  order can round to a neighbouring value).
* The gradients of both PathNets' parameters through
  ``dual_pathnet_apply`` (concatenated and block-diagonal weights): within
  1e-4 of each tensor's max |ref| (f32 through the context UNets).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wcmc_tpu.models.pathnet import PathNet as JPathNet
from wcmc_tpu.models.pathnet import dual_pathnet_apply as jdual
from wcmc_tpu_torch import convert
from wcmc_tpu_torch.models.pathnet import PathNet as TPathNet
from wcmc_tpu_torch.models.pathnet import dual_pathnet_apply as tdual
from wcmc_tpu_torch.ops import _build
from wcmc_tpu_torch.ops import pathnet_fused as tpf

jpf = importlib.import_module("wcmc_tpu.ops.pathnet_fused")
jmf = importlib.import_module("wcmc_tpu.ops.mlp_fused")
jpk = importlib.import_module("wcmc_tpu.ops.pallas_kernels")

F32_TOL, BF16_TOL, MODEL_TOL = 1e-5, 2e-2, 1e-4
B, S, HW = 2, 3, 40
EMBED = (36, 32, 32, 32)
HEAD = (64, 64, 6)        # (Ce + Cc, C1, Cout) with Ce = Cc = 32


def _params(rng, dims):
    ws = [(rng.standard_normal((ci, co)) / np.sqrt(ci)).astype(np.float32)
          for ci, co in zip(dims[:-1], dims[1:])]
    bs = [(0.1 * rng.standard_normal(co)).astype(np.float32) for co in dims[1:]]
    return ws, bs


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


def _leaves(arrs):
    return [torch.from_numpy(a).requires_grad_() for a in arrs]


@pytest.fixture(scope="module")
def embed_case():
    rng = np.random.default_rng(13)
    x = rng.standard_normal((B, S, HW, EMBED[0])).astype(np.float32)
    ws, bs = _params(rng, EMBED)
    ge = rng.standard_normal((B, S, HW, EMBED[-1])).astype(np.float32)
    gmean = rng.standard_normal((B, HW, EMBED[-1])).astype(np.float32)
    return x, ws, bs, ge, gmean


@pytest.fixture(scope="module")
def head_case():
    rng = np.random.default_rng(14)
    ce = HEAD[0] // 2
    e = rng.standard_normal((B, S, HW, ce)).astype(np.float32)
    ctx = rng.standard_normal((B, HW, HEAD[0] - ce)).astype(np.float32)
    ws, bs = _params(rng, HEAD)
    g = rng.standard_normal((B, S, HEAD[-1], HW)).astype(np.float32)     # channel-major
    gsum = rng.standard_normal((B, HW, HEAD[-1])).astype(np.float32)
    gsq = (0.3 * rng.standard_normal((B, HW, HEAD[-1]))).astype(np.float32)
    return e, ctx, ws, bs, g, gsum, gsq


def _torch_embed_grads(x, ws, bs, ge, gmean, dtype=torch.float32):
    tws, tbs = _leaves(ws), _leaves(bs)
    e, mean = tpf.pathnet_embed(torch.from_numpy(x).to(dtype), tws, tbs)
    _build.reset_counts()
    grads = torch.autograd.grad([e, mean], tws + tbs,
                                [torch.from_numpy(ge).to(dtype), torch.from_numpy(gmean)])
    assert dict(_build.plain_calls) == {"pathnet_embed_bwd": 1}
    return grads


def test_embed_backward_matches_xla_f32(embed_case):
    x, ws, bs, ge, gmean = embed_case
    j = [jnp.asarray(a) for a in ws], [jnp.asarray(a) for a in bs]
    _, vjp = jax.vjp(lambda w_, b_: jpf.pathnet_embed(jnp.asarray(x), w_, b_, tpf.EMBED_ACTS),
                     *j)
    jws, jbs = vjp((jnp.asarray(ge), jnp.asarray(gmean)))
    for got, want in zip(_torch_embed_grads(x, ws, bs, ge, gmean), list(jws) + list(jbs)):
        assert got.dtype == torch.float32
        _close(got, want, F32_TOL)


def test_embed_backward_matches_pallas_bf16(embed_case):
    x, ws, bs, ge, gmean = embed_case
    _, jws, jbs = _pallas(jpf._embed_bwd_pallas, jnp.asarray(x, jnp.bfloat16),
                          jnp.asarray(ge, jnp.bfloat16), jnp.asarray(gmean),
                          [jnp.asarray(a) for a in ws], [jnp.asarray(a) for a in bs],
                          tpf.EMBED_ACTS, False)
    got = _torch_embed_grads(x, ws, bs, ge, gmean, torch.bfloat16)
    for g, w in zip(got, list(jws) + list(jbs)):
        _close(g, w, BF16_TOL)


def test_embed_backward_dx(embed_case):
    """``compute_dx`` (the SBMC case) gives d(x); without it x is data."""
    x, ws, bs, ge, gmean = embed_case
    _, vjp = jax.vjp(lambda x_: jpf._embed_xla(x_, [jnp.asarray(a) for a in ws],
                                               [jnp.asarray(a) for a in bs], tpf.EMBED_ACTS),
                     jnp.asarray(x))
    (want,) = vjp((jnp.asarray(ge), jnp.asarray(gmean)))
    tx = torch.from_numpy(x).requires_grad_()
    e, mean = tpf.pathnet_embed(tx, [torch.from_numpy(a) for a in ws],
                                [torch.from_numpy(a) for a in bs], compute_dx=True)
    (dx,) = torch.autograd.grad([e, mean], [tx], [torch.from_numpy(ge), torch.from_numpy(gmean)])
    _close(dx, want, F32_TOL)
    e, mean = tpf.pathnet_embed(tx, [torch.from_numpy(a) for a in ws],
                                [torch.from_numpy(a) for a in bs])
    (dx,) = torch.autograd.grad([e, mean], [tx], [torch.from_numpy(ge), torch.from_numpy(gmean)])
    assert not dx.any()


def _torch_head_grads(e, ctx, ws, bs, g, gsum, gsq, dtype=torch.float32):
    te = torch.from_numpy(e).to(dtype).requires_grad_()
    tctx = torch.from_numpy(ctx).requires_grad_()
    tws, tbs = _leaves(ws), _leaves(bs)
    out = tpf.pathnet_head(te, tctx, tws, tbs, tpf.HEAD_ACTS, moments=True, cmajor=True)
    _build.reset_counts()
    grads = torch.autograd.grad(out, [te, tctx] + tws + tbs,
                                [torch.from_numpy(a) for a in (g, gsum, gsq)])
    assert dict(_build.plain_calls) == {"pathnet_head_bwd": 1}
    return grads


def test_head_backward_matches_xla_f32(head_case):
    e, ctx, ws, bs, g, gsum, gsq = head_case
    _, vjp = jax.vjp(
        lambda e_, c_, w_, b_: jpf.pathnet_head(e_, c_, w_, b_, tpf.HEAD_ACTS, True,
                                                jnp.float32, True),
        jnp.asarray(e), jnp.asarray(ctx), [jnp.asarray(a) for a in ws],
        [jnp.asarray(a) for a in bs])
    de, dctx, jws, jbs = vjp((jnp.asarray(g), jnp.asarray(gsum), jnp.asarray(gsq)))
    got = _torch_head_grads(e, ctx, ws, bs, g, gsum, gsq)
    for gt, wt in zip(got, [de, dctx] + list(jws) + list(jbs)):
        _close(gt, wt, F32_TOL)


def test_head_backward_matches_pallas_bf16(head_case):
    e, ctx, ws, bs, g, gsum, gsq = head_case
    de, dctx, jws, jbs = _pallas(
        jpf._head_bwd_pallas, jnp.asarray(e, jnp.bfloat16), jnp.asarray(ctx),
        jnp.asarray(g), jnp.asarray(gsum), jnp.asarray(gsq), [jnp.asarray(a) for a in ws],
        [jnp.asarray(a) for a in bs], tpf.HEAD_ACTS, True, True)
    got = _torch_head_grads(e, ctx, ws, bs, g, gsum, gsq, torch.bfloat16)
    assert got[0].dtype == torch.bfloat16
    for gt, wt in zip(got, [de, dctx] + list(jws) + list(jbs)):
        _close(gt, wt, BF16_TOL)


def test_head_backward_none_cotangents_are_zeros(head_case):
    e, ctx, ws, bs, g, gsum, gsq = head_case
    t = [torch.from_numpy(a) for a in (e, ctx)]
    tw, tb = [torch.from_numpy(a) for a in ws], [torch.from_numpy(a) for a in bs]
    got = tpf.pathnet_head_bwd(*t, torch.from_numpy(g), None, None, tw, tb, cmajor=True)
    want = tpf.pathnet_head_bwd(*t, torch.from_numpy(g), torch.zeros_like(torch.from_numpy(gsum)),
                                torch.zeros_like(torch.from_numpy(gsq)), tw, tb, cmajor=True)
    for a, b in zip([got[0], got[1], *got[2], *got[3]], [want[0], want[1], *want[2], *want[3]]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


IC = 16   # PathNet width, narrowed from 64 for CPU speed


@pytest.mark.parametrize("cmajor", [False, True])
def test_dual_pathnet_param_grads(cmajor):
    rng = np.random.default_rng(15)
    b, s, h, w = 2, 2, 8, 8
    paths = rng.standard_normal((b, s, h, w, 36)).astype(np.float32)
    jm = JPathNet(ic=36, intermc=IC, outc=3)
    pd = jm.init(jax.random.PRNGKey(4), {"paths": jnp.asarray(paths)})["params"]
    ps = jm.init(jax.random.PRNGKey(5), {"paths": jnp.asarray(paths)})["params"]
    shp = (b, s, 3, h, w) if cmajor else (b, s, h, w, 3)
    cot = [rng.standard_normal(shp).astype(np.float32) for _ in range(2)]
    cot += [rng.standard_normal((b, h, w, 6)).astype(np.float32) for _ in range(2)]

    def loss_j(pd_, ps_):
        p_d, p_s, (ssum, ssq) = jdual(jm, pd_, jm, ps_, {"paths": jnp.asarray(paths)},
                                      with_moments=True, cmajor=cmajor)
        return sum(jnp.sum(t * jnp.asarray(c)) for t, c in zip((p_d, p_s, ssum, ssq), cot))

    want_d, want_s = jax.grad(loss_j, argnums=(0, 1))(pd, ps)
    td, ts = (convert.load_flax_params(TPathNet(ic=36, intermc=IC, outc=3), p)
              for p in (pd, ps))
    p_d, p_s, (ssum, ssq) = tdual(td, ts, {"paths": torch.from_numpy(paths)},
                                  with_moments=True, cmajor=cmajor)
    sum((t * torch.from_numpy(c)).sum() for t, c in zip((p_d, p_s, ssum, ssq), cot)).backward()
    for model, want in ((td, want_d), (ts, want_s)):
        got = convert.grads_to_flax(model)
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        flat_g = jax.tree_util.tree_leaves_with_path(got)
        assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
        for (path, wv), (_, gv) in zip(flat_w, flat_g):
            _close(gv, wv, MODEL_TOL)
