"""Parity of the port's PathNet embedding and head (the plain versions of
kernels K4-fwd and K5-fwd) with wcmc_tpu: the XLA paths ``_embed_xla`` /
``_head_xla`` in f32, and the Pallas kernels in interpret mode in f32
and bf16.

Tolerances: f32 1e-5 relative (of max |ref|) — same math, other
summation order; bf16 2e-2 of max |ref| — a product summed in another
order can round to a neighbouring bf16 value at a hidden layer."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wcmc_tpu_torch.ops import _build
from wcmc_tpu_torch.ops import pathnet_fused as tpf

jpf = importlib.import_module("wcmc_tpu.ops.pathnet_fused")
jmf = importlib.import_module("wcmc_tpu.ops.mlp_fused")
jpk = importlib.import_module("wcmc_tpu.ops.pallas_kernels")

F32_TOL, BF16_TOL = 1e-5, 2e-2
B, S, HW = 2, 3, 40
EMBED = (36, 32, 32, 32)
HEAD = (64, 64, 6)        # (Ce + Cc, C1, Cout) with Ce = Cc = 32


def _params(rng, dims):
    ws = [(rng.standard_normal((ci, co)) / np.sqrt(ci)).astype(np.float32)
          for ci, co in zip(dims[:-1], dims[1:])]
    bs = [(0.1 * rng.standard_normal(co)).astype(np.float32) for co in dims[1:]]
    return ws, bs


def _close(got, want, tol):
    got = np.asarray(torch.as_tensor(got).float(), np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want))


def _pallas(fn, *args, **kw):
    jpk.INTERPRET, jmf.FORCE_PALLAS = True, True
    try:
        return fn(*args, **kw)
    finally:
        jpk.INTERPRET, jmf.FORCE_PALLAS = False, False


@pytest.fixture(scope="module")
def embed_case():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, HW, EMBED[0])).astype(np.float32)
    return x, *_params(rng, EMBED)


@pytest.fixture(scope="module")
def head_case():
    rng = np.random.default_rng(4)
    ce = HEAD[0] // 2
    e = rng.standard_normal((B, S, HW, ce)).astype(np.float32)
    ctx = rng.standard_normal((B, HW, HEAD[0] - ce)).astype(np.float32)
    return e, ctx, *_params(rng, HEAD)


def _t(arrs, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


def test_embed_matches_xla_f32(embed_case):
    x, ws, bs = embed_case
    want_e, want_m = jpf._embed_xla(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                                    [jnp.asarray(b) for b in bs], tpf.EMBED_ACTS)
    e, m = tpf.pathnet_embed(torch.from_numpy(x), _t(ws), _t(bs))
    assert e.dtype == torch.float32 and m.dtype == torch.float32
    _close(e, want_e, F32_TOL)
    _close(m, want_m, F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_matches_pallas(embed_case, dtype):
    x, ws, bs = embed_case
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want_e, want_m = _pallas(jpf.pathnet_embed, jnp.asarray(x, jdt),
                             [jnp.asarray(w) for w in ws],
                             [jnp.asarray(b) for b in bs], tpf.EMBED_ACTS)
    e, m = tpf.pathnet_embed(torch.from_numpy(x).to(tdt), _t(ws), _t(bs))
    assert e.dtype == tdt and m.dtype == torch.float32
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    _close(e, want_e, tol)
    _close(m, want_m, tol)


@pytest.mark.parametrize("cmajor", [False, True])
@pytest.mark.parametrize("moments", [False, True])
def test_head_matches_xla_f32(head_case, moments, cmajor):
    e, ctx, ws, bs = head_case
    want = jpf._head_xla(jnp.asarray(e), jnp.asarray(ctx), [jnp.asarray(w) for w in ws],
                         [jnp.asarray(b) for b in bs], tpf.HEAD_ACTS, moments,
                         jnp.float32, cmajor)
    got = tpf.pathnet_head(torch.from_numpy(e), torch.from_numpy(ctx), _t(ws), _t(bs),
                           tpf.HEAD_ACTS, moments, cmajor)
    if not moments:
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, F32_TOL)


@pytest.mark.parametrize("dtype,cmajor", [("float32", False), ("bfloat16", False),
                                          ("bfloat16", True)])
def test_head_matches_pallas(head_case, dtype, cmajor):
    e, ctx, ws, bs = head_case
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = _pallas(jpf.pathnet_head, jnp.asarray(e, jdt), jnp.asarray(ctx),
                   [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs],
                   tpf.HEAD_ACTS, True, jnp.float32, cmajor)
    got = tpf.pathnet_head(torch.from_numpy(e).to(tdt), torch.from_numpy(ctx),
                           _t(ws), _t(bs), tpf.HEAD_ACTS, True, cmajor)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w, tol)


def test_plain_versions_are_counted(embed_case, head_case):
    x, ws, bs = embed_case
    e, ctx, hws, hbs = head_case
    _build.reset_counts()
    tpf.pathnet_embed(torch.from_numpy(x), _t(ws), _t(bs))
    tpf.pathnet_head(torch.from_numpy(e), torch.from_numpy(ctx), _t(hws), _t(hbs))
    assert dict(_build.plain_calls) == {"pathnet_embed": 1, "pathnet_head": 1}
    assert not _build.launches
