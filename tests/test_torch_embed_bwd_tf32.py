"""What surrounds K4-bwd's tensor-core f32 body (``csrc/pathnet_embed_bwd_tf32.cu``,
split TF32 on ``mma.sync``), on the CPU (the kernel runs only on the card:
``tests/test_torch_kernels_gpu.py``).

* ``embed_tc_form``: KPCN's dual PathNet (36 -> 128^3), the 64-wide
  PathNet (36 -> 64^3) and Multisteps (95 -> 128^3) on their own
  instantiations (C0 padded to 40 or 96), narrower chains zero-padded to the
  cheapest one that holds them, wider ones held by none.
* ``embed_bwd_tc_plan``: the carve in the kernel's order (x twice, h1 / g1,
  h2 / g2 and ge / g3 at 64 rows, the tile's gmean at 16 pixels, dW0^T) at
  the kernel's pitches against a block's shared memory, one block an SM
  (two for the 64-wide form), the partial's size.
* ``pack_embed_tf32``: the six matrices (W0, W1, W2 and their transposes)
  one after the other as ``pack_b_tf32`` lays out each (element by element
  in ``tests/test_torch_head_bwd_tf32.py``), zero past the chain's widths,
  the biases padded; packed once per parameter value.
* ``_embed_bwd_tc_walk``, the body's split-TF32 arithmetic over its tiles,
  chunks, k8 steps and blocks, against ``_embed_bwd_plain`` at f32 and
  wcmc_tpu's embedding backward (the VJP of ``pathnet_embed``, XLA on the
  CPU) at f32 from the same numpy seeds: weight and bias gradients within
  5e-3 of max, d(x) within 1e-3 in relative L2 (``chip_smoke.py``'s F32
  tolerances), at odd shapes: S not a multiple of the chunk's 4 samples,
  HW not one of the tile's 16 pixels, C0 36 and 95 padded, a narrow chain
  zero-padded, either cotangent absent.
* The routing of ``_embed_bwd_kernel`` on card tensors: f32 to
  ``wcmc_pathnet_embed_bwd_tf32``, ``body="simt"`` to the SIMT body's
  ``wcmc_pathnet_embed_bwd_f32``, an unknown body a ValueError; a chain no
  form holds to the SIMT body, so every chain the SIMT body's plan takes is
  launched, none refused.  The launch is intercepted at the kernel lookup;
  nothing runs.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wcmc_tpu_torch.ops import _build
from wcmc_tpu_torch.ops import pathnet_fused as pf
from wcmc_tpu_torch.ops.conv5 import SMEM_LIMIT

jpf = importlib.import_module("wcmc_tpu.ops.pathnet_fused")

F32_GRAD_TOL, F32_ROW_L2_TOL = 5e-3, 1e-3


def test_embed_tc_form():
    assert pf.embed_tc_form(36, 128, 128, 128) == (40, 128)
    assert pf.embed_tc_form(36, 64, 64, 64) == (40, 64)
    assert pf.embed_tc_form(95, 128, 128, 128) == (96, 128)
    assert pf.embed_tc_form(20, 50, 30, 60) == (40, 64)
    assert pf.embed_tc_form(41, 64, 64, 64) == (96, 128)    # C0 41 needs 96
    assert pf.embed_tc_form(36, 100, 64, 64) == (40, 128)   # a layer of 100 needs 128
    assert pf.embed_tc_form(96, 16, 16, 16) == (96, 128)
    for dims in ((97, 128, 128, 128), (36, 129, 128, 128), (36, 128, 128, 256)):
        assert pf.embed_tc_form(*dims) is None
        with pytest.raises(ValueError):
            pf.embed_bwd_tc_plan(1, 16, *dims)
    with pytest.raises(ValueError):
        pf.embed_tc_form(0, 64, 64, 64)


def _pitch(c):
    return c + (40 - c % 32) % 32


@pytest.mark.parametrize("form,total,per_sm", [((40, 128), 154112, 1), ((40, 64), 90624, 2),
                                                ((96, 128), 219648, 1)])
def test_embed_bwd_tc_plan(form, total, per_sm):
    c0, c = form
    plan = pf.embed_bwd_tc_plan(8, 128 * 128, c0, c, c, c)
    assert plan.form == form
    assert [n for n, _ in plan.smem] == ["x0", "x1", "h1", "h2", "g3", "gmean", "dw0t"]
    want = [64 * _pitch(c0)] * 2 + [64 * _pitch(c)] * 3 + [16 * _pitch(c), c * _pitch(c0)]
    assert [m for _, m in plan.smem] == [-(-4 * n // 128) * 128 for n in want]
    # each pitch 8 floats past a multiple of 32: the fragment loads of 8 rows
    # (g) and of 4 (t) fall on distinct banks
    assert all(_pitch(n) % 32 == 8 for n in (40, 64, 96, 128))
    assert plan.total == total <= SMEM_LIMIT
    assert plan.per_sm == per_sm and per_sm * (total + 1024) <= 233472
    assert (plan.tiles, plan.blocks) == (8 * 1024, per_sm * 132)
    assert plan.parts == c0 * c + 2 * c * c + 3 * c
    assert pf.embed_bwd_tc_plan(1, 40, c0, c, c, c).blocks == 3


def test_pack_embed_tf32():
    rng = np.random.default_rng(3)
    dims = (20, 50, 30, 60)
    ws = [torch.from_numpy(rng.standard_normal((ci, co)).astype(np.float32))
          for ci, co in zip(dims[:-1], dims[1:])]
    bs = [torch.full((co,), float(i + 1)) for i, co in enumerate(dims[1:])]
    form = pf.embed_tc_form(*dims)
    wp, bias = pf.pack_embed_tf32(*ws, *bs, form)
    c0, c = form
    sizes = [c0 * c, c * c, c * c, c * c, c * c, c * c0]
    assert wp.numel() == 2 * sum(sizes)
    mats = torch.split(wp, [2 * m for m in sizes])

    def pad(w, k, n):
        out = torch.zeros((k, n))
        out[:w.shape[0], :w.shape[1]] = w
        return out

    m0, m1, m2 = pad(ws[0], c0, c), pad(ws[1], c, c), pad(ws[2], c, c)
    for got, m in zip(mats, (m0, m1, m2, m2.t(), m1.t(), m0.t())):
        assert torch.equal(got, pf.pack_b_tf32(m).reshape(-1))
    assert not m0[dims[0]:].any() and not m2[:, dims[3]:].any()
    for i, co in enumerate(dims[1:]):
        assert bias[i * c:i * c + co].eq(i + 1).all() and not bias[i * c + co:(i + 1) * c].any()


def _case(b, s, hw, dims, seed):
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))

    x = f(b, s, hw, dims[0])
    ws = [f(ci, co, scale=ci ** -0.5) for ci, co in zip(dims[:-1], dims[1:])]
    bs = [f(co, scale=0.1) for co in dims[1:]]
    return x, f(b, s, hw, dims[-1]), f(b, hw, dims[-1]), ws, bs


def _close(got, want, tol):
    got, want = torch.as_tensor(np.array(got)).double(), torch.as_tensor(np.array(want)).double()
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()


def _close_l2(got, want, tol):
    got, want = torch.as_tensor(np.array(got)).double(), torch.as_tensor(np.array(want)).double()
    assert got.shape == want.shape
    assert ((got - want).norm() / want.norm()).item() <= tol


def _check(got, want, compute_dx):
    assert len(got[1]) == len(want[1]) == 3
    for a, w in zip(list(got[1]) + list(got[2]), list(want[1]) + list(want[2])):
        _close(a, w, F32_GRAD_TOL)
    if compute_dx:
        _close_l2(got[0], want[0], F32_ROW_L2_TOL)
    else:
        assert got[0] is None


# (dims, acts, compute_dx, b, s, hw)
WALKS = {
    "kpcn": ((36, 128, 128, 128), pf.EMBED_ACTS, False, 1, 5, 21),
    "kpcn_dx": ((36, 128, 128, 128), pf.EMBED_ACTS, True, 2, 2, 16),
    "pathnet64": ((36, 64, 64, 64), pf.EMBED_ACTS, False, 2, 3, 40),
    "multisteps": ((95, 128, 128, 128), pf.LEAKY, True, 1, 6, 19),
    "padded": ((20, 50, 30, 60), pf.EMBED_ACTS, True, 1, 7, 33),
}


@pytest.mark.parametrize("name", list(WALKS))
def test_embed_bwd_tc_walk(name):
    dims, acts, compute_dx, b, s, hw = WALKS[name]
    x, ge, gmean, ws, bs = _case(b, s, hw, dims, 7)
    got = pf._embed_bwd_tc_walk(x, ge, gmean, ws, bs, acts, compute_dx, sms=2)
    _check(got, pf._embed_bwd_plain(x, ge, gmean, ws, bs, acts, compute_dx), compute_dx)
    # wcmc_tpu's embedding backward on the CPU: the VJP of its XLA embedding
    _, vjp = jax.vjp(lambda x_, w_, b_: jpf.pathnet_embed(x_, w_, b_, acts, compute_dx),
                     jnp.asarray(x.numpy()), [jnp.asarray(w.numpy()) for w in ws],
                     [jnp.asarray(v.numpy()) for v in bs])
    dx, jws, jbs = vjp((jnp.asarray(ge.numpy()), jnp.asarray(gmean.numpy())))
    _check(got, (dx if compute_dx else None, jws, jbs), compute_dx)


@pytest.mark.parametrize("name", ["kpcn", "multisteps"])
def test_embed_bwd_tc_walk_absent_cotangents(name):
    """An absent cotangent reads as zeros, the embedding's or its mean's."""
    dims, acts, compute_dx, b, s, hw = WALKS[name]
    x, ge, gmean, ws, bs = _case(b, s, hw, dims, 8)
    for gs in ((ge, None), (None, gmean)):
        got = pf._embed_bwd_tc_walk(x, *gs, ws, bs, acts, compute_dx, sms=3)
        _check(got, pf._embed_bwd_plain(x, *gs, ws, bs, acts, compute_dx), compute_dx)


class _Launch(Exception):
    """A launch intercepted at the kernel lookup; ``args[0]`` the entry point."""


@pytest.fixture
def launches(monkeypatch):
    monkeypatch.setattr(pf, "_require_cuda", lambda name, *ts: torch.device("cpu"))

    def kernel(name, *argtypes):
        def launch(*args):
            raise _Launch(name, args)
        return launch

    monkeypatch.setattr(_build, "kernel", kernel)
    monkeypatch.setattr(_build, "sm_count", lambda idx: 132)
    monkeypatch.setattr(_build, "stream_of", lambda dev: 0)


@pytest.mark.parametrize("name", list(WALKS))
def test_embed_bwd_routes_f32_to_the_tensor_cores(launches, name):
    dims, acts, compute_dx, b, s, hw = WALKS[name]
    x, ge, gmean, ws, bs = _case(b, s, hw, dims, 9)
    with pytest.raises(_Launch) as info:
        pf._embed_bwd_kernel(x, ge, gmean, ws, bs, acts, compute_dx)
    entry, args = info.value.args
    assert entry == "wcmc_pathnet_embed_bwd_tf32"
    # x, ge, gmean, wp, bias, dx, parts, out; then B, S, HW, C0, the form,
    # the activation codes
    assert (args[5] is not None) == compute_dx
    assert args[8:17] == (b, s, hw, dims[0], *pf.embed_tc_form(*dims),
                          *(pf.ACTS.index(a) for a in acts))
    with pytest.raises(_Launch) as info:
        pf._embed_bwd_kernel(x, ge, gmean, ws, bs, acts, compute_dx, body="simt")
    assert info.value.args[0] == "wcmc_pathnet_embed_bwd_f32"
    with pytest.raises(ValueError, match="body"):
        pf._embed_bwd_kernel(x, ge, gmean, ws, bs, acts, compute_dx, body="wgmma")


def test_embed_bwd_tc_packs_once(launches):
    x, ge, gmean, ws, bs = _case(1, 2, 16, (36, 64, 64, 64), 10)
    pf._packed.clear()
    for _ in range(2):
        with pytest.raises(_Launch):
            pf._embed_bwd_kernel(x, ge, gmean, ws, bs, pf.EMBED_ACTS, False)
    assert (pf._packed.misses, pf._packed.hits) == (1, 1)
    bs[2].add_(1.0)
    with pytest.raises(_Launch):
        pf._embed_bwd_kernel(x, ge, gmean, ws, bs, pf.EMBED_ACTS, False)
    assert pf._packed.misses == 2


# Widths the SIMT body's plan takes: the entry points' embeddings (KPCN's
# and the 64-wide PathNet's 36 -> C^3, Multisteps' 95 -> 128^3) and a sweep
WIDTHS = (1, 8, 36, 40, 41, 64, 95, 96, 97, 128, 129, 256)


def _routed(dims):
    """The entry point ``_embed_bwd_kernel`` launches for an f32 chain."""
    x = torch.zeros((1, 1, 1, dims[0]))
    ws = [torch.zeros((ci, co)) for ci, co in zip(dims[:-1], dims[1:])]
    bs = [torch.zeros(co) for co in dims[1:]]
    with pytest.raises(_Launch) as info:
        pf._embed_bwd_kernel(x, None, None, ws, bs, pf.EMBED_ACTS, True)
    return info.value.args[0]


@pytest.mark.parametrize("c1", WIDTHS)
def test_embed_bwd_refuses_no_chain_the_simt_plan_takes(launches, c1):
    """No f32 chain the SIMT body's plan takes is refused: each is launched,
    on the tensor-core body exactly where a form holds it."""
    pf._packed.clear()
    for c0 in WIDTHS:
        for c3 in WIDTHS:
            c2 = WIDTHS[(WIDTHS.index(c0) + WIDTHS.index(c3)) % len(WIDTHS)]
            dims = (c0, c1, c2, c3)
            try:
                pf.embed_f32_plan(1, 1, *dims)
            except ValueError:
                continue
            tc = pf.embed_tc_form(*dims) is not None
            assert _routed(dims) == ("wcmc_pathnet_embed_bwd_tf32" if tc
                                     else "wcmc_pathnet_embed_bwd_f32")
    assert _routed((36, 128, 128, 128)) == _routed((95, 128, 128, 128)) \
        == _routed((36, 64, 64, 64)) == "wcmc_pathnet_embed_bwd_tf32"
