"""What surrounds K4-fwd's tensor-core f32 body (``csrc/pathnet_embed_tf32.cu``,
split TF32 on ``mma.sync``), on the CPU (the kernel runs only on the card:
``tests/test_torch_kernels_gpu.py``).

* ``embed_fwd_tc_plan``: K4-bwd's forms (``embed_tc_form``), the carve in
  the kernel's order (x twice, h1 and h2 at 64 rows) at the kernel's
  pitches against a block's shared memory, two blocks an SM for the forms
  of C0 40 and one for Multisteps', the grid; a chain no form holds is
  refused by the plan.
* The pack is K4-bwd's: a forward and a backward on the same parameters
  pack once (``pack_embed_tf32``, keyed by the form).
* ``_embed_fwd_tc_walk``, the body's split-TF32 arithmetic k8 step by k8
  step, against ``_embed_plain`` at f32 and wcmc_tpu's ``pathnet_embed``
  (XLA on the CPU, ``_embed_xla``) at f32 from the same numpy seeds: e and
  the mean within 1e-4 of max (``chip_smoke.py``'s ``F32_FWD_TOL``), at odd
  shapes: S not a multiple of the chunk's 4 samples, HW not one of the
  tile's 16 pixels, C0 36 and 95 padded, a narrow chain zero-padded.
* The routing of ``_embed_fwd_kernel`` on card tensors: f32 to
  ``wcmc_pathnet_embed_tf32`` with the plan's form and grid, ``body="simt"``
  to the SIMT body's ``wcmc_pathnet_embed_f32``, an unknown body a
  ValueError; a chain no form holds to the SIMT body, so no chain the SIMT
  body's plan takes is refused.  The launch is intercepted at the kernel
  lookup; nothing runs.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wcmc_tpu_torch.ops import _build
from wcmc_tpu_torch.ops import pathnet_fused as pf
from wcmc_tpu_torch.ops.conv5 import SMEM_LIMIT

jpf = importlib.import_module("wcmc_tpu.ops.pathnet_fused")

F32_FWD_TOL = 1e-4


def _pitch(c):
    return c + (40 - c % 32) % 32


@pytest.mark.parametrize("form,total,per_sm", [((40, 128), 90112, 2), ((40, 64), 57344, 2),
                                                ((96, 128), 122880, 1)])
def test_embed_fwd_tc_plan(form, total, per_sm):
    c0, c = form
    plan = pf.embed_fwd_tc_plan(8, 128 * 128, c0, c, c, c)
    assert plan.form == form
    assert [n for n, _ in plan.smem] == ["x0", "x1", "h1", "h2"]
    want = [64 * _pitch(c0)] * 2 + [64 * _pitch(c)] * 2
    assert [m for _, m in plan.smem] == [-(-4 * n // 128) * 128 for n in want]
    assert plan.total == total <= SMEM_LIMIT
    assert plan.per_sm == per_sm and per_sm * (total + 1024) <= 233472
    assert (plan.tiles, plan.blocks) == (8 * 1024, per_sm * 132)
    assert pf.embed_fwd_tc_plan(1, 40, c0, c, c, c).blocks == 3
    # the paths' chains on their forms; narrower ones padded to the cheapest
    assert pf.embed_fwd_tc_plan(1, 16, 36, 128, 128, 128).form == (40, 128)
    assert pf.embed_fwd_tc_plan(1, 16, 95, 128, 128, 128).form == (96, 128)
    assert pf.embed_fwd_tc_plan(1, 16, 20, 50, 30, 60).form == (40, 64)
    with pytest.raises(ValueError):
        pf.embed_fwd_tc_plan(1, 16, 36, 200, 64, 64)


def _case(b, s, hw, dims, seed):
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))

    x = f(b, s, hw, dims[0])
    ws = [f(ci, co, scale=ci ** -0.5) for ci, co in zip(dims[:-1], dims[1:])]
    bs = [f(co, scale=0.1) for co in dims[1:]]
    return x, ws, bs


def _close(got, want, tol=F32_FWD_TOL):
    got, want = torch.as_tensor(np.array(got)).double(), torch.as_tensor(np.array(want)).double()
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()


# (dims, acts, b, s, hw)
WALKS = {
    "kpcn": ((36, 128, 128, 128), pf.EMBED_ACTS, 1, 5, 21),
    "pathnet64": ((36, 64, 64, 64), pf.EMBED_ACTS, 2, 3, 40),
    "multisteps": ((95, 128, 128, 128), pf.LEAKY, 1, 6, 19),
    "padded": ((20, 50, 30, 60), pf.EMBED_ACTS, 1, 7, 33),
}


@pytest.mark.parametrize("name", list(WALKS))
def test_embed_fwd_tc_walk(name):
    dims, acts, b, s, hw = WALKS[name]
    x, ws, bs = _case(b, s, hw, dims, 11)
    e, mean = pf._embed_fwd_tc_walk(x, ws, bs, acts)
    assert e.shape == (b, s, hw, dims[-1]) and mean.shape == (b, hw, dims[-1])
    for got, want in zip((e, mean), pf._embed_plain(x, ws, bs, acts)):
        _close(got, want)
    # wcmc_tpu's embedding on the CPU (its XLA path), f32
    jx = jnp.asarray(x.numpy())
    jws, jbs = [jnp.asarray(w.numpy()) for w in ws], [jnp.asarray(v.numpy()) for v in bs]
    for ref in (jpf.pathnet_embed(jx, jws, jbs, acts), jpf._embed_xla(jx, jws, jbs, acts)):
        for got, want in zip((e, mean), ref):
            _close(got, want)


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
def test_embed_fwd_routes_f32_to_the_tensor_cores(launches, name):
    dims, acts, b, s, hw = WALKS[name]
    x, ws, bs = _case(b, s, hw, dims, 12)
    with pytest.raises(_Launch) as info:
        pf._embed_fwd_kernel(x, ws, bs, acts)
    entry, args = info.value.args
    assert entry == "wcmc_pathnet_embed_tf32"
    # x, wp, bias, e, mean; then B, S, HW, C0, C3, the form, the activation
    # codes, the grid
    plan = pf.embed_fwd_tc_plan(b, hw, *dims)
    assert args[5:16] == (b, s, hw, dims[0], dims[-1], *plan.form,
                          *(pf.ACTS.index(a) for a in acts), plan.blocks)
    with pytest.raises(_Launch) as info:
        pf._embed_fwd_kernel(x, ws, bs, acts, body="simt")
    assert info.value.args[0] == "wcmc_pathnet_embed_f32"
    with pytest.raises(ValueError, match="body"):
        pf._embed_fwd_kernel(x, ws, bs, acts, body="wgmma")


def test_embed_fwd_and_bwd_share_one_pack(launches):
    """A forward and a backward on the same parameters pack them once (the
    entry keyed by the form), and an in-place update packs anew."""
    x, ws, bs = _case(1, 2, 16, (36, 64, 64, 64), 13)
    ge = torch.zeros((1, 2, 16, 64))
    pf._packed.clear()
    for fn in (lambda: pf._embed_fwd_kernel(x, ws, bs, pf.EMBED_ACTS),
               lambda: pf._embed_bwd_kernel(x, ge, None, ws, bs, pf.EMBED_ACTS, False)):
        with pytest.raises(_Launch):
            fn()
    assert (pf._packed.misses, pf._packed.hits) == (1, 1)
    ws[0].add_(1.0)
    with pytest.raises(_Launch):
        pf._embed_fwd_kernel(x, ws, bs, pf.EMBED_ACTS)
    assert pf._packed.misses == 2


# Widths the SIMT body's plan takes: the entry points' embeddings (KPCN's
# and the 64-wide PathNet's 36 -> C^3, Multisteps' 95 -> 128^3) and a sweep
WIDTHS = (1, 8, 36, 40, 41, 64, 95, 96, 97, 128, 129, 256)


def _routed(dims):
    """The entry point ``_embed_fwd_kernel`` launches for an f32 chain."""
    x = torch.zeros((1, 1, 1, dims[0]))
    ws = [torch.zeros((ci, co)) for ci, co in zip(dims[:-1], dims[1:])]
    bs = [torch.zeros(co) for co in dims[1:]]
    with pytest.raises(_Launch) as info:
        pf._embed_fwd_kernel(x, ws, bs, pf.LEAKY)
    return info.value.args[0]


@pytest.mark.parametrize("c1", WIDTHS[::3])
def test_embed_fwd_refuses_no_chain_the_simt_plan_takes(launches, c1):
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
            assert _routed(dims) == ("wcmc_pathnet_embed_tf32" if tc else "wcmc_pathnet_embed_f32")
    assert _routed((36, 128, 128, 128)) == _routed((95, 128, 128, 128)) \
        == _routed((36, 64, 64, 64)) == "wcmc_pathnet_embed_tf32"
