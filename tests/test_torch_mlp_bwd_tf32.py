"""What surrounds K10-bwd's tensor-core f32 body (``csrc/mlp_bwd_tf32.cu``,
split TF32 on ``mma.sync``), on the CPU (the kernel runs only on the card:
``tests/test_torch_kernels_gpu.py``).

* ``mlp_bwd_tc_plan``: LayerNet's chain alone (three layers 32 wide, C0 up
  to 32, any activations), the carve in the kernel's order (the six packed
  weight matrices, the biases, 8 warps' rings of 3 slabs of 16 rows of x
  and g, their h1 and h2 tiles, f32 at a pitch of 40) within a block's
  shared memory, the grid.
* ``pack_mlp_tf32``: W0 (rows zero-padded to 32), W1, W2 and their
  transposes one after the other as ``pack_b_tf32`` lays out each.
* ``_mlp_bwd_tc_walk``, the body's split-TF32 arithmetic k8 step by k8 step
  over its warps' slabs and blocks, against ``_mlp_bwd_plain`` at f32 and
  wcmc_tpu's ``_mlp_bwd_xla`` (the VJP of its XLA chain) at f32 from the
  same numpy seeds: dW and db within 5e-3 of max, d(x) within 1e-3 in
  relative L2 (``chip_smoke.py``'s ``F32_GRAD_TOL`` and
  ``F32_ROW_L2_TOL``), at C0 32 and narrower, row counts that leave a
  slab part-filled, d(x) on and off.
* The routing of ``_mlp_bwd_kernel`` on f32 card tensors: LayerNet's chain
  to ``wcmc_mlp_fused_bwd_tf32`` (C0 below 32 too, d(x) on and off),
  every other form and ``body="simt"`` to the SIMT body's
  ``wcmc_mlp_fused_bwd_f32``, an unknown body a ValueError.  The launch is
  intercepted at the kernel lookup; nothing runs.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wcmc_tpu_torch.ops import _build
from wcmc_tpu_torch.ops import mlp_fused as mf
from wcmc_tpu_torch.ops._tf32 import pack_b_tf32
from wcmc_tpu_torch.ops.conv5 import SMEM_LIMIT

jmf = importlib.import_module("wcmc_tpu.ops.mlp_fused")

F32_GRAD_TOL, F32_ROW_L2_TOL = 5e-3, 1e-3
LEAKY3 = ("leaky_relu",) * 3


def test_mlp_bwd_tc_plan():
    plan = mf.mlp_bwd_tc_plan(32, (32, 32, 32), LEAKY3)
    assert [n for n, _ in plan.smem] == ["weights", "bias", "rings", "hidden"]
    tile = 4 * 16 * 40
    assert [m for _, m in plan.smem] == [6 * 2 * 4 * 32 * 32, 384, 8 * 3 * 2 * tile,
                                         8 * 2 * tile]
    assert plan.total == 213376 <= SMEM_LIMIT
    assert (plan.k0, plan.rows, plan.walkers, plan.stages) == (32, 16, 8, 3)
    assert plan.parts == 3 * 32 * 32 + 3 * 32
    # a warp's partial fits over its ring
    assert 4 * plan.parts <= 3 * 2 * tile
    assert plan.grid(8 * 8 * 128 * 128, 132) == 132
    assert plan.grid(1000, 132) == 8 and plan.grid(1, 132) == 1
    assert mf.mlp_bwd_tc_plan(1, (32, 32, 32), ("relu", "linear", "relu")).total == plan.total
    for c0, widths in ((33, (32, 32, 32)), (32, (32, 32)), (32, (64, 32, 32)),
                       (32, (32, 32, 32, 32))):
        assert not mf.mlp_tc_form(c0, widths)
        with pytest.raises(ValueError):
            mf.mlp_bwd_tc_plan(c0, widths, ("relu",) * len(widths))


def test_pack_mlp_tf32():
    rng = np.random.default_rng(4)
    ws = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for s in ((29, 32), (32, 32), (32, 32))]
    bs = [torch.full((32,), float(i + 1)) for i in range(3)]
    wp, bias = mf.pack_mlp_tf32(*ws, *bs)
    assert wp.numel() == 6 * 2 * 32 * 32
    m0 = torch.zeros((32, 32))
    m0[:29] = ws[0]
    for got, m in zip(torch.split(wp, 2 * 32 * 32), (m0, ws[1], ws[2], ws[2].t(), ws[1].t(),
                                                    m0.t())):
        assert torch.equal(got, pack_b_tf32(m).reshape(-1))
    assert torch.equal(bias, torch.cat(bs))


def _case(n, c0, seed):
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))

    x = f(n, c0)
    ws = [f(ci, 32, scale=ci ** -0.5) for ci in (c0, 32, 32)]
    bs = [f(32, scale=0.1) for _ in range(3)]
    return x, f(n, 32), ws, bs


def _as_t(v):
    return torch.as_tensor(np.array(v)).double()


def _check(got, want, compute_dx):
    assert len(got[1]) == len(want[1]) == 3
    for a, w in zip(list(got[1]) + list(got[2]), list(want[1]) + list(want[2])):
        a, w = _as_t(a), _as_t(w)
        assert a.shape == w.shape
        assert (a - w).abs().max().item() <= F32_GRAD_TOL * w.abs().max().item()
    if compute_dx:
        a, w = _as_t(got[0]), _as_t(want[0])
        assert a.shape == w.shape
        assert ((a - w).norm() / w.norm()).item() <= F32_ROW_L2_TOL
    else:
        assert got[0] is None


# (n, c0, acts)
WALKS = {
    "layernet": (300, 32, LEAKY3),
    "narrow": (77, 29, ("relu", "leaky_relu", "linear")),
    "odd": (45, 7, ("linear", "relu", "relu")),
}


@pytest.mark.parametrize("compute_dx", [True, False])
@pytest.mark.parametrize("name", list(WALKS))
def test_mlp_bwd_tc_walk(name, compute_dx):
    n, c0, acts = WALKS[name]
    x, g, ws, bs = _case(n, c0, 5)
    got = mf._mlp_bwd_tc_walk(x, g, ws, bs, acts, compute_dx, n_blocks=2)
    _check(got, mf._mlp_bwd_plain(x, g, ws, bs, acts, compute_dx), compute_dx)
    # wcmc_tpu's backward on the CPU: the VJP of its XLA chain, f32
    ref = jmf._mlp_bwd_xla(jnp.asarray(x.numpy()), jnp.asarray(g.numpy()),
                           [jnp.asarray(w.numpy()) for w in ws],
                           [jnp.asarray(v.numpy()) for v in bs], acts, compute_dx)
    _check(got, ref, compute_dx)


class _Launch(Exception):
    """A launch intercepted at the kernel lookup; ``args[0]`` the entry point."""


@pytest.fixture
def launches(monkeypatch):
    monkeypatch.setattr(mf, "_require_cuda", lambda name, *ts: torch.device("cpu"))

    def kernel(name, *argtypes):
        def launch(*args):
            raise _Launch(name, args)
        return launch

    monkeypatch.setattr(_build, "kernel", kernel)
    monkeypatch.setattr(_build, "sm_count", lambda idx: 132)
    monkeypatch.setattr(_build, "stream_of", lambda dev: 0)


def _entry(*args, **kw):
    with pytest.raises(_Launch) as info:
        mf._mlp_bwd_kernel(*args, **kw)
    return info.value.args


@pytest.mark.parametrize("compute_dx", [True, False])
@pytest.mark.parametrize("name", list(WALKS))
def test_mlp_bwd_routes_f32_to_the_tensor_cores(launches, name, compute_dx):
    n, c0, acts = WALKS[name]
    x, g, ws, bs = _case(n, c0, 6)
    for body in (None, "tc"):
        entry, args = _entry(x, g, ws, bs, acts, compute_dx, body=body)
        assert entry == "wcmc_mlp_fused_bwd_tf32"
        # x, g, wp, bias, dx, parts, out; then n, C0, the codes, the grid
        assert (args[4] is not None) == compute_dx
        assert args[7:13] == (n, c0, *(mf.ACTS.index(a) for a in acts),
                              -(-n // (16 * 8)))
    assert _entry(x, g, ws, bs, acts, compute_dx, body="simt")[0] == "wcmc_mlp_fused_bwd_f32"
    for body in ("tiled", "wmma", "wgmma"):
        with pytest.raises(ValueError, match="body"):
            mf._mlp_bwd_kernel(x, g, ws, bs, acts, compute_dx, body=body)


def test_mlp_bwd_other_forms_run_the_simt_body(launches):
    """Every f32 form but LayerNet's runs the SIMT body, the 64 -> 64^4
    chain included; the forward keeps its one f32 body."""
    rng = np.random.default_rng(7)
    for c0, widths in ((64, (64, 64, 64, 64)), (33, (32, 32, 32)), (32, (32, 32)),
                       (32, (16, 32, 32)), (5, (16,))):
        x = torch.from_numpy(rng.standard_normal((40, c0)).astype(np.float32))
        ws = [torch.zeros((ci, co)) for ci, co in zip((c0, *widths[:-1]), widths)]
        bs = [torch.zeros(co) for co in widths]
        acts = ("relu",) * len(widths)
        g = torch.zeros((40, widths[-1]))
        assert _entry(x, g, ws, bs, acts, True)[0] == "wcmc_mlp_fused_bwd_f32"
    x, g, ws, bs = _case(40, 32, 8)
    with pytest.raises(_Launch) as info:
        mf._mlp_fwd_kernel(x, ws, bs, LEAKY3)
    assert info.value.args[0] == "wcmc_mlp_fused_f32"


def test_mlp_bwd_tc_packs_once(launches):
    x, g, ws, bs = _case(40, 32, 9)
    mf._packed.clear()
    for _ in range(2):
        _entry(x, g, ws, bs, LEAKY3, True)
    assert (mf._packed.misses, mf._packed.hits) == (1, 1)
    bs[1].add_(1.0)
    _entry(x, g, ws, bs, LEAKY3, True)
    assert mf._packed.misses == 2
    # no rows: no launch, zero gradients
    dx, dws, dbs = mf._mlp_bwd_kernel(x[:0], g[:0], ws, bs, LEAKY3, True)
    assert tuple(dx.shape) == (0, 32) and not any(t.any() for t in dws + dbs)
