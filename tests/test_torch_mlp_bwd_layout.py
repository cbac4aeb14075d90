"""What surrounds K10-bwd (the fused per-pixel MLP's backward) on the card,
on the CPU: its plan (which body runs a form, the shared memory and the
grid), a plain walk of the tiled body's order, and ``chip_smoke.py``'s
view of its bodies.

* The plan: LayerNet's chain (three layers 32 wide, C0 up to 32, any
  activations) takes the tiled body in 227 KB of 128-byte pieces; every
  other form the wmma body; what neither computes is refused.
* The walk (slabs of 64 rows a warp, sub-tiles of 16, per-warp partials
  summed in warp order, then blocks in block order, db from the unrounded
  cotangent) against ``_mlp_bwd_plain`` in f32: dW and db within 1e-6 of
  max |plain| and d(x) within 1e-6 absolute (values O(1)); only the order
  of the f32 sums differs.
* The walk in bf16 against ``wcmc_tpu``'s ``_mlp_bwd_pallas`` interpreted:
  within 2e-2 of max |ref| (a product summed in another order can round to
  the neighbouring bf16 value at a hidden layer or a cotangent).
"""

import importlib
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wcmc_tpu_torch.ops import mlp_fused as mf
from wcmc_tpu_torch.ops.conv5 import SMEM_LIMIT

jmf = importlib.import_module("wcmc_tpu.ops.mlp_fused")
jpk = importlib.import_module("wcmc_tpu.ops.pallas_kernels")

WALK_TOL, BF16_TOL = 1e-6, 2e-2
LEAKY3 = ("leaky_relu",) * 3
MIXED = ("relu", "leaky_relu", "linear")
# 3 slabs of 64 rows and a ragged fourth of 37 (three whole sub-tiles of 16
# and one of 5)
RAGGED = 3 * 64 + 37


def _case(n, c0, seed, widths=(32, 32, 32)):
    rng = np.random.default_rng(seed)
    dims = (c0,) + tuple(widths)

    def f(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))
    x = f(n, c0)
    ws = [f(ci, co, scale=ci ** -0.5) for ci, co in zip(dims[:-1], dims[1:])]
    bs = [f(co, scale=0.1) for co in dims[1:]]
    return x, ws, bs, f(n, dims[-1])


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c0", [1, 5, 16, 17, 27, 32])
@pytest.mark.parametrize("acts", [LEAKY3, MIXED, ("linear",) * 3])
def test_plan_takes_layernets_chain_to_the_tiled_body(c0, acts):
    plan = mf.mlp_bwd_plan(c0, (32, 32, 32), acts)
    assert plan.body == "tiled" and plan.k0 == 32
    assert plan.total == sum(m for _, m in plan.smem) <= SMEM_LIMIT
    assert all(m % 128 == 0 for _, m in plan.smem)
    sizes = dict(plan.smem)
    # three 32 x 32 bf16 weight tiles, the f32 biases, and each of the 8
    # warps' rings of 3 slabs, an x and a g tile (64 x 32 bf16) each
    assert (plan.rows, plan.walkers, plan.stages) == (64, 8, 3)
    assert sizes == {"weights": 3 * 2 * 32 * 32, "bias": 384, "rings": 8 * 3 * 2 * 2 * 64 * 32}
    # dW0 (32 x 32, rows past C0 zero) | dW1 | dW2 | db0 | db1 | db2
    assert plan.parts == 3 * 32 * 32 + 3 * 32
    # a warp's partial fits in its ring, where the block sums them
    assert 4 * plan.parts <= sizes["rings"] // plan.walkers


@pytest.mark.parametrize("c0,widths", [
    (33, (32, 32, 32)),               # C0 above 32
    (40, (32, 32, 32)),
    (32, (32, 32)),                   # other layer counts
    (32, (32, 32, 32, 32)),
    (32, (16, 16, 16)),               # other widths
    (36, (64, 64, 64)),
    (32, (32, 48, 32)),
    (64, (64, 48, 32, 16)),
])
def test_plan_keeps_the_wmma_body(c0, widths):
    acts = ("relu",) * len(widths)
    plan = mf.mlp_bwd_plan(c0, widths, acts)
    assert plan.body == "wmma" and plan.k0 == -(-c0 // 16) * 16
    assert (plan.rows, plan.walkers, plan.stages) == (128, 1, 1)
    assert plan.total == sum(m for _, m in plan.smem) <= SMEM_LIMIT
    assert all(m % 128 == 0 for _, m in plan.smem)
    dims = [plan.k0, *widths]
    assert plan.parts == sum(ci * co + co for ci, co in zip(dims[:-1], dims[1:]))
    # a 128-row tile for x and every hidden, each padded by 8 columns
    sizes = dict(plan.smem)
    assert [sizes[f"h{i}"] for i in range(len(dims))] == [
        -(-2 * 128 * (c + 8) // 128) * 128 for c in dims]


@pytest.mark.parametrize("c0,widths,acts", [
    (32, (32, 32, 32), ("relu", "gelu", "relu")),    # an activation neither body has
    (32, (32, 32, 32), LEAKY3[:2]),                  # acts and widths differ in length
    (0, (32, 32, 32), LEAKY3),                       # no input
    (65, (32, 32, 32), LEAKY3),                      # C0 above MLP_MAX_WIDTH
    (32, (32, 24, 32), LEAKY3),                      # a width not a multiple of 16
    (32, (32, 80, 32), LEAKY3),                      # a width above MLP_MAX_WIDTH
    (32, (32,) * 5, ("linear",) * 5),                # more than MLP_MAX_LAYERS layers
    (32, (), ()),                                    # no layer
])
def test_plan_refuses(c0, widths, acts):
    with pytest.raises(ValueError):
        mf.mlp_bwd_plan(c0, widths, acts)


@pytest.mark.parametrize("n,sms,grid", [
    (1048576, 132, 132),     # the LBMC shape: 16384 slabs, 124.1 a block
    (RAGGED, 132, 1),        # 4 slabs: one block's warps
    (64 * 8 * 5, 132, 5),    # exactly 5 blocks' worth of slabs
    (64 * 8 * 5 + 1, 132, 6),
    (0, 132, 1),             # no rows: one block writes zero partials
    (10 ** 7, 4, 4),         # never more than one block a SM
])
def test_plan_grid(n, sms, grid):
    plan = mf.mlp_bwd_plan(32, (32, 32, 32), LEAKY3)
    assert plan.grid(n, sms) == grid
    # the wmma body's cap: four blocks a SM, no more than its tiles
    wmma = mf.mlp_bwd_plan(40, (32, 32, 32), LEAKY3)
    assert wmma.grid(n, sms) == max(1, min(4 * sms, -(-n // 128)))


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compute_dx", [True, False])
@pytest.mark.parametrize("acts", [LEAKY3, MIXED])
@pytest.mark.parametrize("c0", [27, 32])
def test_walk_matches_plain(c0, acts, compute_dx):
    """f32 throughout, at a ragged row count on a card of 2 SMs (one block
    takes no slab beyond its first warps')."""
    x, ws, bs, g = _case(RAGGED, c0, 3)
    got = mf._mlp_bwd_walk(x, g, ws, bs, acts, compute_dx, n_blocks=2)
    want = mf._mlp_bwd_plain(x, g, ws, bs, acts, compute_dx)
    if compute_dx:
        assert got[0].shape == (RAGGED, c0) and got[0].dtype == torch.float32
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=WALK_TOL)
    else:
        assert got[0] is None
    for a, b in zip(got[1] + got[2], want[1] + want[2]):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert (a - b).abs().max() <= WALK_TOL * b.abs().max()


def test_walk_over_many_slabs_a_warp():
    """40 slabs (the last ragged) over 2 blocks of 8 warps: each warp's
    partial sums 2 or 3 slabs before the warp and block sums."""
    x, ws, bs, g = _case(64 * 40 - 3, 27, 4)
    got = mf._mlp_bwd_walk(x, g, ws, bs, LEAKY3, True, n_blocks=2)
    want = mf._mlp_bwd_plain(x, g, ws, bs, LEAKY3, True)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=WALK_TOL)
    for a, b in zip(got[1] + got[2], want[1] + want[2]):
        assert (a - b).abs().max() <= WALK_TOL * b.abs().max()


def test_walk_refuses_the_wmma_forms():
    x, ws, bs, g = _case(100, 40, 5)
    with pytest.raises(ValueError):
        mf._mlp_bwd_walk(x, g, ws, bs, LEAKY3)


def _close(got, want, tol):
    got = np.asarray(torch.as_tensor(got).float(), np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want))


@pytest.mark.parametrize("compute_dx", [True, False])
@pytest.mark.parametrize("acts", [LEAKY3, MIXED])
@pytest.mark.parametrize("c0", [27, 32])
def test_walk_matches_wcmc_tpu(c0, acts, compute_dx):
    """The walk in bf16 against the Pallas backward interpreted (the
    cotangent rounded to bf16 on both sides)."""
    x, ws, bs, g = _case(RAGGED, c0, 6)
    xj = jnp.asarray(x.numpy(), jnp.bfloat16)
    jpk.INTERPRET = True
    try:
        want = jmf._mlp_bwd_pallas(xj, jnp.asarray(g.numpy()), [jnp.asarray(w.numpy()) for w in ws],
                                   [jnp.asarray(b.numpy()) for b in bs], acts, compute_dx)
    finally:
        jpk.INTERPRET = False
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    got = mf._mlp_bwd_walk(xt, g, ws, bs, acts, compute_dx)
    if compute_dx:
        assert got[0].dtype == torch.bfloat16
        _close(got[0], want[0], BF16_TOL)
    else:
        assert got[0] is None and want[0] is None
    for a, b in zip(got[1] + got[2], list(want[1]) + list(want[2])):
        assert a.dtype == torch.float32
        _close(a, np.asarray(b).reshape(a.shape), BF16_TOL)


# ---------------------------------------------------------------------------
# chip_smoke.py's view of the bodies
# ---------------------------------------------------------------------------

def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_chip_smoke_tells_the_mlp_bwd_bodies_apart():
    """K10-bwd's tiled body files as ``mlp_fused_bwd_tiled``, its wmma body
    as ``mlp_fused_bwd``, their partials' sum as ``reduce_parts``, K10-fwd's
    wmma body as ``mlp_fused``.  A profile of the LBMC step in which the
    wmma body ran, or the tiled one did not, is refused; ``device_ms`` of
    K10-bwd reads either body's entries and not the partials' sum."""
    cs = _chip_smoke()
    tiled = "void wcmc::mlp_fused_bwd_tiled_kernel<2, 2, 2>(wcmc::MlpBwdTiledArgs)"
    generic = "void wcmc::mlp_fused_bwd_tiled_kernel<-1, -1, -1>(wcmc::MlpBwdTiledArgs)"
    wmma = ("wcmc::mlp_fused_bwd_kernel(__nv_bfloat16 const*, __nv_bfloat16 const*, "
            "wcmc::MlpLayers, __nv_bfloat16*, float*, long long, int, int)")
    parts = "wcmc::reduce_parts_kernel(float const*, float*, int, long long)"
    fwd = "wcmc::mlp_fused_kernel(__nv_bfloat16 const*, wcmc::MlpLayers, __nv_bfloat16*, long long, int, int)"
    for name, kind in ((tiled, "mlp_fused_bwd_tiled"), (generic, "mlp_fused_bwd_tiled"),
                       (wmma, "mlp_fused_bwd"), (parts, "reduce_parts"), (fwd, "mlp_fused")):
        assert cs.device_kind(name) == kind
    assert cs.REDESIGNED_BODIES["mlp_fused_bwd"] == "mlp_fused_bwd_tiled"
    counters = [k for k in cs.REDESIGNED_BODIES if k in cs.TRAIN_LAUNCHES["lbmc"]]
    # the LBMC step's other redesigned kernels, K2, K3, K1 and K10-fwd, on
    # their new bodies
    assert counters == ["mlp_fused_bwd", "outer_softmax", "scatter_softmax", "gather_softmax",
                        "mlp_fused"]
    others = {"outer_softmax_tiled": 0.08, "scatter_softmax_banded": 0.07,
              "gather_softmax_tiled": 0.1, "mlp_fused_tiled": 0.06}
    cs.check_redesigned_body({"mlp_fused_bwd_tiled": 0.1, "reduce_parts": 0.01, **others},
                             "train", counters)
    for kinds in ({"mlp_fused_bwd": 0.7, "reduce_parts": 0.01, **others},
                  {"mlp_fused_bwd_tiled": 0.1, "mlp_fused_bwd": 0.7, **others},
                  {"mlp_fused": 0.3, **others}):
        with pytest.raises(AssertionError):
            cs.check_redesigned_body(kinds, "train", counters)
    kinds = ("mlp_fused_bwd", "mlp_fused_bwd_tiled", "mlp_fused_bwd_banded")
    events = [(tiled, 0.0, 100.0), (parts, 100.0, 5.0), (tiled, 200.0, 104.0),
              (parts, 304.0, 5.0), (wmma, 400.0, 700.0), (parts, 1100.0, 5.0)]
    assert cs.median_device_ms(events, kinds, 3, per_call=1) == 0.104
