"""What surrounds K10-fwd (the fused per-pixel MLP's forward) on the card,
on the CPU: its plan (which body runs a form, the shared memory and the
grid), a plain walk of the tiled body's order, and ``chip_smoke.py``'s
view of its bodies.

* The plan: LayerNet's chain (three layers 32 wide, C0 up to 32, any
  activations) takes the tiled body, in 128-byte pieces within a block's
  shared memory, one block an SM; every other form the wmma body, whose
  carve is the first port's; what neither computes is refused.
* The walk (slabs of 64 rows a warp, sub-tiles of 16, each layer summed
  k16 step by k16 step from zero, then its bias, its activation and the
  rounding) against ``_mlp_fwd_plain`` and ``wcmc_tpu``'s ``_mlp_xla`` in
  f32: within 1e-6 of max |ref| (values O(1)); only the order of the f32
  sums differs.
* The walk in bf16 against ``wcmc_tpu``'s ``_mlp_fwd_pallas`` interpreted:
  within 2e-2 of max |ref| (a product summed in another order can round to
  the neighbouring bf16 value at a hidden layer).
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
# 3 slabs of 64 rows and a ragged fourth of 37 (two whole sub-tiles of 16
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
    return x, ws, bs


def _close(got, want, tol):
    got = np.asarray(torch.as_tensor(got).float(), np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want))


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c0", [1, 5, 16, 17, 27, 32])
@pytest.mark.parametrize("acts", [LEAKY3, MIXED, ("linear",) * 3])
def test_plan_takes_layernets_chain_to_the_tiled_body(c0, acts):
    """Three weight tiles of 32 x 32 bf16, then 8 warps' rings of 4 x slabs
    (64 x 32 bf16), all in 128-byte pieces, one block an SM; the forms
    K10-bwd's tiled body takes."""
    plan = mf.mlp_fwd_plan(c0, (32, 32, 32), acts)
    assert (plan.body, plan.k0, plan.rows, plan.walkers, plan.stages) == ("tiled", 32, 64, 8, 4)
    assert plan.smem == (("weights", 3 * 2048), ("rings", 8 * 4 * 4096))
    assert all(m % 128 == 0 for _, m in plan.smem)
    assert plan.total == sum(m for _, m in plan.smem) <= SMEM_LIMIT
    assert 2 * (plan.total + 1024) > 233472   # one block an SM
    assert mf.mlp_bwd_plan(c0, (32, 32, 32), acts).body == "tiled"


@pytest.mark.parametrize("c0,widths", [(33, (32, 32, 32)), (32, (32, 32)), (32, (32,) * 4),
                                       (36, (64, 64, 64)), (32, (16,)), (27, (48, 32, 32)),
                                       (64, (64, 48, 32, 16))])
def test_plan_gives_every_other_form_the_wmma_body(c0, widths):
    """The wmma body's carve: each layer's weight rows (C0 padded to 16) at
    a pitch of the width + 8 and its bias, the 128-row x tile, two hidden
    tiles at the widest pitch, the warps' 16 x 16 f32 staging."""
    plan = mf.mlp_fwd_plan(c0, widths, ("relu",) * len(widths))
    assert plan.body == "wmma" and (plan.rows, plan.walkers, plan.stages) == (128, 1, 1)
    dims = [-(-c0 // 16) * 16, *widths]
    assert plan.k0 == dims[0]
    want = []
    for ci, co in zip(dims[:-1], dims[1:]):
        want += [2 * ci * (co + 8), 4 * co]
    want += [2 * 128 * (dims[0] + 8)] + [2 * 128 * (max(dims) + 8)] * 2 + [4 * 8 * 256]
    assert [m for _, m in plan.smem] == [-(-m // 128) * 128 for m in want]
    assert plan.total <= SMEM_LIMIT


@pytest.mark.parametrize("n,sms,grid", [(8 * 8 * 128 * 128, 132, 132), (1000, 132, 2),
                                        (512, 132, 1), (513, 132, 2), (0, 132, 1),
                                        (64 * 8 * 132 + 1, 132, 132), (1000, 3, 2)])
def test_grid(n, sms, grid):
    """One block an SM at most, no more than the 64-row slabs of 8 warps
    need, at least one; the wmma body up to four blocks an SM."""
    assert mf.mlp_fwd_plan(32, (32, 32, 32), LEAKY3).grid(n, sms) == grid
    wmma = mf.mlp_fwd_plan(36, (64, 64, 64), LEAKY3)
    assert wmma.grid(n, sms) == max(1, min(4 * sms, -(-n // 128)))


@pytest.mark.parametrize("c0,widths,acts", [(0, (32, 32, 32), LEAKY3),
                                            (65, (32, 32, 32), LEAKY3),
                                            (32, (32, 80), ("relu", "relu")),
                                            (32, (32, 24, 32), LEAKY3),
                                            (32, (32,) * 5, ("relu",) * 5),
                                            (32, (32, 32, 32), ("relu", "gelu", "relu"))])
def test_plan_refuses_what_no_body_computes(c0, widths, acts):
    with pytest.raises(ValueError):
        mf.mlp_fwd_plan(c0, widths, acts)


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("acts", [LEAKY3, MIXED])
@pytest.mark.parametrize("n,c0,blocks", [(RAGGED, 32, 3), (RAGGED, 27, 1), (1000, 5, 2),
                                         (16, 1, 3), (1, 32, 132)])
def test_walk_matches_the_plain_version_f32(n, c0, blocks, acts):
    x, ws, bs = _case(n, c0, 1)
    _close(mf._mlp_fwd_walk(x, ws, bs, acts, n_blocks=blocks), mf._mlp_fwd_plain(x, ws, bs, acts),
           WALK_TOL)


@pytest.mark.parametrize("acts", [LEAKY3, MIXED])
@pytest.mark.parametrize("c0", [27, 32])
def test_walk_matches_wcmc_tpu_f32(c0, acts):
    """The walk against ``wcmc_tpu``'s XLA chain in f32."""
    x, ws, bs = _case(RAGGED, c0, 2)
    want = jmf._mlp_xla(jnp.asarray(x.numpy()), [jnp.asarray(w.numpy()) for w in ws],
                        [jnp.asarray(b.numpy()) for b in bs], acts)
    _close(mf._mlp_fwd_walk(x, ws, bs, acts), want, WALK_TOL)


@pytest.mark.parametrize("acts", [LEAKY3, MIXED])
@pytest.mark.parametrize("c0", [5, 27, 32])
def test_walk_matches_wcmc_tpu_bf16(c0, acts):
    """The walk in bf16 against the Pallas forward interpreted."""
    x, ws, bs = _case(RAGGED, c0, 3)
    xj = jnp.asarray(x.numpy(), jnp.bfloat16)
    jpk.INTERPRET = True
    try:
        want = jmf._mlp_fwd_pallas(xj, [jnp.asarray(w.numpy()) for w in ws],
                                   [jnp.asarray(b.numpy()) for b in bs], acts)
    finally:
        jpk.INTERPRET = False
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    got = mf._mlp_fwd_walk(xt, ws, bs, acts)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(got, want, BF16_TOL)


def test_walk_refuses_a_form_of_the_wmma_body():
    x, ws, bs = _case(40, 36, 4, (64, 64, 64))
    with pytest.raises(ValueError):
        mf._mlp_fwd_walk(x, ws, bs, LEAKY3)


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


def test_chip_smoke_tells_the_mlp_fwd_bodies_apart():
    """K10-fwd's tiled body files as ``mlp_fused_tiled`` (either
    instantiation), its wmma body as ``mlp_fused``, apart from K10-bwd's
    bodies.  A served LBMC frame or an LBMC step whose K10-fwd entries are
    the wmma body's, or lack the tiled body's, is refused; ``device_ms`` of
    K10-fwd reads either body's entries and none of K10-bwd's."""
    cs = _chip_smoke()
    tiled = "void wcmc::mlp_fused_tiled_kernel<2, 2, 2>(wcmc::MlpFwdTiledArgs)"
    generic = "void wcmc::mlp_fused_tiled_kernel<-1, -1, -1>(wcmc::MlpFwdTiledArgs)"
    wmma = ("wcmc::mlp_fused_kernel(__nv_bfloat16 const*, wcmc::MlpLayers, __nv_bfloat16*, "
            "long long, int, int)")
    bwd = "void wcmc::mlp_fused_bwd_tiled_kernel<2, 2, 2>(wcmc::MlpBwdTiledArgs)"
    for name, kind in ((tiled, "mlp_fused_tiled"), (generic, "mlp_fused_tiled"),
                       (wmma, "mlp_fused"), (bwd, "mlp_fused_bwd_tiled")):
        assert cs.device_kind(name) == kind
    assert cs.REDESIGNED_BODIES["mlp_fused"] == "mlp_fused_tiled"
    serve = [k for k in cs.REDESIGNED_BODIES if k in cs.SERVE["lbmc"]["launches"]]
    assert serve == ["gather_softmax", "mlp_fused"]
    train = [k for k in cs.REDESIGNED_BODIES if k in cs.TRAIN_LAUNCHES["lbmc"]]
    assert "mlp_fused" in train
    good = {"gather_softmax_tiled": 0.3, "mlp_fused_tiled": 0.06}
    cs.check_redesigned_body(good, "serve_lbmc", serve)
    for bad in ({**good, "mlp_fused": 0.24}, {"gather_softmax_tiled": 0.3, "mlp_fused": 0.24},
                {"gather_softmax_tiled": 0.3}):
        with pytest.raises(AssertionError):
            cs.check_redesigned_body(bad, "serve_lbmc", serve)
    kinds = ("mlp_fused", "mlp_fused_tiled", "mlp_fused_banded")
    events = [(tiled, 0.0, 60.0), (bwd, 60.0, 100.0), (tiled, 200.0, 62.0), (bwd, 262.0, 100.0),
              (wmma, 400.0, 240.0)]
    assert cs.median_device_ms(events, kinds, 3, per_call=1) == 0.062
