"""What surrounds K7's banded body and K8's tiled body, on the CPU (the
kernels themselves run only on the card: ``tests/test_torch_kernels_gpu.py``).

* ``splat_plan``: the banded body's bands, column tiles and shared-memory
  carve at C 1 to 8 over several w and K, and where it gives way to the
  gather body (strided weights, K above 33, no band that fits).
* ``scatter_route``: the body and span copies picked for contiguous,
  unaligned and strided weights.
* ``_scatter_banded_walk``, a plain walk of the banded body's order (bands,
  tiles, runs, dx then dy, a ring of canvas rows, band partials summed in
  band order), against ``scatter_plain`` and ``wcmc_tpu``'s ``_scatter_xla``
  at K 5, 13 and 21 in f32 within 1e-5 of max |ref| (the same products
  summed in another order), and equal to ``scatter_plain`` on inputs whose
  products and sums are exact.
* ``outer_plan`` and ``_outer_tiled_walk`` (units of 32 runs of 32 pixels
  down a column, each run from the window that slides down the unit): the
  walk equal to ``outer_plain`` bit for bit, and within 1e-5 of
  ``_outer_xla``.
* ``chip_smoke.py`` tells K7's and K8's bodies apart in a profile.

K = 21 only against XLA, on 16-48 px images.
"""

import importlib
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wcmc_tpu_torch.ops import kernel_apply as ka
from wcmc_tpu_torch.ops.conv5 import SMEM_LIMIT

# the wcmc_tpu.ops package re-exports a function named kernel_apply
jka = importlib.import_module("wcmc_tpu.ops.kernel_apply")

TOL = 1e-5


def _close(got, want, tol=TOL):
    got = np.asarray(torch.as_tensor(got).detach(), np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want))


def _splat_inputs(seed, b, h, w, c, k, exact=False):
    rng = np.random.default_rng(seed)
    if exact:   # small integers: every product and partial sum is exact in f32
        x = rng.integers(-4, 5, (b, h, w, c)).astype(np.float32)
        wt = rng.integers(0, 4, (b, h, w, k * k)).astype(np.float32)
    else:
        x = rng.standard_normal((b, h, w, c)).astype(np.float32)
        wt = rng.random((b, h, w, k * k)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(wt)


# ---------------------------------------------------------------------------
# K7: the plan and the route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", range(1, 9))
@pytest.mark.parametrize("w,k", [(128, 21), (17, 21), (45, 13), (300, 5), (1000, 13), (64, 23)])
def test_splat_plan_fits(c, w, k):
    """The banded plan: the widest tile (a multiple of 32, up to the whole
    row) whose carve fits in a block's shared memory, its buffers each a
    multiple of 128 bytes in the kernel's order, and its band partials."""
    h = 40
    plan = ka.splat_plan(h, w, c, k)
    cs = 4 if c <= 4 else 8

    def r128(n):
        return -(-n // 128) * 128

    narrowest = (r128(4 * 3 * 32 * k * k) + r128(4 * 3 * 32 * c) + r128(4 * k * (32 + k - 1) * cs)
                 + 128)
    assert plan.banded == (narrowest <= SMEM_LIMIT)
    if not plan.banded:   # K = 23 at C above 4: not even a 32-column tile fits
        return
    assert [name for name, _ in plan.smem] == ["weights", "values", "canvas", "bars"]
    assert all(m % 128 == 0 for _, m in plan.smem)
    assert plan.total == sum(m for _, m in plan.smem) <= SMEM_LIMIT
    assert plan.smem[0][1] == 4 * 3 * 32 * k * k
    assert plan.smem[2][1] == -(-4 * k * (plan.cols + k - 1) * cs // 128) * 128
    assert plan.cols % 32 == 0 and plan.cols <= -(-w // 32) * 32
    assert (plan.run, plan.stages, plan.rows) == (32, 3, min(ka.SPLAT_ROWS, h))
    assert plan.bands == -(-h // plan.rows) and plan.tiles == -(-w // plan.cols)
    assert plan.scratch == plan.bands * plan.tiles * (plan.rows + k - 1) * (plan.cols + k - 1) * c
    if plan.cols < -(-w // 32) * 32:    # a wider tile would not fit
        wider = ka.splat_plan(h, plan.cols + 32, c, k)
        assert wider.cols == plan.cols


def test_splat_plan_at_the_sbmc_shape():
    """At the SBMC splat (128^2 px, radiance and a ones channel, K = 21)
    a whole canvas row fits: one tile, bands of 32 rows."""
    plan = ka.splat_plan(128, 128, 4, 21)
    assert plan.banded and (plan.rows, plan.cols, plan.bands, plan.tiles) == (32, 128, 4, 1)
    assert plan.total == 169344 + 1536 + 49792 + 128
    assert ka.splat_plan(128, 128, 8, 21).tiles == 2


@pytest.mark.parametrize("h,w,c,k,contiguous", [
    (16, 16, 4, 35, True), (16, 16, 4, 21, False), (16, 64, 8, 25, True),
    (16, 64, 8, 33, True)])
def test_splat_plan_refusals(h, w, c, k, contiguous):
    """Strided weights, K above 33 (a step's sources would span three runs)
    and a carve that does not fit at 32 columns all take the gather body."""
    assert ka.splat_plan(h, w, c, k, contiguous) == ka.SplatPlan(
        False, 0, 0, 0, 0, 0, 0, (), 0, 0)


@pytest.mark.parametrize("h,w,c,k", [(16, 16, 0, 5), (16, 16, 9, 5), (16, 16, 4, 4),
                                     (0, 16, 4, 5)])
def test_splat_plan_rejects_what_no_body_computes(h, w, c, k):
    with pytest.raises(ValueError):
        ka.splat_plan(h, w, c, k)


def test_scatter_route():
    """Contiguous weights run the banded body: bulk copies where every run
    starts on 16 bytes, 4-byte copies for odd w or a misaligned start;
    strided weights run the gather body."""
    x, wt = _splat_inputs(0, 2, 9, 12, 4, 5)
    assert x.data_ptr() % 16 == 0 and wt.data_ptr() % 16 == 0
    assert ka.scatter_route(x, wt, 5) == ("banded", "bulk")
    xo, wo = _splat_inputs(0, 2, 9, 13, 4, 5)
    assert ka.scatter_route(xo, wo, 5) == ("banded", "4-byte")
    flat = torch.zeros(wt.numel() + 1)
    shifted = flat[1:].view(wt.shape)
    assert shifted.is_contiguous() and ka.scatter_route(x, shifted, 5) == ("banded", "4-byte")
    big = torch.zeros((2, 11, 14, 25))
    view = big[:, 1:10, 2:14]
    assert view.stride(-1) == 1 and ka.scatter_route(x, view, 5) == ("gather", None)


# ---------------------------------------------------------------------------
# K7: the walk of the banded order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,w,c,k", [(2, 16, 16, 4, 5), (2, 19, 45, 3, 13), (1, 24, 33, 8, 5),
                                       (2, 17, 20, 1, 13), (1, 16, 48, 5, 5)])
def test_scatter_walk_matches_plain_and_xla(b, h, w, c, k):
    x, wt = _splat_inputs(1, b, h, w, c, k)
    got = ka._scatter_banded_walk(x, wt, k)
    _close(got, ka._scatter_plain(x, wt, k))
    _close(got, jka._scatter_xla(jnp.asarray(x.numpy()), jnp.asarray(wt.numpy()), k))


@pytest.mark.parametrize("b,h,w,c,k", [(1, 16, 16, 4, 21), (1, 20, 37, 2, 21)])
def test_scatter_walk_matches_xla_at_k21(b, h, w, c, k):
    x, wt = _splat_inputs(2, b, h, w, c, k)
    _close(ka._scatter_banded_walk(x, wt, k),
           jka._scatter_xla(jnp.asarray(x.numpy()), jnp.asarray(wt.numpy()), k))


@pytest.mark.parametrize("b,h,w,c,k,bands,tiles", [
    (1, 36, 100, 8, 21, 2, 2), (1, 20, 200, 3, 21, 1, 2), (2, 40, 40, 4, 5, 2, 1)])
def test_scatter_walk_over_bands_and_tiles(b, h, w, c, k, bands, tiles):
    """Plans of several bands and column tiles (a whole canvas row does not
    fit in shared memory at K = 21 with C above 4, or w above 160): the
    band partials summed across bands and tiles give the splat."""
    plan = ka.splat_plan(h, w, c, k)
    assert plan.banded and (plan.bands, plan.tiles) == (bands, tiles)
    x, wt = _splat_inputs(3, b, h, w, c, k)
    _close(ka._scatter_banded_walk(x, wt, k), ka._scatter_plain(x, wt, k))


@pytest.mark.parametrize("b,h,w,c,k", [(2, 16, 16, 4, 5), (1, 19, 45, 3, 13), (1, 16, 16, 4, 21),
                                       (2, 40, 40, 4, 5)])
def test_scatter_walk_is_exact_on_exact_inputs(b, h, w, c, k):
    x, wt = _splat_inputs(4, b, h, w, c, k, exact=True)
    assert torch.equal(ka._scatter_banded_walk(x, wt, k), ka._scatter_plain(x, wt, k))


# ---------------------------------------------------------------------------
# K8: the plan and the walk of the tiled order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", range(1, 9))
@pytest.mark.parametrize("k", [5, 13, 21])
def test_outer_plan_fits(c, k):
    """A window ring of K + 1 row slots of 32 + K - 1 pixels (rows padded
    to 16 bytes), each row kept twice; two value runs, two staging tiles of
    a run's dw span and the mbarriers."""
    plan = ka.outer_plan(c, k)
    assert plan.run == plan.rows == 32 and plan.pitch % 4 == 0 and plan.pitch >= (32 + k - 1) * c
    assert plan.smem[0][1] == -(-4 * 2 * (k + 1) * plan.pitch // 128) * 128
    assert [name for name, _ in plan.smem] == ["window", "values", "tiles", "bars"]
    assert plan.smem[2][1] == 4 * 2 * 32 * k * k
    assert plan.total == sum(m for _, m in plan.smem) <= SMEM_LIMIT


@pytest.mark.parametrize("c,k", [(0, 5), (9, 5), (4, 131), (1, 131)])
def test_outer_plan_refusals(c, k):
    """C outside 1-8, K above 129 (the first body takes any K up to the
    reference's bound)."""
    with pytest.raises(ValueError):
        ka.outer_plan(c, k)


@pytest.mark.parametrize("b,h,w,c,k", [(2, 16, 16, 4, 5), (2, 11, 45, 3, 13), (1, 16, 20, 8, 21),
                                       (1, 5, 7, 1, 5), (2, 6, 33, 2, 13), (1, 4, 70, 7, 5),
                                       (1, 70, 9, 3, 5)])
def test_outer_walk_is_the_plain_version(b, h, w, c, k):
    """The tiled walk gives ``outer_plain``'s bits (the runs and windows
    take every tap's inputs from the right pixels), and agrees with
    ``wcmc_tpu``'s ``_outer_xla``."""
    rng = np.random.default_rng(5)
    g = rng.standard_normal((b, h, w, c)).astype(np.float32)
    buf = rng.standard_normal((b, h + k - 1, w + k - 1, c)).astype(np.float32)
    got = ka._outer_tiled_walk(torch.from_numpy(g), torch.from_numpy(buf), k)
    assert torch.equal(got, ka._outer_plain(torch.from_numpy(g), torch.from_numpy(buf), k))
    if k < 21:
        _close(got, jka._outer_xla(jnp.asarray(g), jnp.asarray(buf), k))


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


def test_chip_smoke_tells_the_splat_bodies_apart():
    """K7's banded body and its band sums file as ``scatter_banded``, its
    gather body as ``scatter`` (K3's as ``scatter_softmax``); K8's tiled
    body as ``outer_tiled``, its first body as ``outer`` (K2's as
    ``outer_softmax``).  A profile of an SBMC path in which a first body
    ran, or a new one did not, is refused."""
    cs = _chip_smoke()
    names = {
        "void wcmc::splat_banded_kernel<4>(wcmc::SplatBandArgs)": "scatter_banded",
        "wcmc::splat_band_sum_kernel(wcmc::SplatBandArgs, float*, int)": "scatter_banded",
        "void wcmc::splat_gather_kernel<float, false>(float const*, float const*)": "scatter",
        "void wcmc::splat_gather_kernel<float, true>(float const*, float const*)":
            "scatter_softmax",
        "void wcmc::outer_tiled_kernel<4>(float const*, float const*, float*, int)":
            "outer_tiled",
        "void wcmc::outer_kernel<float, float, false>(float const*)": "outer",
        "void wcmc::outer_kernel<__nv_bfloat16, __nv_bfloat16, true>(float const*)":
            "outer_softmax",
    }
    for name, kind in names.items():
        assert cs.device_kind(name) == kind
    cs.check_redesigned_body({"scatter_banded": 2.0, "outer_tiled": 1.0}, "train",
                             ["scatter", "outer"])
    cs.check_redesigned_body({"scatter_banded": 2.0, "outer": 1.0}, "serve", ["scatter"])
    for kinds, counters in (({"scatter_banded": 2.0, "scatter": 0.1}, ["scatter"]),
                            ({"scatter": 2.7}, ["scatter"]),
                            ({"scatter_banded": 2.0, "outer": 2.0}, ["scatter", "outer"]),
                            ({"scatter_banded": 2.0}, ["scatter", "outer"])):
        with pytest.raises(AssertionError):
            cs.check_redesigned_body(kinds, "train", counters)


def test_chip_smoke_reads_both_launches_of_the_banded_body():
    """``device_ms`` of K7 sums a call's two launches (the bands and their
    sums) under the counter ``scatter``, and with ``per_call`` refuses a
    profile that lost one of them."""
    cs = _chip_smoke()
    band = "void wcmc::splat_banded_kernel<4>(wcmc::SplatBandArgs)"
    total = "wcmc::splat_band_sum_kernel(wcmc::SplatBandArgs, float*, int)"
    events = [(band, 0.0, 1000.0), (total, 1000.0, 20.0), (band, 2000.0, 900.0),
              (total, 2900.0, 30.0), (band, 4000.0, 950.0), (total, 4950.0, 25.0)]
    kinds = ("scatter", "scatter_tiled", "scatter_banded")
    assert cs.median_device_ms(events, kinds, 3) == 0.975
    assert cs.median_device_ms(events, kinds, 3, per_call=2) == 0.975
    # a pass that lost the band entries of every call is refused, not read
    # as the band sums' time
    sums_only = [e for e in events if "band_sum" in e[0]]
    assert cs.median_device_ms(sums_only, kinds, 3) == 0.025
    assert cs.median_device_ms(sums_only, kinds, 3, per_call=2) is None
