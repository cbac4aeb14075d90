"""What surrounds K2's tiled body and K3's banded body, the two halves of the
softmax gather's backward, on the CPU (the kernels themselves run only on
the card: ``tests/test_torch_kernels_gpu.py``).

* ``outer_softmax_plan`` and ``scatter_softmax_plan``: their shared-memory
  carves at C 1 to 8 and K 5, 13 and 21, their refusals, where K3 gives way
  to its gather body, and their grids at the LBMC and KPCN shapes on 132
  SMs.
* ``outer_softmax_route`` and ``scatter_softmax_route``: the leading bytes
  of the pixels' landed taps and how the runs' spans move, for contiguous
  logits, LBMC's layer-0 and layer-1 views of a channels-last (B, 338, h, w)
  kernel head, KPCN's crop of a convolution output and logits 2 bytes off
  16.
* ``_outer_softmax_tiled_walk`` and ``_scatter_softmax_banded_walk``, plain
  walks of each body's order, within 1e-5 of max of ``outer_softmax_plain``
  and ``scatter_softmax_plain`` in f32, and of ``wcmc_tpu``'s VJP: ``jax.vjp``
  of ``kernel_gather_softmax`` on the XLA path in f32, and
  ``outer_softmax_tpu`` / ``scatter_tpu(softmax=True)`` interpreted at K = 5
  in bf16 (d logits, rounded once to bf16 on both sides, within 1e-2: an f32
  value summed in another order can round to the neighbouring bf16 value).
  A walk over a strided view equals the walk over its contiguous copy.
* ``chip_smoke.py`` files the new bodies' profile entries apart from the
  first bodies' and from K7's and K8's, and refuses a train profile that
  holds a first body's.

K = 21 only against XLA, on 16-48 px images.
"""

import importlib
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wcmc_tpu_torch.ops import kernel_apply as ka
from wcmc_tpu_torch.ops.conv5 import SMEM_LIMIT

# the wcmc_tpu.ops package re-exports a function named kernel_apply
jka = importlib.import_module("wcmc_tpu.ops.kernel_apply")
jmf = importlib.import_module("wcmc_tpu.ops.mlp_fused")
jpk = importlib.import_module("wcmc_tpu.ops.pallas_kernels")

TOL, BF16_OUT_TOL = 1e-5, 1e-2


def _close(got, want, tol=TOL):
    got = np.asarray(torch.as_tensor(got).detach().float(), np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want))


def _inputs(seed, b, h, w, k, c=3):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((b, h, w, c)).astype(np.float32)
    buf = rng.standard_normal((b, h + k - 1, w + k - 1, c)).astype(np.float32)
    logits = (2.0 * rng.standard_normal((b, h, w, k * k))).astype(np.float32)
    return torch.from_numpy(g), torch.from_numpy(buf), torch.from_numpy(logits)


def _r128(n):
    return -(-n // 128) * 128


def _head_view(b, h, w, k, layer, dtype=torch.bfloat16):
    """A layer's logits as the LayerNet hands them over: a slice of a
    channels-last (B, 2 K*K, h, w) kernel head."""
    head = torch.zeros((b, 2 * k * k, h, w), dtype=dtype).contiguous(
        memory_format=torch.channels_last)
    return head.permute(0, 2, 3, 1)[..., layer * k * k:(layer + 1) * k * k]


def _crop_view(b, h, w, k, dtype=torch.bfloat16):
    """KPCN's logits: the centre crop of a channels-last convolution output."""
    r = k // 2
    conv = torch.zeros((b, k * k, h + 2 * r, w + 2 * r), dtype=dtype).contiguous(
        memory_format=torch.channels_last)
    return conv.permute(0, 2, 3, 1)[:, r:r + h, r:r + w]


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------

def _outer_softmax_total(t, c, k, es):
    """K2's carve for runs of t pixels, counted here: the window ring (K + 1
    slots of t + K - 1 pixels, rows padded to 16 bytes, each twice), two
    value runs, two landed logit runs (slots of the taps' 16-byte-aligned
    superset), two staging tiles, the mbarriers."""
    pitch = -(-(t + k - 1) * c // 4) * 4
    lpitch = -(-(k * k * es + 16 - es) // 16) * 16
    return (_r128(8 * (k + 1) * pitch) + _r128(8 * t * c) + _r128(2 * t * lpitch)
            + _r128(2 * t * k * k * es) + 128)


@pytest.mark.parametrize("es", [2, 4])
@pytest.mark.parametrize("c", range(1, 9))
@pytest.mark.parametrize("k", [5, 13, 21])
def test_outer_softmax_plan_fits(k, c, es):
    """K2's carve in the kernel's order, each buffer a multiple of 128 bytes
    and the whole within a block's shared memory; a run of whole 16-byte
    groups of bf16 gradients; the window ring of K + 1 slots, each twice."""
    for w in (17, 45, 72, 128):
        plan = ka.outer_softmax_plan(2, 40, w, c, k, es)
        t = plan.run
        assert t in ka.SOFTMAX_RUNS and t % 8 == 0
        assert [name for name, _ in plan.smem] == ["window", "values", "logits", "tiles", "bars"]
        assert all(m % 128 == 0 for _, m in plan.smem)
        assert plan.total == sum(m for _, m in plan.smem) <= SMEM_LIMIT
        assert plan.pitch % 4 == 0 and plan.pitch >= (t + k - 1) * c
        assert plan.total == _outer_softmax_total(t, c, k, es)
        assert 1 <= plan.per_sm <= (3 if k <= 13 else 2)
        assert plan.per_sm * (plan.total + 1024) <= ka.SM_SMEM
        assert plan.units == 2 * -(-40 // plan.rows) * -(-w // t)
        assert plan.blocks == min(plan.units, plan.per_sm * ka.H100_SMS)
        # no other run leaves fewer idle pixels at a row's end, or as few
        # and is longer, unless its carve does not fit
        idle = -(-w // t) * t - w
        for other in ka.SOFTMAX_RUNS:
            other_idle = -(-w // other) * other - w
            if other_idle < idle or (other_idle == idle and other > t):
                assert _outer_softmax_total(other, c, k, es) > SMEM_LIMIT


@pytest.mark.parametrize("es", [2, 4])
@pytest.mark.parametrize("c", range(1, 9))
@pytest.mark.parametrize("k", [5, 13, 21])
def test_scatter_softmax_plan_fits(k, c, es):
    """K3's banded carve in the kernel's order (two runs of probabilities,
    three landed), within a block's shared memory, with the widest tile of
    32-column steps that fits, two blocks an SM where two fit; K above 15
    (KPCN's 21) runs the gather body."""
    cs = 4 if c <= 4 else 8
    lpitch = -(-(k * k * es + 16 - es) // 16) * 16

    def carve(cols):
        return [_r128(4 * 2 * 32 * k * k), _r128(4 * 2 * 32 * c), _r128(4 * k * (cols + k - 1) * cs),
                _r128(3 * 32 * lpitch), _r128(4 * 3 * 32 * c), 128]

    for w in (17, 45, 72, 128, 300):
        plan = ka.scatter_softmax_plan(2, 40, w, c, k, es)
        assert plan.banded == (k <= 15 and sum(carve(32)) <= SMEM_LIMIT)
        if not plan.banded:
            assert plan == ka.SoftmaxSplatPlan(False, 0, 0, 0, 0, 0, 0, 0, 0, (), 0, 0)
            continue
        assert [name for name, _ in plan.smem] == ["probabilities", "values", "canvas", "logits",
                                                   "landed_values", "bars"]
        assert [m for _, m in plan.smem] == carve(plan.cols)
        assert plan.total == sum(carve(plan.cols)) <= SMEM_LIMIT
        assert plan.cols % 32 == 0 and plan.cols <= -(-w // 32) * 32
        if plan.cols < -(-w // 32) * 32:
            assert sum(carve(plan.cols + 32)) > SMEM_LIMIT
        assert (plan.run, plan.stages, plan.land) == (32, 2, 3)
        assert plan.per_sm == min(2, ka.SM_SMEM // (plan.total + 1024))
        assert plan.bands == -(-40 // plan.rows) and plan.tiles == -(-w // plan.cols)
        assert plan.scratch == (plan.bands * plan.tiles * (plan.rows + k - 1)
                                * (plan.cols + k - 1) * c)
    assert ka.scatter_softmax_plan(2, 40, 128, c, 21, es).banded is False


@pytest.mark.parametrize("args", [(2, 16, 16, 0, 5, 2), (2, 16, 16, 9, 5, 2),
                                  (2, 16, 16, 3, 131, 2), (2, 16, 16, 3, 5, 1),
                                  (0, 16, 16, 3, 5, 2), (2, 16, 0, 3, 5, 2)])
def test_softmax_plans_refuse_what_no_body_computes(args):
    """C outside 1-8, K above 129 (K2's first body takes any K up to the
    reference's bound), logits neither f32 nor bf16, an empty batch or
    image."""
    with pytest.raises(ValueError):
        ka.outer_softmax_plan(*args)
    if args[4] <= 21:
        with pytest.raises(ValueError):
            ka.scatter_softmax_plan(*args)
    with pytest.raises(ValueError):
        ka.scatter_softmax_plan(2, 16, 16, 3, 4, 2)   # an even K


def test_softmax_plans_at_the_path_shapes():
    """On 132 SMs, each grid one wave over the blocks resident: K2 at LBMC
    (8 x 128^2, K 13, bf16) in runs of 32 and units of 11 runs, three blocks
    an SM, 384 units; at KPCN (8 x 72^2, K 21) in runs of 24 (no idle pixels
    on a 72-pixel row) and units of 7 runs, two blocks an SM, 264 units.  K3
    at LBMC in bands of 4 rows, two blocks an SM, 256 blocks; its band
    partials (4 + 12) / 4 of the canvas, 6.9 MB.  K3 at KPCN's K = 21 runs
    the gather body."""
    lbmc = ka.outer_softmax_plan(8, 128, 128, 3, 13, 2, 132)
    assert (lbmc.run, lbmc.rows, lbmc.units, lbmc.per_sm, lbmc.blocks) == (32, 11, 384, 3, 384)
    assert lbmc.total == 14848 + 768 + 22528 + 21632 + 128
    kpcn = ka.outer_softmax_plan(8, 72, 72, 3, 21, 2, 132)
    assert (kpcn.run, kpcn.rows, kpcn.units, kpcn.per_sm, kpcn.blocks) == (24, 7, 264, 2, 264)
    for plan in (lbmc, kpcn):
        assert 0.95 * plan.per_sm * 132 <= plan.blocks <= plan.per_sm * 132
    k3 = ka.scatter_softmax_plan(8, 128, 128, 3, 13, 2, 132)
    assert k3.banded and (k3.rows, k3.cols, k3.bands, k3.tiles, k3.per_sm) == (4, 128, 32, 1, 2)
    assert 0.95 * 2 * 132 <= 8 * k3.bands * k3.tiles <= 2 * 132
    assert k3.total == 43264 + 768 + 29184 + 33792 + 1152 + 128
    assert 8 * k3.scratch * 4 == 8 * 32 * 16 * 140 * 3 * 4
    assert not ka.scatter_softmax_plan(8, 72, 72, 3, 21, 2, 132).banded


# ---------------------------------------------------------------------------
# the routes
# ---------------------------------------------------------------------------

def test_softmax_routes_for_the_path_views():
    """Where each pixel's taps start within their 16-byte-aligned superset:
    LBMC's layer 0 (a 676-byte pixel stride) at 0, 4, 8 and 12 bytes, its
    layer 1 (338 bytes further) at 2, 6, 10 and 14; KPCN's crop (882-byte
    stride) and contiguous bf16 logits at K = 13 (338) at every even
    offset.  K2's gradient runs are bulk-stored at widths 128 and 72 (runs
    of 32 and 24 bf16 spans of whole 16-byte groups) and only where they
    happen to start and end on 16 bytes at 45; K3's cotangent runs land 16
    bytes at a time at LBMC."""
    b, k = 2, 13
    g = torch.zeros((b, 128, 128, 3))
    buf = torch.zeros((b, 140, 140, 3))
    evens = tuple(range(0, 16, 2))
    for layer, leads in ((0, (0, 4, 8, 12)), (1, (2, 6, 10, 14))):
        view = _head_view(b, 128, 128, k, layer)
        assert view.stride() == (128 * 128 * 338, 128 * 338, 338, 1)
        assert ka.outer_softmax_route(g, buf, view, k) == ka.SoftmaxRoute("tiled", leads, "16-byte")
        assert ka.scatter_softmax_route(g, view, k) == ka.SoftmaxRoute("banded", leads, "16-byte")
    contiguous = torch.zeros((b, 128, 128, k * k), dtype=torch.bfloat16)
    assert ka.outer_softmax_route(g, buf, contiguous, k).leads == evens
    crop = _crop_view(b, 72, 72, 21)
    assert crop.stride() == (92 * 92 * 441, 92 * 441, 441, 1)
    g72, buf72 = torch.zeros((b, 72, 72, 3)), torch.zeros((b, 92, 92, 3))
    assert ka.outer_softmax_route(g72, buf72, crop, 21) == ka.SoftmaxRoute("tiled", evens,
                                                                           "16-byte")
    assert ka.scatter_softmax_route(g72, crop, 21) == ka.SoftmaxRoute("gather", (), "")
    g45, buf45 = torch.zeros((b, 20, 45, 3)), torch.zeros((b, 32, 57, 3))
    assert ka.outer_softmax_route(g45, buf45, _head_view(b, 20, 45, k, 1), k).spans == "mixed"
    assert ka.scatter_softmax_route(g45, _head_view(b, 20, 45, k, 1), k).spans == "mixed"


def test_softmax_routes_off_16_bytes():
    """Logits 2 bytes off 16 start at every even offset; a cotangent 4
    bytes off 16 lands 4 bytes at a time, and one that is not f32 and
    contiguous is read from a fresh copy."""
    b, h, w, k = 2, 21, 40, 13
    flat = torch.zeros(b * h * w * k * k + 1, dtype=torch.bfloat16)
    lg = flat[1:].view(b, h, w, k * k)
    assert lg.data_ptr() % 16 and lg.is_contiguous()
    g = torch.zeros(b * h * w * 3 + 1)[1:].view(b, h, w, 3)
    buf = torch.zeros((b, h + k - 1, w + k - 1, 3))
    assert ka.outer_softmax_route(g, buf, lg, k).leads == tuple(range(0, 16, 2))
    assert ka.scatter_softmax_route(g, lg, k) == ka.SoftmaxRoute("banded", tuple(range(0, 16, 2)),
                                                                  "4-byte")
    assert ka.scatter_softmax_route(g.double(), lg, k).spans == "16-byte"


# ---------------------------------------------------------------------------
# the walks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,w,k,c", [(2, 16, 16, 5, 3), (1, 19, 45, 13, 3), (2, 11, 72, 13, 3),
                                       (1, 9, 17, 5, 8), (1, 33, 40, 5, 1)])
def test_walks_match_the_plain_versions(b, h, w, k, c):
    g, buf, lg = _inputs(1, b, h, w, k, c)
    _close(ka._outer_softmax_tiled_walk(g, buf, lg, k), ka.outer_softmax_plain(g, buf, lg, k))
    _close(ka._scatter_softmax_banded_walk(g, lg, k), ka.scatter_softmax_plain(g, lg, k))


@pytest.mark.parametrize("k,h,w", [(5, 12, 20), (13, 9, 33), (21, 16, 16)])
def test_walks_match_the_xla_vjp(k, h, w):
    """Both walks against ``jax.vjp`` of ``wcmc_tpu``'s
    ``kernel_gather_softmax`` (its XLA path on the CPU), f32; K3's banded
    body takes no K = 21, so its walk is held at K 5 and 13."""
    g, buf, lg = _inputs(2, 2, h, w, k)
    _, vjp = jax.vjp(lambda bb, ll: jka.kernel_gather_softmax(bb, ll, k),
                     jnp.asarray(buf.numpy()), jnp.asarray(lg.numpy()))
    want_dbuf, want_dlogits = vjp(jnp.asarray(g.numpy()))
    _close(ka._outer_softmax_tiled_walk(g, buf, lg, k), want_dlogits)
    if k <= 13:
        _close(ka._scatter_softmax_banded_walk(g, lg, k), want_dbuf)


def test_walks_match_the_pallas_kernels_bf16():
    """At K = 5 with bf16 logits against ``outer_softmax_tpu`` and
    ``scatter_tpu(softmax=True)`` interpreted: d buf within 1e-5, d logits
    (one bf16 rounding on each side) within 1e-2."""
    k = 5
    g, buf, lg = _inputs(3, 2, 16, 12, k)
    lt = lg.to(torch.bfloat16)
    jl = jnp.asarray(lt.float().numpy(), jnp.bfloat16)
    jpk.INTERPRET, jmf.FORCE_PALLAS = True, True
    try:
        want_dlogits = jpk.outer_softmax_tpu(jnp.asarray(g.numpy()), jnp.asarray(buf.numpy()),
                                             jl, k)
        want_dbuf = jpk.scatter_tpu(jnp.asarray(g.numpy()), jl, k, softmax=True)
    finally:
        jpk.INTERPRET, jmf.FORCE_PALLAS = False, False
    got = ka._outer_softmax_tiled_walk(g, buf, lt, k)
    assert got.dtype == torch.bfloat16 and want_dlogits.dtype == jnp.bfloat16
    _close(got, want_dlogits, BF16_OUT_TOL)
    _close(ka._scatter_softmax_banded_walk(g, lt, k), want_dbuf)


@pytest.mark.parametrize("view", ["layer0", "layer1", "crop"])
def test_walks_read_strided_views_in_place(view):
    """A walk over LBMC's layer views or KPCN's crop gives the walk over the
    view's contiguous copy, bit for bit."""
    b, h, w = 2, 10, 40
    k = 21 if view == "crop" else 13
    lg = _crop_view(b, h, w, k, torch.float32) if view == "crop" else _head_view(
        b, h, w, k, int(view[-1]), torch.float32)
    g, buf, values = _inputs(4, b, h, w, k)
    lg.copy_(values)
    assert not lg.is_contiguous()
    flat = lg.contiguous()
    assert torch.equal(ka._outer_softmax_tiled_walk(g, buf, lg, k),
                       ka._outer_softmax_tiled_walk(g, buf, flat, k))
    if k <= 13:
        assert torch.equal(ka._scatter_softmax_banded_walk(g, lg, k),
                           ka._scatter_softmax_banded_walk(g, flat, k))


def test_softmax_lanes_is_the_softmax():
    """The lanes' order gives the softmax within f32 rounding, and the
    xor butterfly sums 32 lanes."""
    lg = torch.from_numpy(np.random.default_rng(5).standard_normal((3, 7, 169)).astype(np.float32))
    _close(ka._softmax_lanes(lg), torch.softmax(lg, dim=-1))
    v = torch.arange(64, dtype=torch.float32).view(2, 32)
    assert ka._warp_sum(v).tolist() == [496.0, 1520.0]


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


def test_chip_smoke_tells_the_softmax_bodies_apart():
    """K2's tiled body files as ``outer_softmax_tiled``, K3's banded body and
    its band sums as ``scatter_softmax_banded``, apart from their first
    bodies (``outer_softmax``; ``scatter_softmax``, the statistics and the
    gather) and from K7's and K8's kinds.  ``device_ms`` of K3 reads both
    launches of a call.  A KPCN or LBMC train profile whose K2 or K3
    entries are a first body's, or lack the new one's, is refused (its K1,
    and LBMC's K10, on their new bodies)."""
    cs = _chip_smoke()
    names = {
        "void wcmc::outer_softmax_tiled_kernel<__nv_bfloat16, 3, 6>("
        "wcmc::OuterSoftmaxArgs<__nv_bfloat16>)": "outer_softmax_tiled",
        "void wcmc::scatter_softmax_banded_kernel<__nv_bfloat16, 3, 13>("
        "wcmc::SoftmaxBandArgs<__nv_bfloat16>)": "scatter_softmax_banded",
        "wcmc::scatter_softmax_band_sum_kernel(wcmc::SplatBandArgs, float*, int)":
            "scatter_softmax_banded",
        "void wcmc::outer_kernel<__nv_bfloat16, __nv_bfloat16, true>(float const*)":
            "outer_softmax",
        "void wcmc::softmax_stats_kernel<__nv_bfloat16>(__nv_bfloat16 const*, float2*)":
            "scatter_softmax",
        "void wcmc::splat_gather_kernel<__nv_bfloat16, true>(float const*)": "scatter_softmax",
        "wcmc::splat_band_sum_kernel(wcmc::SplatBandArgs, float*, int)": "scatter_banded",
        "void wcmc::outer_tiled_kernel<4>(float const*, float const*, float*, int)":
            "outer_tiled",
    }
    for name, kind in names.items():
        assert cs.device_kind(name) == kind
    assert cs.REDESIGNED_BODIES["outer_softmax"] == "outer_softmax_tiled"
    assert cs.REDESIGNED_BODIES["scatter_softmax"] == "scatter_softmax_banded"
    lbmc = [k for k in cs.REDESIGNED_BODIES if k in cs.TRAIN_LAUNCHES["lbmc"]]
    kpcn = [k for k in cs.REDESIGNED_BODIES if k in cs.TRAIN_LAUNCHES["kpcn"]]
    assert {"outer_softmax", "scatter_softmax"} <= set(lbmc)
    assert kpcn == ["outer_softmax", "gather_softmax"]
    others = {"mlp_fused_bwd_tiled": 0.1, "gather_softmax_tiled": 0.1, "mlp_fused_tiled": 0.1}
    good = {"outer_softmax_tiled": 0.08, "scatter_softmax_banded": 0.07, **others}
    cs.check_redesigned_body(good, "train_lbmc", lbmc)
    cs.check_redesigned_body({"outer_softmax_tiled": 0.05, "gather_softmax_tiled": 0.09},
                             "train", kpcn)
    for bad in ({**good, "outer_softmax": 0.2}, {**good, "scatter_softmax": 0.2},
                {"outer_softmax_tiled": 0.08, **others},
                {"outer_softmax": 0.44, "scatter_softmax": 0.43, **others}):
        with pytest.raises(AssertionError):
            cs.check_redesigned_body(bad, "train_lbmc", lbmc)
    band = "void wcmc::scatter_softmax_banded_kernel<__nv_bfloat16, 3, 13>(x)"
    total = "wcmc::scatter_softmax_band_sum_kernel(wcmc::SplatBandArgs, float*, int)"
    events = [(band, 0.0, 40.0), (total, 40.0, 5.0), (band, 100.0, 42.0), (total, 142.0, 5.0)]
    kinds = ("scatter_softmax", "scatter_softmax_tiled", "scatter_softmax_banded")
    assert cs.median_device_ms(events, kinds, 2, per_call=2) == 0.046
    assert cs.median_device_ms(events[::2], kinds, 2, per_call=2) is None
