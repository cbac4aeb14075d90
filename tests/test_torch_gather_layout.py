"""What surrounds K9's tiled body, the weighted gather, on the CPU (the
kernel itself runs only on the card: ``tests/test_torch_kernels_gpu.py``).

* ``gather_plan``: its shared-memory carve at K 5, 13 and 21, C 1, 3, 4
  and 8 and 2- or 4-byte weights, its refusals, and its grids at the SBMC,
  KPCN and LBMC shapes on 132 SMs.
* ``gather_route``: the tiled body up to K = 21 and the first body above;
  how each run's weights land (one bulk copy for the splat's contiguous f32
  weights, each pixel's 16-byte-aligned superset for a strided view or a
  misaligned start) and how the output runs are stored.
* ``_gather_tiled_walk``, a plain walk of the body's order, within 1e-6 of
  max of ``gather_plain`` and of ``wcmc_tpu``'s ``_gather_xla`` and its
  ``kernel_apply(softmax=False)``, and within 1e-6 of
  ``gather_tpu(softmax=False)`` interpreted at K = 5 with f32 and bf16
  weights (the weights are read exactly and the math is f32 on both sides:
  only the order of the f32 sums differs).  A walk over a strided view
  equals the walk over its contiguous copy.
* ``chip_smoke.py`` files the new body's profile entries apart from the
  first body's and from K1's.
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
jpk = importlib.import_module("wcmc_tpu.ops.pallas_kernels")

TOL = 1e-6


def _close(got, want, tol=TOL):
    got = np.asarray(torch.as_tensor(got).detach().float(), np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want))


def _inputs(seed, b, h, w, k, c=4):
    """A buffer of standard normals and weights in [0, 1), as the splat's
    exp(logits - shift) gives them."""
    rng = np.random.default_rng(seed)
    buf = rng.standard_normal((b, h + k - 1, w + k - 1, c)).astype(np.float32)
    wt = rng.random((b, h, w, k * k)).astype(np.float32)
    return torch.from_numpy(buf), torch.from_numpy(wt)


def _r128(n):
    return -(-n // 128) * 128


def _crop_view(b, h, w, k, dtype=torch.bfloat16):
    """Weights as the centre crop of a channels-last convolution output."""
    r = k // 2
    conv = torch.zeros((b, k * k, h + 2 * r, w + 2 * r), dtype=dtype).contiguous(
        memory_format=torch.channels_last)
    return conv.permute(0, 2, 3, 1)[:, r:r + h, r:r + w]


def _head_view(b, h, w, k, layer, dtype=torch.bfloat16):
    """A layer's slice of a channels-last (B, 2 K*K, h, w) kernel head."""
    head = torch.zeros((b, 2 * k * k, h, w), dtype=dtype).contiguous(
        memory_format=torch.channels_last)
    return head.permute(0, 2, 3, 1)[..., layer * k * k:(layer + 1) * k * k]


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def _total(t, c, k, es):
    """K9's carve for runs of t pixels, counted here: the window ring (K + 1
    slots of t + K - 1 pixels, rows padded to 16 bytes, each twice), two
    landed weight runs (slots of the taps' 16-byte-aligned superset, which
    also hold a run landed packed by one bulk copy), two staging tiles of t C
    floats, the mbarriers."""
    pitch = -(-(t + k - 1) * c // 4) * 4
    lpitch = -(-(k * k * es + 16 - es) // 16) * 16
    assert lpitch >= k * k * es
    return _r128(8 * (k + 1) * pitch) + _r128(2 * t * lpitch) + _r128(8 * t * c) + 128


@pytest.mark.parametrize("es", [2, 4])
@pytest.mark.parametrize("c", [1, 3, 4, 8])
@pytest.mark.parametrize("k", [5, 13, 21])
def test_gather_plan_fits(k, c, es):
    """The carve in the kernel's order, each buffer a multiple of 128 bytes
    and the whole within a block's shared memory; three blocks an SM up to
    K = 13, two above (the launch bounds), where the carve allows."""
    for w in (17, 45, 72, 128, 256):
        plan = ka.gather_plan(2, 40, w, c, k, es)
        t = plan.run
        assert t in ka.SOFTMAX_RUNS
        assert [name for name, _ in plan.smem] == ["window", "weights", "tiles", "bars"]
        assert all(m % 128 == 0 for _, m in plan.smem)
        assert plan.total == sum(m for _, m in plan.smem) == _total(t, c, k, es) <= SMEM_LIMIT
        assert plan.pitch % 4 == 0 and plan.pitch >= (t + k - 1) * c
        assert 1 <= plan.per_sm <= (3 if k <= 13 else 2)
        assert plan.per_sm * (plan.total + 1024) <= ka.SM_SMEM
        assert 1 <= plan.rows <= ka.GATHER_SOFTMAX_MAX_ROWS
        assert plan.units == 2 * -(-40 // plan.rows) * -(-w // t)
        assert plan.blocks == min(plan.units, plan.per_sm * ka.H100_SMS)


@pytest.mark.parametrize("args", [(2, 16, 16, 0, 5, 4), (2, 16, 16, 9, 5, 4),
                                  (2, 16, 16, 4, 23, 4), (2, 16, 16, 4, 5, 1),
                                  (2, 16, 16, 4, 5, 8), (0, 16, 16, 4, 5, 4),
                                  (2, 0, 16, 4, 5, 4)])
def test_gather_plan_refuses_what_the_tiled_body_does_not_take(args):
    """C outside 1-8, K above 21 (14 taps a lane at most), weights neither
    f32 nor bf16, an empty batch or image."""
    with pytest.raises(ValueError):
        ka.gather_plan(*args)


def test_gather_plan_at_the_path_shapes():
    """On 132 SMs: the splat's d(values) (64 x 128^2, K 21, f32, C 4) in
    runs of 32 (56 KB of weights a run, so one block an SM) and units of 64
    runs, 512 units over 132 persistent blocks; KPCN's weights (8 x 72^2, K
    21, bf16) in runs of 24 and units of 7, two blocks an SM, 264 units in
    one wave; LBMC's (8 x 128^2, K 13, bf16) in runs of 32 and units of 11,
    three blocks an SM, 384 units in one wave."""
    sbmc = ka.gather_plan(64, 128, 128, 4, 21, 4, 132)
    assert (sbmc.run, sbmc.rows, sbmc.units, sbmc.per_sm, sbmc.blocks) == (32, 64, 512, 1, 132)
    assert sbmc.total == 36608 + 113664 + 1024 + 128
    kpcn = ka.gather_plan(8, 72, 72, 3, 21, 2, 132)
    assert (kpcn.run, kpcn.rows, kpcn.units, kpcn.per_sm, kpcn.blocks) == (24, 7, 264, 2, 264)
    lbmc = ka.gather_plan(8, 128, 128, 3, 13, 2, 132)
    assert (lbmc.run, lbmc.rows, lbmc.units, lbmc.per_sm, lbmc.blocks) == (32, 11, 384, 3, 384)
    # every block takes the same number of units at the SBMC shape but the
    # last 16, which take one fewer
    assert -(-sbmc.units // sbmc.blocks) == 4 and sbmc.units % sbmc.blocks == 116


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

def test_gather_route_for_the_path_views():
    """The splat's contiguous f32 weights land a run by one bulk copy (each
    run's 32 x 1764 bytes start and end on 16 bytes); KPCN's crop and LBMC's
    layer views land pixel by pixel; output runs of 32 or 24 pixels of 3 or 4
    f32 start and end on 16 bytes."""
    sbmc = torch.empty((64, 128, 128, 441))
    assert ka.gather_route(torch.empty((64, 148, 148, 4)), sbmc, 21) == ka.GatherRoute(
        "tiled", "bulk", "16-byte")
    crop = _crop_view(8, 72, 72, 21)
    assert ka.gather_route(torch.empty((8, 92, 92, 3)), crop, 21) == ka.GatherRoute(
        "tiled", "16-byte", "16-byte")
    for layer in (0, 1):
        view = _head_view(8, 128, 128, 13, layer)
        assert ka.gather_route(torch.empty((8, 140, 140, 3)), view, 13) == ka.GatherRoute(
            "tiled", "16-byte", "16-byte")


def test_gather_route_off_16_bytes_ragged_and_above_k21():
    """Weights 4 bytes off 16 land pixel by pixel; contiguous weights whose
    runs start on 16 bytes only at some columns land both ways; K above 21
    takes the first body, whose route has no runs."""
    b, h, w, k = 2, 21, 40, 13
    flat = torch.zeros(b * h * w * k * k + 1)
    wt = flat[1:].view(b, h, w, k * k)
    assert wt.data_ptr() % 16 and wt.is_contiguous()
    buf = torch.zeros((b, h + k - 1, w + k - 1, 3))
    assert ka.gather_route(buf, wt, k).landing == "16-byte"
    # 45-pixel rows: runs of 24 and 21 (5 px idle), 21 x 676 bytes not a
    # multiple of 16
    route = ka.gather_route(torch.zeros((1, 20 + k - 1, 45 + k - 1, 3)),
                            torch.zeros((1, 20, 45, k * k)), k)
    assert route.landing == "mixed" and route.spans == "mixed"
    k = 23
    buf = torch.zeros((1, 6 + k - 1, 9 + k - 1, 3))
    assert ka.gather_route(buf, torch.zeros((1, 6, 9, k * k)), k) == ka.GatherRoute(
        "warp", "", "")


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,w,k,c", [(2, 16, 16, 5, 4), (1, 19, 45, 13, 3), (2, 11, 72, 13, 3),
                                       (1, 9, 17, 5, 8), (1, 33, 40, 5, 1), (1, 10, 20, 21, 4)])
def test_walk_matches_the_plain_version(b, h, w, k, c):
    buf, wt = _inputs(1, b, h, w, k, c)
    got = ka._gather_tiled_walk(buf, wt, k)
    assert got.dtype == torch.float32
    _close(got, ka.gather_plain(buf, wt, k))


@pytest.mark.parametrize("k,h,w", [(5, 12, 20), (13, 9, 33), (21, 16, 16)])
def test_walk_matches_the_xla_gather(k, h, w):
    """The walk against ``wcmc_tpu``'s ``_gather_xla`` and its
    ``kernel_apply(softmax=False)`` (its XLA path off the TPU)."""
    buf, wt = _inputs(2, 2, h, w, k)
    jb, jw = jnp.asarray(buf.numpy()), jnp.asarray(wt.numpy())
    got = ka._gather_tiled_walk(buf, wt, k)
    _close(got, jka._gather_xla(jb, jw, k))
    _close(got, jka.kernel_apply(jb, jw, k, softmax=False))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_walk_matches_the_pallas_kernel(dtype):
    """At K = 5 against ``gather_tpu(softmax=False)`` interpreted, with f32
    and bf16 weights: both read the weights exactly and sum in f32."""
    k = 5
    buf, wt = _inputs(3, 2, 16, 12, k)
    wt = wt.to(dtype)
    jw = jnp.asarray(wt.float().numpy(), jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    jpk.INTERPRET = True
    try:
        want = jpk.gather_tpu(jnp.asarray(buf.numpy()), jw, k, softmax=False)
    finally:
        jpk.INTERPRET = False
    _close(ka._gather_tiled_walk(buf, wt, k), want)


@pytest.mark.parametrize("view", ["layer0", "layer1", "crop"])
def test_walk_reads_strided_views_in_place(view):
    """A walk over LBMC's layer views or KPCN's crop gives the walk over the
    view's contiguous copy, bit for bit."""
    b, h, w = 2, 10, 40
    k = 21 if view == "crop" else 13
    wt = _crop_view(b, h, w, k, torch.float32) if view == "crop" else _head_view(
        b, h, w, k, int(view[-1]), torch.float32)
    buf, values = _inputs(4, b, h, w, k, 3)
    wt.copy_(values)
    assert not wt.is_contiguous()
    assert torch.equal(ka._gather_tiled_walk(buf, wt, k),
                       ka._gather_tiled_walk(buf, wt.contiguous(), k))


def test_gather_on_the_cpu_is_the_plain_version():
    """``gather`` on CPU tensors is ``gather_plain``, any body asked for."""
    buf, wt = _inputs(5, 1, 8, 9, 5)
    assert torch.equal(ka.gather(buf, wt, 5), ka.gather_plain(buf, wt, 5))
    assert torch.equal(ka.gather(buf, wt, 5, body="warp"), ka.gather(buf, wt, 5))
    with pytest.raises(ValueError):
        ka.gather(buf, wt, 7)


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


def test_chip_smoke_tells_the_gather_bodies_apart():
    """K9's tiled body files as ``gather_tiled`` (every instantiation), its
    first body as ``gather``, K1's bodies as ``gather_softmax_tiled`` and
    ``gather_softmax``.  The autograd drive's profile must hold the tiled
    body alone; ``device_ms`` of K9 reads either body's entries."""
    cs = _chip_smoke()
    names = {
        "void wcmc::gather_tiled_kernel<float, 4, 14, 21>(wcmc::GatherArgs<float>)":
            "gather_tiled",
        "void wcmc::gather_tiled_kernel<__nv_bfloat16, 3, 6, 0>("
        "wcmc::GatherArgs<__nv_bfloat16>)": "gather_tiled",
        "void wcmc::gather_kernel<float, false>(float const*, float const*)": "gather",
        "void wcmc::gather_softmax_tiled_kernel<float, 4, 14, 0>("
        "wcmc::GatherSoftmaxArgs<float>)": "gather_softmax_tiled",
        "void wcmc::gather_kernel<__nv_bfloat16, true>(float const*, __nv_bfloat16 const*)":
            "gather_softmax",
    }
    for name, kind in names.items():
        assert cs.device_kind(name) == kind
    assert cs.REDESIGNED_BODIES["gather"] == "gather_tiled"
    for launches in [cs.SERVE[p]["launches"] for p in cs.SERVE] + list(
            cs.TRAIN_LAUNCHES.values()):
        assert "gather" not in launches
    cs.check_redesigned_body({"gather_tiled": 1.7}, "autograd", ["gather"])
    for bad in ({"gather": 1.7}, {"gather_tiled": 1.7, "gather": 0.1}, {"gather_softmax": 1.7}):
        with pytest.raises(AssertionError):
            cs.check_redesigned_body(bad, "autograd", ["gather"])
    tiled = next(iter(names))
    first = "void wcmc::gather_kernel<float, false>(x)"
    events = [(tiled, 0.0, 700.0), (tiled, 1000.0, 710.0), (first, 2000.0, 1690.0)]
    assert cs.median_device_ms(events, ("gather", "gather_tiled", "gather_banded"), 3,
                               per_call=1) == 0.71
