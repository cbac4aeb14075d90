"""What surrounds K1's tiled body, the softmax gather's forward, on the CPU
(the kernel itself runs only on the card: ``tests/test_torch_kernels_gpu.py``).

* ``gather_softmax_plan``: its shared-memory carve at K 5, 13 and 21, C 1,
  3 and 4 and 2- or 4-byte logits, its refusals, and its grids at the LBMC
  and KPCN shapes and at KPCN's 256-pixel tiles without paths on 132 SMs
  (one wave over the resident blocks at each).
* ``gather_softmax_route``: the tiled body up to K = 21 and the first body
  above; the leading bytes of the pixels' landed taps and how the output
  runs are stored, for LBMC's layer-0 and layer-1 views of a channels-last
  (B, 338, h, w) kernel head, KPCN's crop of a convolution output and
  logits 2 bytes off 16.
* ``_gather_softmax_tiled_walk``, a plain walk of the body's order, within
  1e-5 of max of ``gather_softmax_plain`` in f32 and of ``wcmc_tpu``'s
  ``_gather_xla`` over an f32 softmax (its XLA path), and within 1e-5 of
  ``gather_tpu(softmax=True)`` interpreted at K = 5 with bf16 logits (the
  logits are read exactly and the math is f32 on both sides).  A walk over
  a strided view equals the walk over its contiguous copy.
* ``chip_smoke.py`` files the new body's profile entries apart from the
  first body's and from K9's, and refuses a path profile that holds the
  first body's.
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
jpk = importlib.import_module("wcmc_tpu.ops.pallas_kernels")

TOL = 1e-5


def _close(got, want, tol=TOL):
    got = np.asarray(torch.as_tensor(got).detach().float(), np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want))


def _inputs(seed, b, h, w, k, c=3):
    rng = np.random.default_rng(seed)
    buf = rng.standard_normal((b, h + k - 1, w + k - 1, c)).astype(np.float32)
    logits = (2.0 * rng.standard_normal((b, h, w, k * k))).astype(np.float32)
    return torch.from_numpy(buf), torch.from_numpy(logits)


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
# the plan
# ---------------------------------------------------------------------------

def _total(t, c, k, es):
    """K1's carve for runs of t pixels, counted here: the window ring (K + 1
    slots of t + K - 1 pixels, rows padded to 16 bytes, each twice), two
    landed logit runs (slots of the taps' 16-byte-aligned superset), two
    staging tiles of t C floats, the mbarriers."""
    pitch = -(-(t + k - 1) * c // 4) * 4
    lpitch = -(-(k * k * es + 16 - es) // 16) * 16
    return _r128(8 * (k + 1) * pitch) + _r128(2 * t * lpitch) + _r128(8 * t * c) + 128


@pytest.mark.parametrize("es", [2, 4])
@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("k", [5, 13, 21])
def test_gather_softmax_plan_fits(k, c, es):
    """The carve in the kernel's order, each buffer a multiple of 128 bytes
    and the whole within a block's shared memory; a run of whole 16-byte
    groups of bf16 taps; three blocks an SM up to K = 13, two above (the
    launch bounds), where the carve allows."""
    for w in (17, 45, 72, 128, 256):
        plan = ka.gather_softmax_plan(2, 40, w, c, k, es)
        t = plan.run
        assert t in ka.SOFTMAX_RUNS and t % 8 == 0
        assert [name for name, _ in plan.smem] == ["window", "logits", "tiles", "bars"]
        assert all(m % 128 == 0 for _, m in plan.smem)
        assert plan.total == sum(m for _, m in plan.smem) == _total(t, c, k, es) <= SMEM_LIMIT
        assert plan.pitch % 4 == 0 and plan.pitch >= (t + k - 1) * c
        assert 1 <= plan.per_sm <= (3 if k <= 13 else 2)
        assert plan.per_sm * (plan.total + 1024) <= ka.SM_SMEM
        assert 1 <= plan.rows <= ka.GATHER_SOFTMAX_MAX_ROWS
        assert plan.units == 2 * -(-40 // plan.rows) * -(-w // t)
        assert plan.blocks == min(plan.units, plan.per_sm * ka.H100_SMS)
        # no other run leaves fewer idle pixels at a row's end, or as few
        # and is longer, unless its carve does not fit
        idle = -(-w // t) * t - w
        for other in ka.SOFTMAX_RUNS:
            other_idle = -(-w // other) * other - w
            if other_idle < idle or (other_idle == idle and other > t):
                assert _total(other, c, k, es) > SMEM_LIMIT


@pytest.mark.parametrize("args", [(2, 16, 16, 0, 5, 2), (2, 16, 16, 9, 5, 2),
                                  (2, 16, 16, 3, 23, 2), (2, 16, 16, 3, 5, 1),
                                  (0, 16, 16, 3, 5, 2), (2, 16, 0, 3, 5, 2)])
def test_gather_softmax_plan_refuses_what_the_tiled_body_does_not_take(args):
    """C outside 1-8, K above 21 (14 taps a lane at most), logits neither
    f32 nor bf16, an empty batch or image."""
    with pytest.raises(ValueError):
        ka.gather_softmax_plan(*args)


def test_gather_softmax_plan_at_the_path_shapes():
    """On 132 SMs, each grid one wave over the blocks resident: LBMC (8 x
    128^2, K 13, bf16) in runs of 32 and units of 11 runs, three blocks an
    SM, 384 units; KPCN (8 x 72^2, K 21) in runs of 24 (no idle pixels on a
    72-pixel row) and units of 7, two blocks an SM, 264 units; KPCN without
    paths (8 x 256^2 tiles, K 21) in runs of 32 and units of 64 runs, 256
    units on 264 resident blocks (K2's 32 runs a unit at most would take two
    waves)."""
    lbmc = ka.gather_softmax_plan(8, 128, 128, 3, 13, 2, 132)
    assert (lbmc.run, lbmc.rows, lbmc.units, lbmc.per_sm, lbmc.blocks) == (32, 11, 384, 3, 384)
    assert lbmc.total == 14848 + 22528 + 768 + 128
    kpcn = ka.gather_softmax_plan(8, 72, 72, 3, 21, 2, 132)
    assert (kpcn.run, kpcn.rows, kpcn.units, kpcn.per_sm, kpcn.blocks) == (24, 7, 264, 2, 264)
    assert kpcn.total == 23296 + 43008 + 640 + 128
    nopath = ka.gather_softmax_plan(8, 256, 256, 3, 21, 2, 132)
    assert (nopath.run, nopath.rows, nopath.units, nopath.per_sm) == (32, 64, 256, 2)
    for plan in (lbmc, kpcn, nopath):
        assert plan.units <= plan.per_sm * 132
        assert 0.95 * plan.per_sm * 132 <= plan.blocks <= plan.per_sm * 132


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

def test_gather_softmax_route_for_the_path_views():
    """Where each pixel's taps start within their 16-byte-aligned superset:
    LBMC's layer 0 (a 676-byte pixel stride) at 0, 4, 8 and 12 bytes, its
    layer 1 at 2, 6, 10 and 14; KPCN's crop (882-byte stride) at every even
    offset.  Output runs of 32 or 24 pixels of 3 f32 start and end on 16
    bytes at widths 128 and 72; at 45 only some do."""
    b, k = 2, 13
    buf = torch.zeros((b, 140, 140, 3))
    for layer, leads in ((0, (0, 4, 8, 12)), (1, (2, 6, 10, 14))):
        view = _head_view(b, 128, 128, k, layer)
        assert ka.gather_softmax_route(buf, view, k) == ka.SoftmaxRoute("tiled", leads, "16-byte")
    crop = _crop_view(b, 72, 72, 21)
    assert crop.stride() == (92 * 92 * 441, 92 * 441, 441, 1)
    assert ka.gather_softmax_route(torch.zeros((b, 92, 92, 3)), crop, 21) == ka.SoftmaxRoute(
        "tiled", tuple(range(0, 16, 2)), "16-byte")
    buf45 = torch.zeros((b, 32, 57, 3))
    assert ka.gather_softmax_route(buf45, _head_view(b, 20, 45, k, 1), k).spans == "mixed"


def test_gather_softmax_route_off_16_bytes_and_above_k21():
    """Logits 2 bytes off 16 start at every even offset; K above 21 takes
    the first body, whose route has no runs."""
    b, h, w, k = 2, 21, 40, 13
    flat = torch.zeros(b * h * w * k * k + 1, dtype=torch.bfloat16)
    lg = flat[1:].view(b, h, w, k * k)
    assert lg.data_ptr() % 16 and lg.is_contiguous()
    buf = torch.zeros((b, h + k - 1, w + k - 1, 3))
    assert ka.gather_softmax_route(buf, lg, k).leads == tuple(range(0, 16, 2))
    k = 23
    buf = torch.zeros((1, 6 + k - 1, 9 + k - 1, 3))
    lg = torch.zeros((1, 6, 9, k * k), dtype=torch.bfloat16)
    assert ka.gather_softmax_route(buf, lg, k) == ka.SoftmaxRoute("warp", (), "")


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,w,k,c", [(2, 16, 16, 5, 3), (1, 19, 45, 13, 3), (2, 11, 72, 13, 3),
                                       (1, 9, 17, 5, 8), (1, 33, 40, 5, 1), (1, 10, 20, 21, 3)])
def test_walk_matches_the_plain_version(b, h, w, k, c):
    buf, lg = _inputs(1, b, h, w, k, c)
    got = ka._gather_softmax_tiled_walk(buf, lg, k)
    assert got.dtype == torch.float32
    _close(got, ka.gather_softmax_plain(buf, lg, k))


@pytest.mark.parametrize("k,h,w", [(5, 12, 20), (13, 9, 33), (21, 16, 16)])
def test_walk_matches_the_xla_gather(k, h, w):
    """The walk against ``wcmc_tpu``'s ``_gather_xla`` over the f32 softmax
    of the logits (what its XLA path of ``kernel_gather_softmax``
    computes) and against that path itself."""
    buf, lg = _inputs(2, 2, h, w, k)
    jb, jl = jnp.asarray(buf.numpy()), jnp.asarray(lg.numpy())
    got = ka._gather_softmax_tiled_walk(buf, lg, k)
    _close(got, jka._gather_xla(jb, jax.nn.softmax(jl, axis=-1), k))
    _close(got, jka.kernel_gather_softmax(jb, jl, k))


def test_walk_matches_the_pallas_kernel_bf16():
    """At K = 5 with bf16 logits against ``gather_tpu(softmax=True)``
    interpreted: both read the logits exactly and sum in f32."""
    k = 5
    buf, lg = _inputs(3, 2, 16, 12, k)
    lt = lg.to(torch.bfloat16)
    jl = jnp.asarray(lt.float().numpy(), jnp.bfloat16)
    jpk.INTERPRET = True
    try:
        want = jpk.gather_tpu(jnp.asarray(buf.numpy()), jl, k, softmax=True)
    finally:
        jpk.INTERPRET = False
    _close(ka._gather_softmax_tiled_walk(buf, lt, k), want)


@pytest.mark.parametrize("view", ["layer0", "layer1", "crop"])
def test_walk_reads_strided_views_in_place(view):
    """A walk over LBMC's layer views or KPCN's crop gives the walk over the
    view's contiguous copy, bit for bit."""
    b, h, w = 2, 10, 40
    k = 21 if view == "crop" else 13
    lg = _crop_view(b, h, w, k, torch.float32) if view == "crop" else _head_view(
        b, h, w, k, int(view[-1]), torch.float32)
    buf, values = _inputs(4, b, h, w, k)
    lg.copy_(values)
    assert not lg.is_contiguous()
    assert torch.equal(ka._gather_softmax_tiled_walk(buf, lg, k),
                       ka._gather_softmax_tiled_walk(buf, lg.contiguous(), k))


def test_gather_softmax_on_the_cpu_is_the_plain_version():
    """``gather_softmax`` on CPU tensors is ``gather_softmax_plain``, any
    body asked for."""
    buf, lg = _inputs(5, 1, 8, 9, 5)
    assert torch.equal(ka.gather_softmax(buf, lg, 5), ka.gather_softmax_plain(buf, lg, 5))
    assert torch.equal(ka.gather_softmax(buf, lg, 5, body="warp"), ka.gather_softmax(buf, lg, 5))
    with pytest.raises(ValueError):
        ka.gather_softmax(buf, lg, 7)


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


def test_chip_smoke_tells_the_gather_softmax_bodies_apart():
    """K1's tiled body files as ``gather_softmax_tiled`` (every
    instantiation), its first body as ``gather_softmax``, K9 as ``gather``.
    Every KPCN and LBMC path requires the tiled body (SBMC's runs no K1); a
    profile whose K1 entries are the first body's, or lack the tiled one's,
    is refused; ``device_ms`` of K1 reads either body's entries."""
    cs = _chip_smoke()
    names = {
        "void wcmc::gather_softmax_tiled_kernel<__nv_bfloat16, 3, 6, 13>("
        "wcmc::GatherSoftmaxArgs<__nv_bfloat16>)": "gather_softmax_tiled",
        "void wcmc::gather_softmax_tiled_kernel<float, 4, 14, 0>("
        "wcmc::GatherSoftmaxArgs<float>)": "gather_softmax_tiled",
        "void wcmc::gather_kernel<__nv_bfloat16, true>(float const*, __nv_bfloat16 const*)":
            "gather_softmax",
        "void wcmc::gather_kernel<float, false>(float const*, float const*)": "gather",
    }
    for name, kind in names.items():
        assert cs.device_kind(name) == kind
    assert cs.REDESIGNED_BODIES["gather_softmax"] == "gather_softmax_tiled"
    for path in ("kpcn", "lbmc", "kpcn_fused", "kpcn_nopath", "kpcn_nopath_fused"):
        assert "gather_softmax" in [k for k in cs.REDESIGNED_BODIES
                                    if k in cs.SERVE[path]["launches"]]
    assert "gather_softmax" not in cs.SERVE["sbmc"]["launches"]
    for family in ("kpcn", "lbmc"):
        assert "gather_softmax" in [k for k in cs.REDESIGNED_BODIES
                                    if k in cs.TRAIN_LAUNCHES[family]]
    counters = [k for k in cs.REDESIGNED_BODIES if k in cs.SERVE["kpcn"]["launches"]]
    assert counters == ["gather_softmax"]
    cs.check_redesigned_body({"gather_softmax_tiled": 1.3}, "serve", counters)
    for bad in ({"gather_softmax": 1.3}, {"gather_softmax_tiled": 1.3, "gather_softmax": 0.1},
                {"gather": 1.3}):
        with pytest.raises(AssertionError):
            cs.check_redesigned_body(bad, "serve", counters)
    tiled = next(iter(names))
    first = "void wcmc::gather_kernel<__nv_bfloat16, true>(x)"
    events = [(tiled, 0.0, 40.0), (tiled, 100.0, 44.0), (first, 200.0, 150.0)]
    kinds = ("gather_softmax", "gather_softmax_tiled", "gather_softmax_banded")
    assert cs.median_device_ms(events, kinds, 3, per_call=1) == 0.044
