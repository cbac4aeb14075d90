"""What surrounds K5-bwd's tensor-core f32 body (``csrc/pathnet_head_bwd_tf32.cu``,
split TF32 on ``mma.sync``), on the CPU (the kernel runs only on the card:
``tests/test_torch_kernels_gpu.py``).

* ``head_tc_form``: KPCN's head and the 64-wide PathNet's (Cout up to 8
  and up to 16) and Multisteps' update chain on their own instantiations,
  narrower heads zero-padded to the cheapest one that holds them, wider
  ones held by none.
* ``head_bwd_tc_plan``: the carve in the kernel's order (e twice, h1 / g1
  and g / gz at 64 rows, the context, ctx . W1c, G, gsum and gsq at 16
  pixels, the warps' rings of weight fragments, three k8 steps deep or,
  where that does not fit, two) against a block's shared memory, one block
  an SM, the partial's size.
* ``pack_b_tf32`` / ``pack_head_tf32``: element by element the mma.m16n8k8
  B fragments' hi and lo, k t and k t + 4 on channels 2t and 2t + 1; the six
  matrices one after the other, zero past the head's widths; packed once
  per parameter value.
* ``_head_bwd_tc_walk``, the body's split-TF32 arithmetic over its tiles,
  chunks, k8 steps and blocks, against ``_head_bwd_plain`` at f32 and
  wcmc_tpu's head backward (the XLA VJP) at f32: weight and bias gradients
  within 5e-3 of max, d(e) and d(ctx) within 1e-3 in relative L2
  (``chip_smoke.py``'s F32 tolerances), at odd shapes: Cout 6 and 3 padded
  to one n8 tile, 12 and 16 on two, channel-major and channels-last cotangents, S not a
  multiple of the chunk's 4 samples, HW not one of the tile's 16 pixels, a
  narrower head zero-padded, cotangents absent.
* The routing of ``_head_bwd_kernel`` on card tensors: f32 to
  ``wcmc_pathnet_head_bwd_tf32``, ``body="simt"`` to the SIMT body's
  ``wcmc_pathnet_head_bwd_f32``, an unknown body a ValueError; a head no
  form holds to the SIMT body, so every head the SIMT body's plan takes is
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
from wcmc_tpu_torch.ops._tf32 import split_tf32
from wcmc_tpu_torch.ops.conv5 import SMEM_LIMIT

jpf = importlib.import_module("wcmc_tpu.ops.pathnet_fused")

F32_GRAD_TOL, F32_ROW_L2_TOL = 5e-3, 1e-3


def test_head_tc_form():
    assert pf.head_tc_form(128, 128, 256, 6) == (128, 256, 8)
    assert pf.head_tc_form(64, 64, 128, 3) == (64, 128, 8)
    assert pf.head_tc_form(128, 128, 128, 128) == (128, 128, 128)
    assert pf.head_tc_form(48, 40, 100, 5) == (64, 128, 8)
    assert pf.head_tc_form(100, 128, 200, 6) == (128, 256, 8)   # C1 200 needs 256
    assert pf.head_tc_form(128, 128, 128, 6) == (128, 128, 128)   # fewer multiply-adds a row
    # the PathNet heads with 9 to 16 outputs (KPCN's with --pnet_out_size 6: 12)
    assert pf.head_tc_form(128, 128, 256, 12) == (128, 256, 16)
    assert pf.head_tc_form(128, 128, 200, 16) == (128, 256, 16)
    assert pf.head_tc_form(64, 64, 128, 12) == (64, 128, 16)
    for dims in ((129, 128, 128, 6), (128, 128, 257, 6), (128, 128, 256, 17)):
        assert pf.head_tc_form(*dims) is None
        with pytest.raises(ValueError):
            pf.head_bwd_tc_plan(1, 16, *dims)
    with pytest.raises(ValueError):
        pf.head_tc_form(0, 64, 128, 3)


@pytest.mark.parametrize("form,total,ring", [
    ((128, 256, 8), 231936, 3), ((128, 256, 16), 220672, 2), ((64, 128, 8), 145920, 3),
    ((64, 128, 16), 151040, 3), ((128, 128, 128), 230912, 3)])
def test_head_bwd_tc_plan(form, total, ring):
    ce, c1, kout = form
    plan = pf.head_bwd_tc_plan(8, 128 * 128, ce, ce, c1, kout)
    assert plan.form == form
    assert [n for n, _ in plan.smem] == ["e0", "e1", "h", "g", "ctx", "zc", "G", "gsum", "gsq",
                                         "ring"]

    def pitch(c):
        return c if c == 8 else c + 8

    want = [64 * pitch(ce)] * 2 + [64 * pitch(c1), 64 * pitch(kout), 16 * pitch(ce)] \
        + [16 * pitch(c1)] * 2 + [16 * kout] * 2 + [8 * ring * 4 * 32 * 4]
    assert [m for _, m in plan.smem] == [-(-4 * c // 128) * 128 for c in want]
    assert plan.ring == ring
    assert plan.total == total <= SMEM_LIMIT
    assert (plan.tiles, plan.blocks) == (8 * 1024, 132)
    assert plan.parts == 2 * ce * c1 + c1 * kout + c1 + kout
    assert pf.head_bwd_tc_plan(1, 40, ce, ce, c1, kout).blocks == 3


def test_pack_b_tf32():
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.standard_normal((24, 40)).astype(np.float32))
    p = pf.pack_b_tf32(w)
    assert tuple(p.shape) == (5, 3, 32, 4)
    hi, lo = split_tf32(w)
    for jn in range(5):
        for ks in range(3):
            for lane in range(32):
                g, t = divmod(lane, 4)
                r0, r1, c = 8 * ks + 2 * t, 8 * ks + 2 * t + 1, 8 * jn + g
                want = [hi[r0, c], hi[r1, c], lo[r0, c], lo[r1, c]]
                assert p[jn, ks, lane].tolist() == [v.item() for v in want]


def test_pack_head_tf32():
    rng = np.random.default_rng(3)
    ce, c1, cout = 48, 100, 5
    w1 = torch.from_numpy(rng.standard_normal((2 * ce, c1)).astype(np.float32))
    w2 = torch.from_numpy(rng.standard_normal((c1, cout)).astype(np.float32))
    b1, b2 = torch.ones(c1), torch.ones(cout)
    form = pf.head_tc_form(ce, ce, c1, cout)
    wp, b1p, b2p = pf.pack_head_tf32(w1, w2, b1, b2, ce, form)
    kce, kc1, kout = form
    sizes = [kce * kc1, kce * kc1, kc1 * kout, kout * kc1, kc1 * kce, kc1 * kce]
    assert wp.numel() == 2 * sum(sizes)
    mats = torch.split(wp, [2 * m for m in sizes])

    def pad(w, k, n):
        out = torch.zeros((k, n))
        out[:w.shape[0], :w.shape[1]] = w
        return out

    w1e, w1c, w2p = pad(w1[:ce], kce, kc1), pad(w1[ce:], kce, kc1), pad(w2, kc1, kout)
    for got, m in zip(mats, (w1e, w1c, w2p, w2p.t(), w1e.t(), w1c.t())):
        assert torch.equal(got, pf.pack_b_tf32(m).reshape(-1))
    assert b1p[:c1].eq(1).all() and not b1p[c1:].any() and not b2p[cout:].any()


def _case(b, s, hw, ce, c1, cout, cmajor, seed):
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))

    e, ctx = f(b, s, hw, ce), f(b, hw, ce)
    ws = [f(2 * ce, c1, scale=(2 * ce) ** -0.5), f(c1, cout, scale=c1 ** -0.5)]
    bs = [f(c1, scale=0.1), f(cout, scale=0.1)]
    g = f(*((b, s, cout, hw) if cmajor else (b, s, hw, cout)))
    return e, ctx, g, f(b, hw, cout), f(b, hw, cout, scale=0.1), ws, bs


def _close(got, want, tol):
    got, want = torch.as_tensor(np.array(got)).double(), torch.as_tensor(np.array(want)).double()
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()


def _close_l2(got, want, tol):
    got, want = torch.as_tensor(np.array(got)).double(), torch.as_tensor(np.array(want)).double()
    assert got.shape == want.shape
    assert ((got - want).norm() / want.norm()).item() <= tol


def _check(got, want):
    _close_l2(got[0], want[0], F32_ROW_L2_TOL)
    _close_l2(got[1], want[1], F32_ROW_L2_TOL)
    assert len(got[2]) == len(want[2]) == 2
    for a, w in zip(list(got[2]) + list(got[3]), list(want[2]) + list(want[3])):
        _close(a, w, F32_GRAD_TOL)


# (ce, c1, cout, acts, moments, cmajor, b, s, hw)
WALKS = {
    "kpcn_cmajor": (128, 256, 6, pf.HEAD_ACTS, True, True, 1, 5, 21),
    "kpcn_cout12": (128, 256, 12, pf.HEAD_ACTS, True, True, 1, 3, 19),
    "pathnet64": (64, 128, 3, pf.HEAD_ACTS, True, False, 2, 3, 40),
    "pathnet64_cout16": (64, 128, 16, pf.HEAD_ACTS, True, True, 1, 5, 24),
    "multisteps": (128, 128, 128, pf.LEAKY[:2], True, False, 1, 2, 17),
    "multisteps_bare": (128, 128, 128, pf.LEAKY[:2], False, False, 1, 4, 16),
    "padded": (48, 100, 5, pf.HEAD_ACTS, True, True, 1, 6, 30),
}


@pytest.mark.parametrize("name", list(WALKS))
def test_head_bwd_tc_walk(name):
    ce, c1, cout, acts, moments, cmajor, b, s, hw = WALKS[name]
    e, ctx, g, gsum, gsq, ws, bs = _case(b, s, hw, ce, c1, cout, cmajor, 7)
    if not moments:
        gsum = gsq = None
    got = pf._head_bwd_tc_walk(e, ctx, g, gsum, gsq, ws, bs, acts, cmajor, sms=2)
    _check(got, pf._head_bwd_plain(e, ctx, g, gsum, gsq, ws, bs, acts, cmajor))
    # wcmc_tpu's head backward on the CPU: the VJP of its XLA head
    _, vjp = jax.vjp(lambda e_, c_, w_, b_: jpf.pathnet_head(e_, c_, w_, b_, acts, moments,
                                                             jnp.float32, cmajor),
                     jnp.asarray(e.numpy()), jnp.asarray(ctx.numpy()),
                     [jnp.asarray(w.numpy()) for w in ws], [jnp.asarray(v.numpy()) for v in bs])
    cot = jnp.asarray(g.numpy())
    if moments:
        cot = (cot, jnp.asarray(gsum.numpy()), jnp.asarray(gsq.numpy()))
    de, dctx, jws, jbs = vjp(cot)
    _check(got, (de, dctx, jws, jbs))


def test_head_bwd_tc_walk_absent_cotangents():
    """An absent cotangent reads as zeros, the output's or the moments'."""
    e, ctx, g, gsum, gsq, ws, bs = _case(1, 3, 20, 64, 128, 3, True, 8)
    for gs in ((g, None, None), (None, gsum, gsq)):
        got = pf._head_bwd_tc_walk(e, ctx, *gs, ws, bs, pf.HEAD_ACTS, True, sms=3)
        _check(got, pf._head_bwd_plain(e, ctx, *gs, ws, bs, pf.HEAD_ACTS, True))


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


@pytest.mark.parametrize("name", ["kpcn_cmajor", "kpcn_cout12", "pathnet64", "pathnet64_cout16",
                                  "multisteps", "padded"])
def test_head_bwd_routes_f32_to_the_tensor_cores(launches, name):
    ce, c1, cout, acts, moments, cmajor, b, s, hw = WALKS[name]
    e, ctx, g, gsum, gsq, ws, bs = _case(b, s, hw, ce, c1, cout, cmajor, 9)
    with pytest.raises(_Launch) as info:
        pf._head_bwd_kernel(e, ctx, g, gsum, gsq, ws, bs, acts, cmajor)
    entry, args = info.value.args
    assert entry == "wcmc_pathnet_head_bwd_tf32"
    # B, S, HW, then the form's widths, Cout, the activation codes, cmajor, blocks
    form = pf.head_tc_form(ce, ce, c1, cout)
    assert args[12:22] == (b, s, hw, *form, cout, *(pf.ACTS.index(a) for a in acts),
                           int(cmajor))
    with pytest.raises(_Launch) as info:
        pf._head_bwd_kernel(e, ctx, g, gsum, gsq, ws, bs, acts, cmajor, body="simt")
    assert info.value.args[0] == "wcmc_pathnet_head_bwd_f32"
    with pytest.raises(ValueError, match="body"):
        pf._head_bwd_kernel(e, ctx, g, gsum, gsq, ws, bs, acts, cmajor, body="wgmma")


def test_head_bwd_tc_packs_once(launches):
    e, ctx, g, gsum, gsq, ws, bs = _case(1, 2, 16, 64, 128, 3, False, 10)
    pf._packed.clear()
    for _ in range(2):
        with pytest.raises(_Launch):
            pf._head_bwd_kernel(e, ctx, g, gsum, gsq, ws, bs, pf.HEAD_ACTS, False)
    assert (pf._packed.misses, pf._packed.hits) == (1, 1)
    ws[1].add_(1.0)
    with pytest.raises(_Launch):
        pf._head_bwd_kernel(e, ctx, g, gsum, gsq, ws, bs, pf.HEAD_ACTS, False)
    assert pf._packed.misses == 2


# Widths (Ce, Cc, C1, Cout) the SIMT body's plan takes: the entry points'
# heads with any --pnet_out_size (KPCN's dual PathNet [128 | 128] -> 256 ->
# 2 outc, LBMC's and SBMC's [64 | 64] -> 128 -> outc), and a sweep of widths
# up to 256
WIDTHS = (1, 3, 8, 16, 17, 64, 100, 128, 129, 200, 256)
ENTRY_HEADS = [(128, 128, 256, 2 * o) for o in (3, 6, 8, 9, 12, 64, 128)] \
    + [(64, 64, 128, o) for o in (3, 6, 16, 17, 128, 200, 256)]


def _routed(ce, cc, c1, cout):
    """The entry point ``_head_bwd_kernel`` launches for an f32 head."""
    e = torch.zeros((1, 1, 1, ce))
    ctx = torch.zeros((1, 1, cc))
    ws, bs = [torch.zeros((ce + cc, c1)), torch.zeros((c1, cout))], [torch.zeros(c1),
                                                                       torch.zeros(cout)]
    with pytest.raises(_Launch) as info:
        pf._head_bwd_kernel(e, ctx, None, None, None, ws, bs, pf.HEAD_ACTS, False)
    return info.value.args[0]


@pytest.mark.parametrize("dims", ENTRY_HEADS)
def test_head_bwd_routes_entry_heads(launches, dims):
    """Every PathNet head an entry point builds runs: on the tensor-core
    body where a form holds it (the dual head's Cout up to 16, the 64-wide
    head's up to 128 on Multisteps' form), else on the SIMT body."""
    want = ("wcmc_pathnet_head_bwd_tf32" if pf.head_tc_form(*dims) is not None
            else "wcmc_pathnet_head_bwd_f32")
    assert _routed(*dims) == want
    assert (want == "wcmc_pathnet_head_bwd_tf32") == (dims[3] <= (16 if dims[2] == 256 else 128))


@pytest.mark.parametrize("c1", WIDTHS)
def test_head_bwd_refuses_no_head_the_simt_plan_takes(launches, c1):
    """No f32 head the SIMT body's plan takes is refused: each is launched,
    on the tensor-core body exactly where a form holds it."""
    pf._packed.clear()
    for ce in WIDTHS:
        for cout in WIDTHS:
            cc = WIDTHS[(WIDTHS.index(ce) + WIDTHS.index(cout)) % len(WIDTHS)]
            try:
                pf.head_f32_plan(1, 1, ce, cc, c1, cout, bwd=True)
            except ValueError:
                continue
            tc = pf.head_tc_form(ce, cc, c1, cout) is not None
            assert _routed(ce, cc, c1, cout) == ("wcmc_pathnet_head_bwd_tf32" if tc
                                                 else "wcmc_pathnet_head_bwd_f32")
