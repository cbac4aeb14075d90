"""What surrounds K5-fwd's tensor-core f32 body (``csrc/pathnet_head_tf32.cu``,
split TF32 on ``mma.sync``), on the CPU (the kernel runs only on the card:
``tests/test_torch_kernels_gpu.py``).

* ``head_fwd_tc_plan``: K5-bwd's forms (``head_tc_form``: KPCN's head and
  the 64-wide PathNet's with Cout up to 8 and up to 16, Multisteps' update
  chain); the carve in the kernel's order (e twice, h1 and the output at
  64 rows, a narrow head's output as the 8 warps' partials, the context and
  ctx . W1c at 16 pixels) against a block's shared memory, two blocks an
  SM where a 64-wide form's carve lets them.
* The pack is K5-bwd's (``pack_head_tf32``, element by element in
  ``tests/test_torch_head_bwd_tf32.py``): a forward and then a backward
  of the same parameters pack once.
* ``_head_fwd_tc_walk``, the body's split-TF32 arithmetic (k8 step by k8
  step, ctx . W1c added before b1, a narrow head's output product split
  over 8 warps by k8 steps and summed in warp order, the moments in sample
  order), against ``_head_plain`` at f32 and wcmc_tpu's ``_head_xla`` at
  f32 on the JAX CPU from the same numpy seeds, within 1e-4 of max
  (``chip_smoke.py``'s F32_FWD_TOL), at odd shapes: Cout 3, 6 and 12
  padded, channel-major and channels-last, moments on and off, a bf16
  output, S not a multiple of the chunk's 4 samples, HW not one of the
  tile's 16 pixels, a narrower head zero-padded.
* The routing of ``_head_fwd_kernel`` on card tensors: f32 to
  ``wcmc_pathnet_head_tf32``, ``body="simt"`` to the SIMT body's
  ``wcmc_pathnet_head_f32``, an unknown body a ValueError; a head no form
  holds to the SIMT body, so every head the SIMT body's plan takes is
  launched, none refused.  The launch is intercepted at the kernel lookup;
  nothing runs.
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
    return c if c == 8 else c + 8


@pytest.mark.parametrize("form,total,per_sm", [
    ((128, 256, 8), 179200, 1), ((128, 256, 16), 195584, 1), ((64, 128, 8), 101376, 2),
    ((64, 128, 16), 117760, 1), ((128, 128, 128), 156672, 1)])
def test_head_fwd_tc_plan(form, total, per_sm):
    ce, c1, kout = form
    plan = pf.head_fwd_tc_plan(8, 128 * 128, ce, ce, c1, kout)
    assert plan.form == form
    assert [n for n, _ in plan.smem] == ["e0", "e1", "h", "out", "ctx", "zc"]
    out = 8 * 64 * kout if kout <= 16 else 64 * _pitch(kout)
    want = [64 * _pitch(ce)] * 2 + [64 * _pitch(c1), out, 16 * _pitch(ce), 16 * _pitch(c1)]
    assert [m for _, m in plan.smem] == [-(-4 * n // 128) * 128 for n in want]
    assert plan.total == total <= SMEM_LIMIT
    assert plan.per_sm == per_sm and per_sm * (total + 1024) <= 233472
    assert (plan.tiles, plan.blocks) == (8 * 1024, per_sm * 132)
    assert pf.head_fwd_tc_plan(1, 40, ce, ce, c1, kout).blocks == 3
    # a narrow head's output product: C1 / 64 k8 steps a warp
    assert c1 % (8 * pf.HEAD_FWD_TC_WARPS) == 0


def test_head_fwd_tc_plan_refuses():
    for dims in ((129, 128, 128, 6), (128, 128, 257, 6), (128, 128, 256, 17)):
        with pytest.raises(ValueError):
            pf.head_fwd_tc_plan(1, 16, *dims)


def _case(b, s, hw, ce, c1, cout, seed):
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))

    e, ctx = f(b, s, hw, ce), f(b, hw, ce)
    ws = [f(2 * ce, c1, scale=(2 * ce) ** -0.5), f(c1, cout, scale=c1 ** -0.5)]
    return e, ctx, ws, [f(c1, scale=0.1), f(cout, scale=0.1)]


def _close(got, want, tol):
    got, want = torch.as_tensor(np.array(got)).double(), torch.as_tensor(np.array(want)).double()
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()


# (ce, c1, cout, acts, moments, cmajor, out_dtype, b, s, hw)
WALKS = {
    "kpcn_cmajor": (128, 256, 6, pf.HEAD_ACTS, True, True, torch.float32, 1, 5, 21),
    "kpcn": (128, 256, 6, pf.HEAD_ACTS, True, False, torch.float32, 1, 3, 17),
    "kpcn_cout12": (128, 256, 12, pf.HEAD_ACTS, True, True, torch.float32, 1, 3, 19),
    "pathnet64": (64, 128, 3, pf.HEAD_ACTS, True, False, torch.float32, 2, 3, 40),
    "pathnet64_bare": (64, 128, 3, pf.HEAD_ACTS, False, True, torch.float32, 1, 2, 24),
    "multisteps": (128, 128, 128, pf.LEAKY[:2], True, False, torch.float32, 1, 2, 17),
    "multisteps_bf16": (128, 128, 128, pf.LEAKY[:2], False, False, torch.bfloat16, 1, 4, 16),
    "padded": (48, 100, 5, pf.HEAD_ACTS, True, True, torch.float32, 1, 6, 30),
}


@pytest.mark.parametrize("name", list(WALKS))
def test_head_fwd_tc_walk(name):
    ce, c1, cout, acts, moments, cmajor, out_dtype, b, s, hw = WALKS[name]
    e, ctx, ws, bs = _case(b, s, hw, ce, c1, cout, 7)
    got = pf._head_fwd_tc_walk(e, ctx, ws, bs, acts, moments, cmajor, out_dtype)
    want = pf._head_plain(e, ctx, ws, bs, acts, moments, cmajor, out_dtype)
    got, want = (list(t) if moments else [t] for t in (got, want))
    assert got[0].dtype == out_dtype
    if out_dtype == torch.float32:
        for a, w in zip(got, want):
            _close(a, w, F32_FWD_TOL)
    else:   # one rounding to bf16 of values within F32_FWD_TOL: one bf16 step at most
        _close(got[0].float(), want[0].float(), 2.0 ** -7)
        unrounded = pf._head_fwd_tc_walk(e, ctx, ws, bs, acts, moments, cmajor)
        _close(unrounded, pf._head_plain(e, ctx, ws, bs, acts, moments, cmajor), F32_FWD_TOL)
    if out_dtype == torch.float32:
        # wcmc_tpu's head on the CPU (XLA, f32)
        ref = jpf._head_xla(jnp.asarray(e.numpy()), jnp.asarray(ctx.numpy()),
                            [jnp.asarray(w.numpy()) for w in ws],
                            [jnp.asarray(v.numpy()) for v in bs], acts, moments, jnp.float32,
                            cmajor)
        for a, w in zip(got, list(ref) if moments else [ref]):
            _close(a, w, F32_FWD_TOL)


def test_head_fwd_tc_walk_moments_are_the_outputs_sums():
    """The moments are the sample-order sums of the unrounded output, and
    the output with them is the output without them."""
    e, ctx, ws, bs = _case(1, 5, 20, 64, 128, 3, 8)
    out, ssum, ssq = pf._head_fwd_tc_walk(e, ctx, ws, bs, pf.HEAD_ACTS, True)
    assert torch.equal(pf._head_fwd_tc_walk(e, ctx, ws, bs, pf.HEAD_ACTS), out)
    want_sum, want_sq = torch.zeros_like(ssum), torch.zeros_like(ssq)
    for j in range(out.shape[1]):
        want_sum, want_sq = want_sum + out[:, j], want_sq + out[:, j] * out[:, j]
    assert torch.equal(ssum, want_sum) and torch.equal(ssq, want_sq)


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
def test_head_fwd_routes_f32_to_the_tensor_cores(launches, name):
    ce, c1, cout, acts, moments, cmajor, out_dtype, b, s, hw = WALKS[name]
    e, ctx, ws, bs = _case(b, s, hw, ce, c1, cout, 9)
    with pytest.raises(_Launch) as info:
        pf._head_fwd_kernel(e, ctx, ws, bs, acts, moments, cmajor, out_dtype)
    entry, args = info.value.args
    assert entry == "wcmc_pathnet_head_tf32"
    # e, ctx, wp, b1, b2, out, ssum, ssq; then B, S, HW, the form, Cout, the
    # activation codes, bf16 out, cmajor
    assert (args[6] is not None) == (args[7] is not None) == moments
    assert args[8:19] == (b, s, hw, *pf.head_tc_form(ce, ce, c1, cout), cout,
                          *(pf.ACTS.index(a) for a in acts), int(out_dtype == torch.bfloat16),
                          int(cmajor))
    with pytest.raises(_Launch) as info:
        pf._head_fwd_kernel(e, ctx, ws, bs, acts, moments, cmajor, out_dtype, body="simt")
    assert info.value.args[0] == "wcmc_pathnet_head_f32"
    with pytest.raises(ValueError, match="body"):
        pf._head_fwd_kernel(e, ctx, ws, bs, acts, moments, cmajor, out_dtype, body="wgmma")
    with pytest.raises(TypeError):
        pf._head_fwd_kernel(e, ctx, ws, bs, acts, moments, cmajor, torch.float16)


def test_head_fwd_and_bwd_share_one_pack(launches):
    """A train step's forward packs the head once, and its backward finds
    that pack; a changed parameter packs again."""
    e, ctx, ws, bs = _case(1, 2, 16, 64, 128, 3, 10)
    g = torch.zeros((1, 2, 16, 3))
    pf._packed.clear()
    with pytest.raises(_Launch):
        pf._head_fwd_kernel(e, ctx, ws, bs, pf.HEAD_ACTS, True, False, torch.float32)
    with pytest.raises(_Launch):
        pf._head_bwd_kernel(e, ctx, g, None, None, ws, bs, pf.HEAD_ACTS, False)
    assert (pf._packed.misses, pf._packed.hits) == (1, 1)
    ws[0].add_(1.0)
    with pytest.raises(_Launch):
        pf._head_fwd_kernel(e, ctx, ws, bs, pf.HEAD_ACTS, True, False, torch.float32)
    assert pf._packed.misses == 2


# Widths (Ce, Cc, C1, Cout) the SIMT body's plan takes: the entry points'
# heads with any --pnet_out_size, and a sweep of widths up to 256
WIDTHS = (1, 3, 8, 16, 17, 64, 100, 128, 129, 200, 256)
ENTRY_HEADS = [(128, 128, 256, 2 * o) for o in (3, 6, 8, 9, 12, 64, 128)] \
    + [(64, 64, 128, o) for o in (3, 6, 16, 17, 128, 200, 256)]


def _routed(ce, cc, c1, cout):
    """The entry point ``_head_fwd_kernel`` launches for an f32 head."""
    e = torch.zeros((1, 1, 1, ce))
    ctx = torch.zeros((1, 1, cc))
    ws, bs = [torch.zeros((ce + cc, c1)), torch.zeros((c1, cout))], [torch.zeros(c1),
                                                                       torch.zeros(cout)]
    with pytest.raises(_Launch) as info:
        pf._head_fwd_kernel(e, ctx, ws, bs, pf.HEAD_ACTS, True, True, torch.float32)
    return info.value.args[0]


@pytest.mark.parametrize("dims", ENTRY_HEADS)
def test_head_fwd_routes_entry_heads(launches, dims):
    """Every PathNet head an entry point builds runs: on the tensor-core
    body where a form holds it, else on the SIMT body."""
    want = ("wcmc_pathnet_head_tf32" if pf.head_tc_form(*dims) is not None
            else "wcmc_pathnet_head_f32")
    assert _routed(*dims) == want


@pytest.mark.parametrize("c1", WIDTHS)
def test_head_fwd_refuses_no_head_the_simt_plan_takes(launches, c1):
    """No f32 head the SIMT body's plan takes is refused: each is launched,
    on the tensor-core body exactly where a form holds it."""
    pf._packed.clear()
    for ce in WIDTHS:
        for cout in WIDTHS:
            cc = WIDTHS[(WIDTHS.index(ce) + WIDTHS.index(cout)) % len(WIDTHS)]
            try:
                pf.head_f32_plan(1, 1, ce, cc, c1, cout, moments=True)
            except ValueError:
                continue
            tc = pf.head_tc_form(ce, cc, c1, cout) is not None
            assert _routed(ce, cc, c1, cout) == ("wcmc_pathnet_head_tf32" if tc
                                                 else "wcmc_pathnet_head_f32")


def test_chip_smoke_checks_the_tensor_core_bodies():
    """``chip_smoke.py`` files the tensor-core f32 bodies of K4, K5 and
    K10-bwd by their own names (each forward's apart from its backward's),
    and an f32 path whose profile shows a SIMT body of theirs fails."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    names = {"void wcmc::pathnet_head_tf32_kernel<128, 256, 8>(wcmc::HeadFwdTc)":
             "pathnet_head_tf32",
             "void wcmc::pathnet_head_bwd_tf32_kernel<128, 256, 8>(wcmc::HeadTc)":
             "pathnet_head_bwd_tf32",
             "void wcmc::pathnet_embed_bwd_tf32_kernel<40, 128>(wcmc::EmbedTc)":
             "pathnet_embed_bwd_tf32",
             "void wcmc::pathnet_embed_tf32_kernel<40, 128>(wcmc::EmbedFwdTc)":
             "pathnet_embed_tf32",
             "void wcmc::mlp_fused_bwd_tf32_kernel<2, 2, 2>(wcmc::MlpBwdTcArgs)":
             "mlp_fused_bwd_tf32",
             "wcmc::pathnet_embed_f32_kernel(wcmc::EmbedF32)": "pathnet_embed_f32",
             "wcmc::mlp_fused_bwd_f32_kernel(wcmc::MlpF32)": "mlp_fused_bwd_f32",
             "wcmc::pathnet_embed_bwd_f32_kernel(wcmc::EmbedF32)": "pathnet_embed_bwd_f32",
             "wcmc::pathnet_head_f32_kernel(wcmc::HeadF32)": "pathnet_head_f32"}
    for name, kind in names.items():
        assert cs.device_kind(name) == kind
    counters = ("pathnet_embed", "pathnet_head", "pathnet_embed_bwd", "pathnet_head_bwd",
                "mlp_fused_bwd")
    kinds = {"pathnet_embed_tf32": 1.0, "pathnet_head_tf32": 1.0, "pathnet_embed_bwd_tf32": 2.0,
             "pathnet_head_bwd_tf32": 3.0, "mlp_fused_bwd_tf32": 0.5}
    cs.check_f32_bodies(kinds, "train_kpcn_f32", counters)
    for simt in ("pathnet_embed_f32", "pathnet_head_f32", "pathnet_embed_bwd_f32",
                 "mlp_fused_bwd_f32"):
        with pytest.raises(AssertionError):
            cs.check_f32_bodies(dict(kinds, **{simt: 0.5}), "train_kpcn_f32", counters)
    for tc in ("pathnet_embed_tf32", "pathnet_head_tf32", "pathnet_embed_bwd_tf32",
               "mlp_fused_bwd_tf32"):
        with pytest.raises(AssertionError):
            cs.check_f32_bodies({k: v for k, v in kinds.items() if k != tc}, "train_kpcn_f32",
                                counters)
