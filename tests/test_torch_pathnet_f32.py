"""What surrounds the f32 bodies of K4 and K5 (``csrc/pathnet_f32.cu``), on
the CPU (the kernels run only on the card: ``tests/test_torch_kernels_gpu.py``).

* ``embed_f32_plan`` and ``head_f32_plan``: the shared-memory carve (32-row
  f32 tiles in the kernels' order), the blocks resident an SM and the grid
  at the path shapes on 132 SMs, for every form an entry point reaches at
  f32 (KPCN's PathNet 36 -> 128^3 and its head [128 | 128] -> 256 -> 6, the
  64-wide PathNet 36 -> 64^3 and [64 | 64] -> 128 -> 3, Multisteps' 95 ->
  128^3 and [128 | 128] -> 128 -> 128), and their refusals.
* The routing of the four wrappers on card tensors by dtype: f32 to the f32
  body in any form (Multisteps' head backward with its f32 cotangent, and
  PathNet's embedding backward with d(x), which the bf16 bodies refuse; all
  four to their tensor-core bodies, the SIMT ones with ``body="simt"``),
  bf16 to the bf16 bodies as before, and a TypeError for any other dtype.
  Here the launch is intercepted at the kernel lookup (``_build.kernel``),
  which names the C entry point; nothing runs.
"""

import pytest
import torch

from wcmc_tpu_torch.ops import _build
from wcmc_tpu_torch.ops import pathnet_fused as pf
from wcmc_tpu_torch.ops.conv5 import SMEM_LIMIT


def _tile(c):
    return -(-4 * 32 * c // 128) * 128


EMBED_FORMS = {"kpcn": ((36, 128, 128, 128), pf.EMBED_ACTS, False),
               "pathnet64": ((36, 64, 64, 64), pf.EMBED_ACTS, False),
               "multisteps": ((95, 128, 128, 128), pf.LEAKY, True)}
HEAD_FORMS = {"kpcn": (128, 256, 6, pf.HEAD_ACTS, True),
              "pathnet64": (64, 128, 3, pf.HEAD_ACTS, True),
              "multisteps": (128, 128, 128, pf.LEAKY[:2], True),
              "multisteps_bare": (128, 128, 128, pf.LEAKY[:2], False)}


@pytest.mark.parametrize("form", list(EMBED_FORMS))
def test_embed_f32_plan(form):
    """x, h1, h2 and the fourth tile (the running sum forward, the cotangent
    backward), 32 f32 rows each; two blocks an SM; at 8 images of 128^2 px
    264 blocks on 132 SMs, and fewer where there are fewer tiles."""
    dims = EMBED_FORMS[form][0]
    plan = pf.embed_f32_plan(8, 128 * 128, *dims)
    assert [n for n, _ in plan.smem] == ["x", "h1", "h2", "out"]
    assert [m for _, m in plan.smem] == [_tile(c) for c in dims]
    assert plan.total == sum(_tile(c) for c in dims) <= SMEM_LIMIT
    assert (plan.rows, plan.per_sm, plan.blocks) == (32, 2, 264)
    c0, c1, c2, c3 = dims
    assert plan.parts == c0 * c1 + c1 * c2 + c2 * c3 + c1 + c2 + c3
    assert pf.embed_f32_plan(1, 100, *dims).blocks == 4
    assert pf.embed_f32_plan(2, 31, *dims, sms=1).blocks == 2


@pytest.mark.parametrize("form", list(HEAD_FORMS))
def test_head_f32_plan(form):
    """Forward: the context, ctx . W1c, e and h1 tiles, and with moments the
    running sum and sum of squares; backward: the same four, then G, the
    cotangent, gsum and gsq; 32 f32 rows each; a block's partial of dW1,
    dW2, db1 and db2."""
    ce, c1, cout, _, moments = HEAD_FORMS[form]
    fwd = pf.head_f32_plan(8, 128 * 128, ce, ce, c1, cout, moments)
    want = [_tile(ce), _tile(c1), _tile(ce), _tile(c1)] + [_tile(cout)] * (2 if moments else 0)
    assert [m for _, m in fwd.smem] == want and fwd.total == sum(want) <= SMEM_LIMIT
    bwd = pf.head_f32_plan(8, 128 * 128, ce, ce, c1, cout, bwd=True)
    want = [_tile(ce), _tile(c1), _tile(ce), _tile(c1), _tile(c1)] + [_tile(cout)] * 3
    assert [n for n, _ in bwd.smem] == ["ctx", "zc", "e", "h", "G", "g", "gsum", "gsq"]
    assert [m for _, m in bwd.smem] == want and bwd.total == sum(want) <= SMEM_LIMIT
    assert bwd.parts == 2 * ce * c1 + c1 * cout + c1 + cout
    for plan in (fwd, bwd):
        assert plan.per_sm == min(2, 233472 // (plan.total + 1024))
        assert plan.blocks == min(8 * 512, plan.per_sm * 132)


def test_f32_plans_refuse():
    """Widths outside 1-256, and a carve over a block's shared memory (a
    head 256 wide everywhere: eight 32 KB tiles backward)."""
    with pytest.raises(ValueError):
        pf.embed_f32_plan(1, 64, 36, 257, 128, 128)
    with pytest.raises(ValueError):
        pf.embed_f32_plan(1, 64, 0, 128, 128, 128)
    with pytest.raises(ValueError):
        pf.head_f32_plan(1, 64, 128, 128, 300, 6)
    assert pf.head_f32_plan(1, 64, 256, 256, 256, 256, moments=True).total <= SMEM_LIMIT
    with pytest.raises(ValueError):
        pf.head_f32_plan(1, 64, 256, 256, 256, 256, bwd=True)


class _Launch(Exception):
    """A launch intercepted at the kernel lookup; ``args[0]`` the entry point."""


@pytest.fixture
def launches(monkeypatch):
    """The wrappers as on a card, their tensors on the CPU: the kernel
    lookup raises ``_Launch`` with the entry point's name."""
    monkeypatch.setattr(pf, "_require_cuda", lambda name, *ts: torch.device("cpu"))

    def kernel(name, *argtypes):
        raise _Launch(name)

    monkeypatch.setattr(_build, "kernel", kernel)
    monkeypatch.setattr(_build, "sm_count", lambda idx: 132)
    monkeypatch.setattr(_build, "stream_of", lambda dev: 0)


def _entry(fn, *args, **kw):
    with pytest.raises(_Launch) as info:
        fn(*args, **kw)
    return info.value.args[0]


def _embed_inputs(dims, dtype, b=1, s=2, hw=40):
    g = torch.Generator().manual_seed(0)
    x = torch.randn((b, s, hw, dims[0]), generator=g).to(dtype)
    ws = [torch.randn((ci, co), generator=g) for ci, co in zip(dims[:-1], dims[1:])]
    bs = [torch.randn(co, generator=g) for co in dims[1:]]
    return x, ws, bs


@pytest.mark.parametrize("form", list(EMBED_FORMS))
def test_embed_routes_by_dtype(launches, form):
    dims, acts, compute_dx = EMBED_FORMS[form]
    x, ws, bs = _embed_inputs(dims, torch.float32)
    assert _entry(pf._embed_fwd_kernel, x, ws, bs, acts) == "wcmc_pathnet_embed_tf32"
    assert _entry(pf._embed_fwd_kernel, x, ws, bs, acts, body="simt") == "wcmc_pathnet_embed_f32"
    ge = torch.zeros((1, 2, 40, dims[-1]))
    for dx in (True, False):   # the f32 bodies take PathNet's chain with d(x) too
        assert _entry(pf._embed_bwd_kernel, x, ge, None, ws, bs, acts,
                      dx) == "wcmc_pathnet_embed_bwd_tf32"
        assert _entry(pf._embed_bwd_kernel, x, ge, None, ws, bs, acts, dx,
                      body="simt") == "wcmc_pathnet_embed_bwd_f32"
    xb = x.to(torch.bfloat16)
    assert _entry(pf._embed_fwd_kernel, xb, ws, bs, acts) == "wcmc_pathnet_embed_tiled"
    assert _entry(pf._embed_bwd_kernel, xb, ge, None, ws, bs, acts,
                  compute_dx) == "wcmc_pathnet_embed_bwd"
    if not compute_dx:
        with pytest.raises(ValueError):   # the bf16 PathNet form writes no d(x)
            pf._embed_bwd_kernel(xb, ge, None, ws, bs, acts, True)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            pf._embed_fwd_kernel(x.to(dtype), ws, bs, acts)
        with pytest.raises(TypeError):
            pf._embed_bwd_kernel(x.to(dtype), ge, None, ws, bs, acts, compute_dx)


@pytest.mark.parametrize("form", list(HEAD_FORMS))
def test_head_routes_by_dtype(launches, form):
    ce, c1, cout, acts, moments = HEAD_FORMS[form]
    g = torch.Generator().manual_seed(1)
    e = torch.randn((1, 2, 40, ce), generator=g)
    ctx = torch.randn((1, 40, ce), generator=g)
    ws = [torch.randn((2 * ce, c1), generator=g), torch.randn((c1, cout), generator=g)]
    bs = [torch.randn(c1, generator=g), torch.randn(cout, generator=g)]
    gout = torch.randn((1, 2, 40, cout), generator=g)   # f32, as the f32 paths pass it
    for out_dtype in (torch.float32, torch.bfloat16):
        assert _entry(pf._head_fwd_kernel, e, ctx, ws, bs, acts, moments, False,
                      out_dtype) == "wcmc_pathnet_head_tf32"
        assert _entry(pf._head_fwd_kernel, e, ctx, ws, bs, acts, moments, False,
                      out_dtype, body="simt") == "wcmc_pathnet_head_f32"
    with pytest.raises(TypeError):
        pf._head_fwd_kernel(e, ctx, ws, bs, acts, moments, False, torch.float16)
    gsum = torch.zeros((1, 40, cout)) if moments else None
    assert _entry(pf._head_bwd_kernel, e, ctx, gout, gsum, gsum, ws, bs, acts,
                  False) == "wcmc_pathnet_head_bwd_tf32"
    assert _entry(pf._head_bwd_kernel, e, ctx, gout, gsum, gsum, ws, bs, acts, False,
                  body="simt") == "wcmc_pathnet_head_bwd_f32"
    eb = e.to(torch.bfloat16)
    if acts == pf.LEAKY[:2]:
        # the bf16 Multisteps form reads a bf16 cotangent and refuses an f32 one
        with pytest.raises(ValueError):
            pf._head_bwd_kernel(eb, ctx, gout, gsum, gsum, ws, bs, acts, False)
        assert _entry(pf._head_bwd_kernel, eb, ctx, gout.to(torch.bfloat16), gsum, gsum, ws,
                      bs, acts, False) == "wcmc_pathnet_head_bwd"
    else:
        assert _entry(pf._head_bwd_kernel, eb, ctx, gout, gsum, gsum, ws, bs, acts,
                      False) == "wcmc_pathnet_head_bwd"
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            pf._head_fwd_kernel(e.to(dtype), ctx, ws, bs, acts, moments, False, torch.float32)
        with pytest.raises(TypeError):
            pf._head_bwd_kernel(e.to(dtype), ctx, gout, gsum, gsum, ws, bs, acts, False)


def test_f32_wrappers_check_shapes(launches):
    """A weight that does not chain, or a cotangent of the wrong shape, is a
    ValueError before any launch."""
    x, ws, bs = _embed_inputs((36, 64, 64, 64), torch.float32)
    with pytest.raises(ValueError):
        pf._embed_fwd_kernel(x, [ws[0], ws[2].t()[:32], ws[2]], bs, pf.EMBED_ACTS)
    with pytest.raises(ValueError):
        pf._embed_bwd_kernel(x, torch.zeros((1, 2, 40, 63)), None, ws, bs, pf.EMBED_ACTS, False)
    e, ctx = torch.zeros((1, 2, 40, 64)), torch.zeros((1, 40, 64))
    hws, hbs = [torch.zeros((128, 128)), torch.zeros((128, 3))], [torch.zeros(128),
                                                                  torch.zeros(3)]
    with pytest.raises(ValueError):
        pf._head_bwd_kernel(e, ctx, torch.zeros((1, 2, 3, 40)), None, None, hws, hbs,
                            pf.HEAD_ACTS, False)
