"""Each hand-written CUDA kernel against its plain PyTorch version, on the
card (marked ``gpu``; skips without one), and one train step on the card
against the same step on the CPU.  Runs without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py

Tolerances (of max |plain|): K1, K3 and K2 with f32 logits 1e-5 — the
same f32 math, only the summation order differs; K2 with bf16 logits
1e-2 — one rounding of an f32 value to bf16, which another summation
order can move by one bf16 step (2^-8 relative); K4/K5 forward and
backward 2e-2 — bf16 hidden layers and cotangents summed in another
order can round to a neighbouring bf16 value.  K5-bwd's per-row outputs
(d e, d ctx) are held in relative L2 norm, 1e-2: each recomputes the
hidden layer, and where a pre-activation lies within rounding of zero the
two versions can disagree on its relu, which moves that element's
gradient by its full size (a few such rows in 10^6 reach 9% of max |d e|
at the training shape).  K10 (the fused per-pixel MLP) forward and its
weight gradients 2e-2, for the same reason as K4/K5; its d(x) in relative
L2, 1e-2, for the same reason as K5-bwd's per-row outputs (at 1,048,576
rows a few elements whose leaky relu takes the other slope reach 12% of
max |d x|).  K8 (the splat's weight gradient) and K9 (the weighted
gather) with f32 weights 1e-5, the same f32 products summed in another
order; K9 with bf16 weights 1e-5 too (the weights are read exactly, the
math is f32).  The SBMC forms of K4-bwd and K5-bwd: weight and bias
gradients 2e-2 of max, per-row outputs (d x, d e, d ctx) 1e-2 in
relative L2, for the reasons above (leaky relu takes the other slope
where a recomputed pre-activation lies within rounding of zero).  K2's
tiled body equals its first body bit for bit (the same sums in the same
order); K3's banded body is held within 1e-5 of max of its gather body
(the same f32 probabilities, d buf summed in another order).  TF32 is off
for every f32 product compared here."""

import pytest
import torch

from wcmc_tpu_torch.ops import _build
from wcmc_tpu_torch.ops import kernel_apply as ka
from wcmc_tpu_torch.ops import mlp_fused as mf
from wcmc_tpu_torch.ops import pathnet_fused as pf

pytestmark = pytest.mark.gpu

K1_TOL, K2_BF16_TOL, BF16_TOL = 1e-5, 1e-2, 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, tol):
    got, want = got.double(), want.double()
    assert got.shape == want.shape
    err = (got - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), err


def _close_l2(got, want, tol):
    got, want = got.double(), want.double()
    assert got.shape == want.shape
    err = ((got - want).norm() / want.norm()).item()
    assert err <= tol, err


def _gen(seed=0):
    return torch.Generator(device="cuda").manual_seed(seed)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,ksize", [(2, 11, 13, 5), (3, 40, 300, 21), (2, 72, 72, 21)])
def test_gather_softmax(cuda, b, h, w, ksize, dtype):
    g = _gen()
    buf = torch.randn((b, h + ksize - 1, w + ksize - 1, 3), device=cuda, generator=g)
    # a strided crop of a channels-last conv output, as on the KPCN path
    full = 2 * torch.randn((b, ksize * ksize, h + 4, w + 6), device=cuda, generator=g)
    full = full.to(dtype).contiguous(memory_format=torch.channels_last)
    logits = full.permute(0, 2, 3, 1)[:, 2:2 + h, 3:3 + w]
    _build.reset_counts()
    got = ka.kernel_gather_softmax(buf, logits, ksize)
    assert _build.launches["gather_softmax"] == 1 and not _build.plain_calls
    _close(got, ka.gather_softmax_plain(buf, logits, ksize), K1_TOL)


@pytest.mark.parametrize("b,s,hw", [(2, 3, 100), (8, 8, 16384)])
def test_pathnet_embed(cuda, b, s, hw):
    g = _gen(1)
    dims = (36, 128, 128, 128)
    x = torch.randn((b, s, hw, dims[0]), device=cuda, generator=g).to(torch.bfloat16)
    ws = [torch.randn((ci, co), device=cuda, generator=g) / ci**0.5
          for ci, co in zip(dims[:-1], dims[1:])]
    bs = [0.1 * torch.randn(co, device=cuda, generator=g) for co in dims[1:]]
    _build.reset_counts()
    e, mean = pf.pathnet_embed(x, ws, bs)
    assert _build.launches["pathnet_embed"] == 1 and not _build.plain_calls
    we, wm = pf._embed_plain(x, ws, bs, pf.EMBED_ACTS)
    assert e.dtype == torch.bfloat16 and mean.dtype == torch.float32
    _close(e, we, BF16_TOL)
    _close(mean, wm, BF16_TOL)


@pytest.mark.parametrize("cmajor", [False, True])
@pytest.mark.parametrize("b,s,hw", [(2, 3, 100), (8, 8, 16384)])
def test_pathnet_head(cuda, b, s, hw, cmajor):
    g = _gen(2)
    ce = cc = 128
    e = torch.randn((b, s, hw, ce), device=cuda, generator=g).to(torch.bfloat16)
    ctx = torch.randn((b, hw, cc), device=cuda, generator=g)
    ws = [torch.randn((ce + cc, 256), device=cuda, generator=g) / 16.0,
          torch.randn((256, 6), device=cuda, generator=g) / 16.0]
    bs = [0.1 * torch.randn(256, device=cuda, generator=g),
          0.1 * torch.randn(6, device=cuda, generator=g)]
    _build.reset_counts()
    got = pf.pathnet_head(e, ctx, ws, bs, pf.HEAD_ACTS, True, cmajor)
    assert _build.launches["pathnet_head"] == 1 and not _build.plain_calls
    want = pf._head_plain(e, ctx, ws, bs, pf.HEAD_ACTS, True, cmajor)
    for gt, wt in zip(got, want):
        _close(gt, wt, BF16_TOL)
    no_moments = pf.pathnet_head(e, ctx, ws, bs, pf.HEAD_ACTS, False, cmajor)
    torch.testing.assert_close(no_moments, got[0], rtol=0, atol=0)


def test_kernels_refuse_what_they_do_not_compute(cuda):
    x = torch.zeros((1, 1, 16, 36), device=cuda)          # f32: not computed
    ws = [torch.zeros((36, 16), device=cuda), torch.zeros((16, 16), device=cuda),
          torch.zeros((16, 16), device=cuda)]
    bs = [torch.zeros(16, device=cuda)] * 3
    with pytest.raises(TypeError):
        pf.pathnet_embed(x, ws, bs)
    with pytest.raises(ValueError):
        pf.pathnet_embed(x.to(torch.bfloat16), ws, bs, ("relu", "gelu", "relu"))
    # K5-fwd: f32 e, an unknown activation, Cout 17, an f16 output
    e = torch.zeros((1, 1, 16, 64), device=cuda)
    ctx = torch.zeros((1, 16, 64), device=cuda)
    hws = [torch.zeros((128, 128), device=cuda), torch.zeros((128, 3), device=cuda)]
    hbs = [torch.zeros(128, device=cuda), torch.zeros(3, device=cuda)]
    with pytest.raises(TypeError):
        pf.pathnet_head(e, ctx, hws, hbs)
    eb = e.to(torch.bfloat16)
    with pytest.raises(ValueError):
        pf.pathnet_head(eb, ctx, hws, hbs, ("relu", "gelu"))
    with pytest.raises(ValueError):
        pf.pathnet_head(eb, ctx, [hws[0], torch.zeros((128, 17), device=cuda)],
                        [hbs[0], torch.zeros(17, device=cuda)])
    with pytest.raises(TypeError):
        pf.pathnet_head(eb, ctx, hws, hbs, out_dtype=torch.float16)


def _crop_logits(cuda, g, b, h, w, ksize, dtype):
    full = 2 * torch.randn((b, ksize * ksize, h + 4, w + 6), device=cuda, generator=g)
    full = full.to(dtype).contiguous(memory_format=torch.channels_last).requires_grad_()
    return full.permute(0, 2, 3, 1)[:, 2:2 + h, 3:3 + w]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,ksize", [(2, 11, 13, 5), (8, 72, 72, 21)])
def test_gather_softmax_backward(cuda, b, h, w, ksize, dtype):
    """K2 (d logits) and K3 (d buf) through autograd, as the train step
    and a buffer that requires grad reach them."""
    g = _gen(3)
    buf = torch.rand((b, h + ksize - 1, w + ksize - 1, 3), device=cuda, generator=g)
    logits = _crop_logits(cuda, g, b, h, w, ksize, dtype)
    buf.requires_grad_()
    cot = torch.randn((b, h, w, 3), device=cuda, generator=g)
    out = ka.kernel_gather_softmax(buf, logits, ksize)
    _build.reset_counts()
    dbuf, dlogits = torch.autograd.grad(out, [buf, logits], cot)
    assert dict(_build.launches) == {"outer_softmax": 1, "scatter_softmax": 1}
    assert not _build.plain_calls
    assert dlogits.dtype == dtype and dbuf.dtype == torch.float32
    _close(dlogits, ka.outer_softmax_plain(cot, buf.detach(), logits.detach(), ksize),
           K1_TOL if dtype == torch.float32 else K2_BF16_TOL)
    _close(dbuf, ka.scatter_softmax_plain(cot, logits.detach(), ksize), K1_TOL)
    # data buffers (the KPCN case): only K2 runs
    out = ka.kernel_gather_softmax(buf.detach(), logits, ksize)
    _build.reset_counts()
    torch.autograd.grad(out, logits, cot)
    assert dict(_build.launches) == {"outer_softmax": 1}


def _embed_case(cuda, b, s, hw, seed, dims=(36, 128, 128, 128)):
    g = _gen(seed)
    x = torch.randn((b, s, hw, dims[0]), device=cuda, generator=g).to(torch.bfloat16)
    ws = [torch.randn((ci, co), device=cuda, generator=g) / ci**0.5
          for ci, co in zip(dims[:-1], dims[1:])]
    bs = [0.1 * torch.randn(co, device=cuda, generator=g) for co in dims[1:]]
    ge = torch.randn((b, s, hw, dims[-1]), device=cuda, generator=g).to(torch.bfloat16)
    gmean = torch.randn((b, hw, dims[-1]), device=cuda, generator=g)
    return x, ws, bs, ge, gmean


# K4-bwd's shapes beside the paths': its 32-pixel tile at HW P - 1, P and
# P + 1; S = 1 and 2; fewer tiles (2 to 6) than the card's 132 blocks and
# many more, not a whole number per block; x spans that start on 16 bytes
# (HW 64) and spans that do not (HW 37, 100, 4099: a sample's span of
# pixels starts on 16 bytes only where its first row index is a multiple
# of 8 for 95 channels, of 2 for 36)
EMBED_BWD_SHAPES = [(2, 3, 100), (8, 8, 16384), (2, 1, 31), (1, 2, 32), (3, 5, 33),
                    (2, 2, 64), (5, 2, 4099)]


# PathNet's chain 128 wide (KPCN's branches merged) and 64 wide (LBMC's and
# SBMC's PathNet, zero-padded to 128), both on the tiled body
@pytest.mark.parametrize("dims", [(36, 128, 128, 128), (36, 64, 64, 64)])
@pytest.mark.parametrize("b,s,hw", [(1, 11, 40)] + EMBED_BWD_SHAPES)
def test_pathnet_embed_backward(cuda, b, s, hw, dims):
    x, ws, bs, ge, gmean = _embed_case(cuda, b, s, hw, 4, dims)
    _build.reset_counts()
    _, dws, dbs = pf.pathnet_embed_bwd(x, ge, gmean, ws, bs)
    assert _build.launches["pathnet_embed_bwd"] == 1 and not _build.plain_calls
    _, wdws, wdbs = pf._embed_bwd_plain(x, ge, gmean, ws, bs, pf.EMBED_ACTS)
    for got, want in zip(dws + dbs, wdws + wdbs):
        assert got.dtype == torch.float32
        _close(got, want, BF16_TOL)
    # a second launch repeats bit for bit (partials summed in block order)
    _, dws2, dbs2 = pf.pathnet_embed_bwd(x, ge, gmean, ws, bs)
    for got, want in zip(dws2 + dbs2, dws + dbs):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    # either cotangent absent (autograd passes None for an unused output)
    for cots in ((None, gmean), (ge, None)):
        _, gws, gbs = pf.pathnet_embed_bwd(x, *cots, ws, bs)
        _, pws, pbs = pf._embed_bwd_plain(x, *cots, ws, bs, pf.EMBED_ACTS)
        for got, want in zip(gws + gbs, pws + pbs):
            _close(got, want, BF16_TOL)
    # through autograd: weights that require grad launch K4-bwd
    params = [w.clone().requires_grad_() for w in ws + bs]
    e, mean = pf.pathnet_embed(x, params[:3], params[3:])
    _build.reset_counts()
    grads = torch.autograd.grad([e, mean], params, [ge, gmean])
    assert _build.launches["pathnet_embed_bwd"] == 1
    for got, want in zip(grads, dws + dbs):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def _head_case(cuda, b, s, hw, seed, dims=(128, 128, 256, 6)):
    g = _gen(seed)
    ce, cc, c1, cout = dims
    e = torch.randn((b, s, hw, ce), device=cuda, generator=g).to(torch.bfloat16)
    ctx = torch.randn((b, hw, cc), device=cuda, generator=g).to(torch.bfloat16)
    ws = [torch.randn((ce + cc, c1), device=cuda, generator=g) / (ce + cc) ** 0.5,
          torch.randn((c1, cout), device=cuda, generator=g) / c1 ** 0.5]
    bs = [0.1 * torch.randn(c1, device=cuda, generator=g),
          0.1 * torch.randn(cout, device=cuda, generator=g)]
    cot = [torch.randn((b, s, cout, hw), device=cuda, generator=g),
           torch.randn((b, hw, cout), device=cuda, generator=g),
           0.1 * torch.randn((b, hw, cout), device=cuda, generator=g)]
    return e, ctx, ws, bs, cot


# PathNet's head: KPCN's ([128 | 128] -> 256 -> 6, both branches merged)
# and LBMC's and SBMC's ([64 | 64] -> 128 -> 3, zero-padded to 128) on the
# tiled body, and one wider than it takes (the wmma body); shapes beside the
# paths': the 16-pixel tile at HW P - 1, P, P + 1 and ragged (channel-major
# rows off 16 bytes), S = 1, odd S, fewer tiles than blocks and many more
HEAD_BWD_DIMS = [(128, 128, 256, 6), (64, 64, 128, 3), (144, 128, 256, 6)]


@pytest.mark.parametrize("dims", HEAD_BWD_DIMS)
@pytest.mark.parametrize("b,s,hw", [(2, 3, 100), (1, 11, 40), (8, 8, 16384), (2, 1, 15),
                                    (1, 2, 16), (3, 5, 17), (5, 2, 4099)])
def test_pathnet_head_backward(cuda, b, s, hw, dims):
    e, ctx, ws, bs, (g, gsum, gsq) = _head_case(cuda, b, s, hw, 5, dims)
    assert pf.head_bwd_plan(pf.HEAD_ACTS, *dims[:3]).tiled == (dims[0] <= 128)
    _build.reset_counts()
    got = pf.pathnet_head_bwd(e, ctx, g, gsum, gsq, ws, bs, cmajor=True)
    assert _build.launches["pathnet_head_bwd"] == 1 and not _build.plain_calls
    want = pf._head_bwd_plain(e, ctx, g, gsum, gsq, ws, bs, pf.HEAD_ACTS, cmajor=True)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    assert got[0].shape == e.shape and got[1].shape == ctx.shape
    _close_l2(got[0], want[0], 1e-2)
    _close_l2(got[1], want[1], 1e-2)
    for gt, wt in zip([*got[2], *got[3]], [*want[2], *want[3]]):
        assert gt.shape == wt.shape
        _close(gt, wt, BF16_TOL)
    # the channels-last cotangent gives the same gradients
    flat = pf.pathnet_head_bwd(e, ctx, g.transpose(2, 3).contiguous(), gsum, gsq, ws, bs)
    for gt, wt in zip(flat[2] + flat[3], got[2] + got[3]):
        torch.testing.assert_close(gt, wt, rtol=0, atol=0)
    # a second launch repeats bit for bit (partials summed in block order)
    again = pf.pathnet_head_bwd(e, ctx, g, gsum, gsq, ws, bs, cmajor=True)
    for gt, wt in zip([again[0], again[1], *again[2], *again[3]],
                      [got[0], got[1], *got[2], *got[3]]):
        torch.testing.assert_close(gt, wt, rtol=0, atol=0)
    # each cotangent absent (autograd passes None for an unused output)
    for none in range(3):
        cots = [None if i == none else t for i, t in enumerate((g, gsum, gsq))]
        part = pf.pathnet_head_bwd(e, ctx, *cots, ws, bs, cmajor=True)
        ref = pf._head_bwd_plain(e, ctx, *cots, ws, bs, pf.HEAD_ACTS, cmajor=True)
        _close_l2(part[0], ref[0], 1e-2)
        _close_l2(part[1], ref[1], 1e-2)
        for gt, wt in zip([*part[2], *part[3]], [*ref[2], *ref[3]]):
            _close(gt, wt, BF16_TOL)


def test_train_batch_on_the_card_matches_the_cpu(cuda):
    """One bf16 KPCN + manifold train step on the card (every kernel)
    against the same fresh weights, batch (2 patches of 128 px, 8 spp)
    and draws on the CPU (every plain version): bf16 convolutions in
    cuDNN and on the CPU round differently, and a rounding can take a
    value to the other side of a relu.  Measured on an H100: losses within
    8.7e-6 relative, each model's flattened gradient within cosine
    0.99716 and norm ratio 1 +- 0.0175; held to about 2.5x: 2.5e-5,
    0.993 and 0.045."""
    import numpy as np

    from wcmc_tpu_torch import convert
    from wcmc_tpu_torch.data.batches import synthetic_batch
    from wcmc_tpu_torch.train.factory import TrainConfig, init_interfaces

    cfg = TrainConfig(kpcn_ksize=21, use_llpm_buf=True, manif_learn=True, manif_loss="FMSE")
    card = init_interfaces(cfg, device=cuda)[0]
    cpu = init_interfaces(cfg, device="cpu")[0]
    for name, m in card.models.items():
        convert.load_flax_params(cpu.models[name], convert.to_flax(m))
    batch = synthetic_batch(np.random.default_rng(0), "kpcn", 2, 128, 8, True)
    card.to_train_mode()
    cpu.to_train_mode()
    card.preprocess(batch)
    cpu.preprocess(batch)
    draws = card.draw_pairings((2, 8, 3, 72, 72))
    _build.reset_counts()
    ld_card = card.train_batch(batch, grad_hook_mode=True, draws=draws)
    launched = dict(_build.launches)
    assert not _build.plain_calls
    for name in ("gather_softmax", "outer_softmax", "pathnet_embed", "pathnet_embed_bwd",
                 "pathnet_head", "pathnet_head_bwd"):
        assert launched.get(name, 0) >= 1, (name, launched)
    ld_cpu = cpu.train_batch(batch, grad_hook_mode=True, draws=draws)
    measured = {k: abs(float(ld_card[k]) - float(v)) / abs(float(v)) for k, v in ld_cpu.items()}
    for name, m in card.models.items():
        a = torch.cat([p.grad.flatten().double().cpu() for p in m.parameters()])
        b = torch.cat([p.grad.flatten().double() for p in cpu.models[name].parameters()])
        measured[name] = (float(a @ b / (a.norm() * b.norm())), float(a.norm() / b.norm()))
    print(measured)
    for k in ld_cpu:
        assert measured[k] <= 2.5e-5, (k, measured)
    for name in card.models:
        cos, ratio = measured[name]
        assert cos >= 0.993 and abs(ratio - 1) <= 0.045, (name, measured)


# ---------------------------------------------------------------------------
# LBMC shapes: K10, K1/K2/K3 at K = 13, K4/K5 at the single PathNet's widths
# ---------------------------------------------------------------------------

LEAKY3 = ("leaky_relu",) * 3


def _mlp_case(cuda, n, c0, seed, widths=(32, 32, 32)):
    g = _gen(seed)
    dims = (c0,) + widths
    x = torch.randn((n, c0), device=cuda, generator=g).to(torch.bfloat16)
    ws = [torch.randn((ci, co), device=cuda, generator=g) / ci**0.5
          for ci, co in zip(dims[:-1], dims[1:])]
    bs = [0.1 * torch.randn(co, device=cuda, generator=g) for co in dims[1:]]
    cot = torch.randn((n, dims[-1]), device=cuda, generator=g)
    return x, ws, bs, cot


@pytest.mark.parametrize("acts", [LEAKY3, ("relu", "leaky_relu", "linear")])
@pytest.mark.parametrize("n,c0", [(1000, 27), (1000, 32), (8 * 8 * 128 * 128, 32), (77, 40)])
def test_mlp_fused(cuda, n, c0, acts):
    x, ws, bs, _ = _mlp_case(cuda, n, c0, 10)
    _build.reset_counts()
    y = mf._mlp_fwd_kernel(x, ws, bs, acts)
    assert dict(_build.launches) == {"mlp_fused": 1} and not _build.plain_calls
    assert y.dtype == torch.bfloat16
    _close(y, mf._mlp_fwd_plain(x, ws, bs, acts), BF16_TOL)


@pytest.mark.parametrize("compute_dx", [True, False])
@pytest.mark.parametrize("n,c0", [(1000, 27), (1000, 32), (8 * 8 * 128 * 128, 32), (77, 40)])
def test_mlp_fused_backward(cuda, n, c0, compute_dx):
    x, ws, bs, cot = _mlp_case(cuda, n, c0, 11)
    _build.reset_counts()
    dx, dws, dbs = mf.mlp_fused_bwd(x, cot, ws, bs, LEAKY3, compute_dx)
    assert dict(_build.launches) == {"mlp_fused_bwd": 1} and not _build.plain_calls
    pdx, pdws, pdbs = mf._mlp_bwd_plain(x, cot, ws, bs, LEAKY3, compute_dx)
    if compute_dx:
        assert dx.dtype == torch.bfloat16
        _close_l2(dx, pdx, 1e-2)
    else:
        assert dx is None
    for got, want in zip(dws + dbs, pdws + pdbs):
        assert got.dtype == torch.float32 and got.shape == want.shape
        _close(got, want, BF16_TOL)
    # through autograd, as PixelMLP reaches it: K10-fwd and K10-bwd
    params = [t.clone().requires_grad_() for t in ws + bs]
    xg = x.clone().requires_grad_()
    _build.reset_counts()
    out = mf.fused_mlp(xg, params[:3], params[3:], LEAKY3, compute_dx)
    grads = torch.autograd.grad(out, [xg] + params, cot.to(torch.bfloat16))
    assert dict(_build.launches) == {"mlp_fused": 1, "mlp_fused_bwd": 1}
    for got, want in zip(grads[1:], dws + dbs):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    if not compute_dx:
        assert not grads[0].any()


def test_mlp_fused_refuses_what_it_does_not_compute(cuda):
    x, ws, bs, _ = _mlp_case(cuda, 64, 32, 12)
    with pytest.raises(TypeError):
        mf.fused_mlp(x.float(), ws, bs, LEAKY3)
    with pytest.raises(ValueError):
        mf.fused_mlp(x, ws, bs, ("relu", "gelu", "relu"))
    wide = [torch.zeros((32, 80), device=cuda), torch.zeros((80, 32), device=cuda)]
    with pytest.raises(ValueError):
        mf.fused_mlp(x, wide, [torch.zeros(80, device=cuda), torch.zeros(32, device=cuda)],
                     LEAKY3[:2])
    five = [torch.zeros((32, 32), device=cuda)] * 5
    with pytest.raises(ValueError):
        mf.fused_mlp(x, five, [torch.zeros(32, device=cuda)] * 5, ("linear",) * 5)
    with pytest.raises(ValueError):
        mf.fused_mlp(x, [w.cpu() for w in ws], bs, LEAKY3)


def _bwd_outputs(res):
    dx, dws, dbs = res
    return ([] if dx is None else [dx]) + list(dws) + list(dbs)


def _check_bwd_tiled(x, cot, ws, bs, acts, compute_dx):
    """K10-bwd's tiled body against its wmma body on the same inputs (d(x)
    bit for bit, dW and db within K1_TOL: the same products, rows summed in
    another order), against the plain version (as in
    ``test_mlp_fused_backward``) and against itself over two launches."""
    _build.reset_counts()
    got = mf.mlp_fused_bwd(x, cot, ws, bs, acts, compute_dx)
    assert dict(_build.launches) == {"mlp_fused_bwd": 1} and not _build.plain_calls
    ref = mf.mlp_fused_bwd(x, cot, ws, bs, acts, compute_dx, body="wmma")
    if compute_dx:
        assert torch.equal(got[0], ref[0]), (got[0].float() - ref[0].float()).abs().max().item()
        _close_l2(got[0], mf._mlp_bwd_plain(x, cot, ws, bs, acts, True)[0], 1e-2)
    else:
        assert got[0] is None
    for a, b in zip(got[1] + got[2], ref[1] + ref[2]):
        _close(a, b, K1_TOL)
    _, pdws, pdbs = mf._mlp_bwd_plain(x, cot, ws, bs, acts, compute_dx)
    for a, b in zip(got[1] + got[2], pdws + pdbs):
        _close(a, b, BF16_TOL)
    again = mf.mlp_fused_bwd(x, cot, ws, bs, acts, compute_dx)
    assert all(torch.equal(a, b) for a, b in zip(_bwd_outputs(got), _bwd_outputs(again)))
    return got


@pytest.mark.parametrize("compute_dx", [True, False])
@pytest.mark.parametrize("acts", [LEAKY3, ("relu", "leaky_relu", "linear")])
@pytest.mark.parametrize("n,c0", [(1000, 27), (3 * 64 + 37, 32), (8 * 8 * 128 * 128, 32),
                                  (1000, 5), (64 * 8 * 132 + 1, 27)])
def test_mlp_fused_bwd_tiled(cuda, n, c0, acts, compute_dx):
    """K10-bwd's tiled body (LayerNet's chain, 32 wide; C0 27 without the
    PathNet, 32 with it): at ragged row counts, at the LBMC shape, at a
    narrow C0 and where the slabs outnumber the warps of a full grid."""
    assert mf.mlp_bwd_plan(c0, (32, 32, 32), acts).body == "tiled"
    x, ws, bs, cot = _mlp_case(cuda, n, c0, 15)
    _check_bwd_tiled(x, cot.to(torch.bfloat16), ws, bs, acts, compute_dx)


def test_mlp_fused_bwd_tiled_unaligned_inputs(cuda):
    """x and a bf16 cotangent that do not start on 16 bytes land by 2-byte
    loads, with the bits of aligned copies."""
    for c0 in (27, 32):
        n = 5 * 64 + 11
        x, ws, bs, cot = _mlp_case(cuda, n, c0, 17)
        xs = torch.empty(n * c0 + 1, dtype=torch.bfloat16, device=cuda)[1:].view(n, c0)
        gs = torch.empty(n * 32 + 3, dtype=torch.bfloat16, device=cuda)[3:].view(n, 32)
        xs.copy_(x)
        gs.copy_(cot)
        assert xs.is_contiguous() and xs.data_ptr() % 16 and gs.data_ptr() % 16
        got = _check_bwd_tiled(xs, gs, ws, bs, LEAKY3, True)
        want = mf.mlp_fused_bwd(x, gs.clone(), ws, bs, LEAKY3, True)
        assert all(torch.equal(a, b) for a, b in zip(_bwd_outputs(got), _bwd_outputs(want)))


@pytest.mark.parametrize("c0,widths", [(32, (32, 32, 32)), (27, (32, 32, 32)), (1, (32, 32, 32)),
                                       (40, (32, 32, 32)), (36, (64, 64, 64)), (32, (16,)),
                                       (64, (64, 48, 32, 16))])
def test_mlp_bwd_plan_is_the_kernels_shared_memory(cuda, c0, widths):
    """``mlp_bwd_plan``'s total is the dynamic shared memory K10-bwd's body
    gives a block of the form (the tiled kernel also checks its own carve
    against it at every launch)."""
    import ctypes

    fn = _build.library().wcmc_mlp_fused_bwd_smem
    fn.argtypes, fn.restype = [ctypes.c_int] * 7, ctypes.c_longlong
    plan = mf.mlp_bwd_plan(c0, widths, ("linear",) * len(widths))
    padded = list(widths) + [0] * (4 - len(widths))
    assert fn(c0, len(widths), *padded, int(plan.body == "tiled")) == plan.total


def test_mlp_fused_forward_keeps_its_body(cuda):
    """K10-fwd still runs its first body, and K10-bwd at LayerNet's chain
    its tiled one: the profiled device entries of a forward and backward
    through autograd are ``mlp_fused`` and ``mlp_fused_bwd_tiled`` (with
    the partials' sum), none of the wmma backward's."""
    import importlib.util
    import pathlib

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    x, ws, bs, cot = _mlp_case(cuda, 3000, 32, 18)
    params = [t.clone().requires_grad_() for t in ws + bs]
    xg = x.clone().requires_grad_()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = mf.fused_mlp(xg, params[:3], params[3:], LEAKY3)
        torch.autograd.grad(out, [xg] + params, cot.to(torch.bfloat16))
        torch.cuda.synchronize()
    kinds = {cs.device_kind(e.name) for e in prof.events() if e.device_type == DeviceType.CUDA}
    assert {"mlp_fused", "mlp_fused_bwd_tiled", "reduce_parts"} <= kinds
    assert "mlp_fused_bwd" not in kinds


def _kernel_head_logits(cuda, g, b, h, w, ksize, dtype, layer):
    """One layer's logits as the LayerNet takes them: a strided slice of a
    channels-last (B, 2 K*K, h, w) 1x1-conv output."""
    full = 2 * torch.randn((b, 2 * ksize * ksize, h, w), device=cuda, generator=g)
    full = full.to(dtype).contiguous(memory_format=torch.channels_last).requires_grad_()
    k2 = ksize * ksize
    return full, full.permute(0, 2, 3, 1)[..., layer * k2:(layer + 1) * k2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w", [(2, 20, 24), (8, 128, 128)])
def test_gather_softmax_k13_strided(cuda, b, h, w, dtype):
    """K1 forward, K2 and K3 backward at the LBMC kernel size on the second
    layer's slice of the kernel head, with a buffer that requires grad."""
    k = 13
    g = _gen(13)
    full, logits = _kernel_head_logits(cuda, g, b, h, w, k, dtype, 1)
    assert logits.stride(-1) == 1 and logits.stride(-2) == 2 * k * k
    buf = torch.rand((b, h + k - 1, w + k - 1, 3), device=cuda, generator=g).requires_grad_()
    cot = torch.randn((b, h, w, 3), device=cuda, generator=g)
    _build.reset_counts()
    out = ka.kernel_gather_softmax(buf, logits, k)
    dbuf, dfull = torch.autograd.grad(out, [buf, full], cot)
    assert dict(_build.launches) == {"gather_softmax": 1, "outer_softmax": 1,
                                     "scatter_softmax": 1}
    assert not _build.plain_calls
    lg = logits.detach()
    _close(out, ka.gather_softmax_plain(buf.detach(), lg, k), K1_TOL)
    dlogits = dfull.permute(0, 2, 3, 1)[..., k * k:]
    _close(dlogits, ka.outer_softmax_plain(cot, buf.detach(), lg, k),
           K1_TOL if dtype == torch.float32 else K2_BF16_TOL)
    assert not dfull.permute(0, 2, 3, 1)[..., :k * k].any()
    _close(dbuf, ka.scatter_softmax_plain(cot, lg, k), K1_TOL)


def _single_pathnet_params(cuda, g):
    dims = (36, 64, 64, 64)
    ws = [torch.randn((ci, co), device=cuda, generator=g) / ci**0.5
          for ci, co in zip(dims[:-1], dims[1:])]
    bs = [0.1 * torch.randn(co, device=cuda, generator=g) for co in dims[1:]]
    hws = [torch.randn((128, 128), device=cuda, generator=g) / 128**0.5,
           torch.randn((128, 3), device=cuda, generator=g) / 128**0.5]
    hbs = [0.1 * torch.randn(128, device=cuda, generator=g),
           0.1 * torch.randn(3, device=cuda, generator=g)]
    return ws, bs, hws, hbs


@pytest.mark.parametrize("b,s,hw", [(2, 3, 100), (8, 8, 16384)])
def test_single_pathnet_kernels(cuda, b, s, hw):
    """K4 and K5, forward and backward, at the single PathNet's widths
    (36 -> 64 -> 64 -> 64; [64 | 64] -> 128 -> 3), the head channels-last
    without moments and with a per-sample cotangent, as LBMC runs them."""
    g = _gen(14)
    ws, bs, hws, hbs = _single_pathnet_params(cuda, g)
    x = torch.randn((b, s, hw, 36), device=cuda, generator=g).to(torch.bfloat16)
    _build.reset_counts()
    e, mean = pf.pathnet_embed(x, ws, bs)
    we, wm = pf._embed_plain(x, ws, bs, pf.EMBED_ACTS)
    _close(e, we, BF16_TOL)
    _close(mean, wm, BF16_TOL)
    ctx = torch.randn((b, hw, 64), device=cuda, generator=g).to(torch.bfloat16)
    out = pf.pathnet_head(e, ctx, hws, hbs)
    assert out.shape == (b, s, hw, 3)
    _close(out, pf._head_plain(e, ctx, hws, hbs, pf.HEAD_ACTS), BF16_TOL)
    assert dict(_build.launches) == {"pathnet_embed": 1, "pathnet_head": 1}
    gout = torch.randn((b, s, hw, 3), device=cuda, generator=g)
    got = pf.pathnet_head_bwd(e, ctx, gout, None, None, hws, hbs)
    want = pf._head_bwd_plain(e, ctx, gout, None, None, hws, hbs, pf.HEAD_ACTS)
    _close_l2(got[0], want[0], 1e-2)
    _close_l2(got[1], want[1], 1e-2)
    for gt, wt in zip([*got[2], *got[3]], [*want[2], *want[3]]):
        _close(gt, wt, BF16_TOL)
    ge = torch.randn((b, s, hw, 64), device=cuda, generator=g).to(torch.bfloat16)
    gmean = torch.randn((b, hw, 64), device=cuda, generator=g)
    _, dws, dbs = pf.pathnet_embed_bwd(x, ge, gmean, ws, bs)
    _, pws, pbs = pf._embed_bwd_plain(x, ge, gmean, ws, bs, pf.EMBED_ACTS)
    for gt, wt in zip(dws + dbs, pws + pbs):
        _close(gt, wt, BF16_TOL)
    assert dict(_build.launches) == {"pathnet_embed": 1, "pathnet_head": 1,
                                     "pathnet_head_bwd": 1, "pathnet_embed_bwd": 1}


def test_lbmc_train_batch_on_the_card_matches_the_cpu(cuda):
    """One bf16 LBMC + manifold train step on the card (K10, K1-K5)
    against the same fresh weights, batch (2 patches of 64 px, 8 spp) and
    draws on the CPU (every plain version), as ``chip_smoke.py``'s
    cross-check holds the flagship step.  Measured on an H100: losses
    within 4.3e-6 relative, each model's flattened gradient within cosine
    0.99995 and norm ratio 1 +- 0.0014; held to 2.5e-5, 0.9997 and 0.005."""
    import numpy as np

    from wcmc_tpu_torch import convert
    from wcmc_tpu_torch.data.batches import synthetic_batch
    from wcmc_tpu_torch.train.factory import TrainConfig, init_interfaces

    cfg = TrainConfig(base_model="lbmc", use_llpm_buf=True, manif_learn=True,
                      manif_loss="FMSE")
    card = init_interfaces(cfg, device=cuda)[0]
    cpu = init_interfaces(cfg, device="cpu")[0]
    for name, m in card.models.items():
        convert.load_flax_params(cpu.models[name], convert.to_flax(m))
    batch = synthetic_batch(np.random.default_rng(0), "lbmc", 2, 64, 8, True)
    for iface in (card, cpu):
        iface.to_train_mode()
        iface.preprocess(batch)
    draws = card.draw_pairings((2, 8, 64, 64, 3))
    _build.reset_counts()
    ld_card = card.train_batch(batch, grad_hook_mode=True, draws=draws)
    launched = dict(_build.launches)
    assert not _build.plain_calls
    assert launched == {"mlp_fused": 1, "mlp_fused_bwd": 1, "gather_softmax": 2,
                        "outer_softmax": 2, "scatter_softmax": 2, "pathnet_embed": 1,
                        "pathnet_embed_bwd": 1, "pathnet_head": 1, "pathnet_head_bwd": 1}
    ld_cpu = cpu.train_batch(batch, grad_hook_mode=True, draws=draws)
    measured = {k: abs(float(ld_card[k]) - float(v)) / abs(float(v)) for k, v in ld_cpu.items()}
    for name, m in card.models.items():
        a = torch.cat([p.grad.flatten().double().cpu() for p in m.parameters()])
        b = torch.cat([p.grad.flatten().double() for p in cpu.models[name].parameters()])
        measured[name] = (float(a @ b / (a.norm() * b.norm())), float(a.norm() / b.norm()))
    print(measured)
    for k in ld_cpu:
        assert measured[k] <= 2.5e-5, (k, measured)
    for name in card.models:
        cos, ratio = measured[name]
        assert cos >= 0.9997 and abs(ratio - 1) <= 0.005, (name, measured)


def test_lbmc_train_batch_repeats_bit_for_bit(cuda):
    """The same LBMC step three times from the same weights, batch and
    draws gives the same gradients bit for bit: every kernel sums in a
    fixed order, and the LayerNet's edge padding has no atomic backward."""
    import numpy as np

    from wcmc_tpu_torch.data.batches import synthetic_batch
    from wcmc_tpu_torch.train.factory import TrainConfig, init_interfaces

    cfg = TrainConfig(base_model="lbmc", use_llpm_buf=True, manif_learn=True,
                      manif_loss="FMSE")
    iface = init_interfaces(cfg, device=cuda)[0]
    batch = synthetic_batch(np.random.default_rng(0), "lbmc", 4, 64, 8, True)
    batch = {k: v.to(cuda) for k, v in batch.items()}
    iface.to_train_mode()
    draws = iface.draw_pairings((4, 8, 64, 64, 3))
    grads = []
    for _ in range(3):
        iface.preprocess(batch)
        iface.train_batch(batch, grad_hook_mode=True, draws=draws)
        grads.append([p.grad.clone() for m in iface.models.values() for p in m.parameters()])
    for other in grads[1:]:
        assert all(torch.equal(a, b) for a, b in zip(grads[0], other))


# ---------------------------------------------------------------------------
# SBMC shapes: K7, K4-fwd with leaky relu, K5-fwd wide with a bf16 output
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,w,c,ksize", [(2, 11, 13, 4, 5), (3, 20, 17, 3, 21),
                                           (64, 128, 128, 4, 21)])
def test_scatter(cuda, b, h, w, c, ksize):
    """K7 at small shapes and at the SBMC serving shape (8 tiles x 8 spp,
    radiance and a ones channel, 441 f32 weights per sample)."""
    g = _gen(20)
    x = torch.randn((b, h, w, c), device=cuda, generator=g)
    wt = torch.rand((b, h, w, ksize * ksize), device=cuda, generator=g)
    _build.reset_counts()
    got = ka.scatter(x, wt, ksize)
    assert dict(_build.launches) == {"scatter": 1} and not _build.plain_calls
    assert got.shape == (b, h + ksize - 1, w + ksize - 1, c)
    _close(got, ka.scatter_plain(x, wt, ksize), K1_TOL)


def test_scatter_strided_weights_and_splat(cuda):
    """The weights may be a view with contiguous taps; ``kernel_splat``
    launches K7 once, and its backward K9 (d x) and K8 (d w) once each,
    or K8 alone for values that are data."""
    from wcmc_tpu_torch.ops import splat

    g = _gen(21)
    x = torch.randn((2, 9, 10, 4), device=cuda, generator=g)
    big = torch.rand((2, 12, 14, 25), device=cuda, generator=g)
    view = big[:, 2:11, 3:13]
    assert not view.is_contiguous() and view.stride(-1) == 1
    # the view runs the gather body: the same bits as a contiguous copy on it
    torch.testing.assert_close(ka.scatter(x, view, 5),
                               ka.scatter(x, view.contiguous(), 5, body="gather"), rtol=0, atol=0)
    xg = x.clone().requires_grad_()
    wg = big.clone().requires_grad_()
    wview = wg[:, 2:11, 3:13]
    _build.reset_counts()
    out = splat.kernel_splat(xg, wview, 5)
    assert dict(_build.launches) == {"scatter": 1} and out.shape == x.shape
    cot = torch.randn(out.shape, device=cuda, generator=g)
    dx, dw = torch.autograd.grad(out, [xg, wg], cot)
    assert dict(_build.launches) == {"scatter": 1, "gather": 1, "outer": 1}
    assert not _build.plain_calls
    full = torch.zeros((2, 13, 14, 4), device=cuda)
    full[:, 2:11, 2:12] = cot
    _close(dx, ka.gather_plain(full, view, 5), K1_TOL)
    _close(dw[:, 2:11, 3:13], ka.outer_plain(x, full, 5), K1_TOL)
    assert not bool(dw[:, :2].any()) and not bool(dw[:, 11:].any())
    out = splat.kernel_splat(x, wview, 5)
    _build.reset_counts()
    torch.autograd.grad(out, wg, cot)
    assert dict(_build.launches) == {"outer": 1}
    with pytest.raises(TypeError):
        ka.scatter(x, view.to(torch.bfloat16), 5)


@pytest.mark.parametrize("b,h,w,c,ksize", [(2, 11, 13, 4, 5), (3, 20, 17, 3, 21),
                                           (64, 128, 128, 4, 21)])
def test_outer(cuda, b, h, w, c, ksize):
    """K8 at small shapes and at the SBMC training shape: the splatted
    values (radiance and a ones channel) against the canvas cotangent."""
    g = _gen(24)
    x = torch.randn((b, h, w, c), device=cuda, generator=g)
    canvas = torch.randn((b, h + ksize - 1, w + ksize - 1, c), device=cuda, generator=g)
    _build.reset_counts()
    got = ka.outer(x, canvas, ksize)
    assert dict(_build.launches) == {"outer": 1} and not _build.plain_calls
    assert got.shape == (b, h, w, ksize * ksize) and got.dtype == torch.float32
    _close(got, ka.outer_plain(x, canvas, ksize), K1_TOL)


# K7's banded body and K8's tiled body: h and w off the band, the run and
# 4 (odd w: 4-byte spans), C 1 to 8, K 5, 13 and 21, and the SBMC shape
SPLAT_CASES = [(2, 11, 13, 4, 5), (3, 20, 17, 3, 21), (2, 37, 45, 1, 13), (1, 33, 64, 2, 21),
               (2, 19, 100, 5, 13), (1, 40, 96, 6, 5), (2, 9, 31, 7, 21), (1, 50, 70, 8, 21),
               (64, 128, 128, 4, 21)]


def _splat_case(cuda, b, h, w, c, ksize, seed):
    g = _gen(seed)
    x = torch.randn((b, h, w, c), device=cuda, generator=g)
    wt = torch.rand((b, h, w, ksize * ksize), device=cuda, generator=g)
    return x, wt


def _check_banded(x, wt, ksize):
    """The banded body within K1_TOL of the plain version and of the gather
    body (the same f32 products summed in another order), and two launches
    bit for bit."""
    _build.reset_counts()
    got = ka.scatter(x, wt, ksize)
    assert dict(_build.launches) == {"scatter": 1} and not _build.plain_calls
    _close(got, ka.scatter_plain(x, wt, ksize), K1_TOL)
    _close(got, ka.scatter(x, wt, ksize, body="gather"), K1_TOL)
    assert torch.equal(ka.scatter(x, wt, ksize), got)


@pytest.mark.parametrize("b,h,w,c,ksize", SPLAT_CASES)
def test_scatter_banded(cuda, b, h, w, c, ksize):
    """K7's banded body on contiguous weights, its spans by bulk copies
    where w is a multiple of 4 and by 4-byte copies otherwise."""
    x, wt = _splat_case(cuda, b, h, w, c, ksize, 30)
    assert ka.scatter_route(x, wt, ksize) == ("banded", "bulk" if w % 4 == 0 else "4-byte")
    _check_banded(x, wt, ksize)


@pytest.mark.parametrize("b,h,w,c,ksize,bands,tiles", [
    (1, 33, 150, 8, 21, 2, 3), (2, 37, 300, 4, 21, 2, 2), (1, 45, 100, 6, 21, 2, 2),
    (2, 20, 200, 3, 21, 1, 2), (1, 40, 40, 4, 5, 2, 1)])
def test_scatter_banded_bands_and_tiles(cuda, b, h, w, c, ksize, bands, tiles):
    """Several bands (the last of a few rows), and column tiles where a
    whole canvas row does not fit in shared memory (K = 21 with C above 4,
    or w above 160): the second launch sums partials across bands and
    tiles."""
    plan = ka.splat_plan(h, w, c, ksize)
    assert plan.banded and (plan.bands, plan.tiles) == (bands, tiles)
    x, wt = _splat_case(cuda, b, h, w, c, ksize, 31)
    _check_banded(x, wt, ksize)


def test_scatter_banded_unaligned_and_strided(cuda):
    """Contiguous weights that do not start on 16 bytes take the banded
    body's 4-byte copies; a strided weight view takes the gather body."""
    g = _gen(32)
    b, h, w, c, k = 2, 21, 36, 4, 13
    x = torch.randn((b, h, w, c), device=cuda, generator=g)
    flat = torch.rand(b * h * w * k * k + 1, device=cuda, generator=g)
    wt = flat[1:].view(b, h, w, k * k)
    assert wt.is_contiguous() and wt.data_ptr() % 16
    assert ka.scatter_route(x, wt, k) == ("banded", "4-byte")
    _check_banded(x, wt, k)
    big = torch.rand((b, h + 2, w + 3, k * k), device=cuda, generator=g)
    view = big[:, 1:1 + h, 2:2 + w]
    assert ka.scatter_route(x, view, k) == ("gather", None)
    _build.reset_counts()
    got = ka.scatter(x, view, k)
    assert dict(_build.launches) == {"scatter": 1}
    _close(got, ka.scatter_plain(x, view, k), K1_TOL)
    with pytest.raises(ValueError):
        ka.scatter(x, view, k, body="banded")


@pytest.mark.parametrize("b,h,w,c,ksize", SPLAT_CASES)
def test_outer_tiled(cuda, b, h, w, c, ksize):
    """K8's tiled body: bit for bit the first port's body and itself over
    two launches, within K1_TOL of the plain version."""
    g = _gen(33)
    x = torch.randn((b, h, w, c), device=cuda, generator=g)
    canvas = torch.randn((b, h + ksize - 1, w + ksize - 1, c), device=cuda, generator=g)
    _build.reset_counts()
    got = ka.outer(x, canvas, ksize)
    assert dict(_build.launches) == {"outer": 1} and not _build.plain_calls
    ref = ka.outer(x, canvas, ksize, body="warp")
    assert torch.equal(got, ref), (got - ref).abs().max().item()
    del ref
    assert torch.equal(ka.outer(x, canvas, ksize), got)
    _close(got, ka.outer_plain(x, canvas, ksize), K1_TOL)


def test_outer_tiled_unaligned_inputs(cuda):
    """Values and a canvas cotangent that do not start on 16 bytes are
    staged 4 bytes at a time, with the same bits."""
    g = _gen(34)
    b, h, w, c, k = 2, 13, 40, 4, 13
    flat = torch.randn(b * h * w * c + 1, device=cuda, generator=g)
    x = flat[1:].view(b, h, w, c)
    flat = torch.randn(b * (h + k - 1) * (w + k - 1) * c + 3, device=cuda, generator=g)
    canvas = flat[3:].view(b, h + k - 1, w + k - 1, c)
    got = ka.outer(x, canvas, k)
    assert torch.equal(got, ka.outer(x, canvas, k, body="warp"))


@pytest.mark.parametrize("w,c,ksize", [(128, 4, 21), (128, 8, 21), (17, 3, 21), (45, 1, 13),
                                       (100, 5, 13), (31, 7, 21), (96, 6, 5), (1000, 2, 5),
                                       (300, 4, 21)])
def test_splat_plan_is_the_kernels_shared_memory(cuda, w, c, ksize):
    """``splat_plan``'s total is the dynamic shared memory K7's banded body
    gives a block (the kernel also checks its own carve against it at every
    launch)."""
    import ctypes

    fn = _build.library().wcmc_scatter_banded_smem
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_longlong
    plan = ka.splat_plan(16, w, c, ksize)
    assert plan.banded and fn(plan.cols, c, ksize) == plan.total


@pytest.mark.parametrize("c", range(1, 9))
@pytest.mark.parametrize("ksize", [5, 13, 21])
def test_outer_plan_is_the_kernels_shared_memory(cuda, c, ksize):
    """``outer_plan``'s total is the dynamic shared memory K8's tiled body
    gives a block."""
    import ctypes

    fn = _build.library().wcmc_outer_tiled_smem
    fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_longlong
    assert fn(c, ksize) == ka.outer_plan(c, ksize).total


def _chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_softmax_kernels_run_their_new_bodies(cuda):
    """K2 and K3 at the path shapes run their new bodies: K2's profiled
    device entries at LBMC's layer-1 view and KPCN's crop are its tiled
    body's, K3's at LBMC's its banded body's and its band sums', none a
    first body's, and none is filed under K7's or K8's kinds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cs = _chip_smoke()
    g = _gen(35)
    calls = []
    for b, h, w, k, view in ((8, 128, 128, 13, "layer1"), (8, 72, 72, 21, "crop")):
        lg = _softmax_logits(cuda, g, b, h, w, k, torch.bfloat16, view)
        buf = torch.rand((b, h + k - 1, w + k - 1, 3), device=cuda, generator=g)
        cot = torch.randn((b, h, w, 3), device=cuda, generator=g)
        calls.append(lambda cot=cot, buf=buf, lg=lg, k=k: ka.outer_softmax(cot, buf, lg, k))
        if k == 13:
            calls.append(lambda cot=cot, lg=lg, k=k: ka.scatter_softmax(cot, lg, k))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for call in calls:
            call()
        torch.cuda.synchronize()
    kinds = [cs.device_kind(e.name) for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert kinds.count("outer_softmax_tiled") == 2
    assert kinds.count("scatter_softmax_banded") == 2   # the bands, then their sums
    assert not set(kinds) & {"outer_softmax", "scatter_softmax", "scatter", "scatter_banded",
                             "outer", "outer_tiled"}


def _softmax_logits(cuda, g, b, h, w, ksize, dtype, view):
    """Logits as the paths hand them to K2 and K3: "contiguous"; "layer0" /
    "layer1", a layer's slice of a channels-last (B, 2 K*K, h, w) kernel
    head (LBMC); "crop", the crop of a channels-last convolution output
    (KPCN); "offset", contiguous but 2 (bf16) or 4 (f32) bytes off 16."""
    if view in ("layer0", "layer1"):
        return _kernel_head_logits(cuda, g, b, h, w, ksize, dtype, int(view[-1]))[1].detach()
    if view == "crop":
        return _crop_logits(cuda, g, b, h, w, ksize, dtype).detach()
    n = b * h * w * ksize * ksize
    flat = (2 * torch.randn(n + 1, device=cuda, generator=g)).to(dtype)
    return flat[1:].view(b, h, w, ksize * ksize) if view == "offset" else flat[:n].view(
        b, h, w, ksize * ksize)


# K2's and K3's new bodies: K 5, 13 and 21, widths 128, 72, 45 and 17,
# ragged h, contiguous logits, LBMC's two layer views, KPCN's crop, and
# both path shapes
SOFTMAX_CASES = [(2, 11, 128, 5, "contiguous"), (2, 37, 72, 13, "crop"),
                 (1, 20, 45, 21, "contiguous"), (3, 9, 17, 13, "layer0"),
                 (2, 19, 128, 13, "layer1"), (2, 13, 45, 5, "layer1"),
                 (1, 33, 17, 21, "crop"), (2, 21, 72, 21, "layer0"),
                 (8, 128, 128, 13, "layer0"), (8, 128, 128, 13, "layer1"),
                 (8, 72, 72, 21, "crop")]


def _softmax_case(cuda, b, h, w, ksize, dtype, view, seed):
    g = _gen(seed)
    lg = _softmax_logits(cuda, g, b, h, w, ksize, dtype, view)
    buf = torch.rand((b, h + ksize - 1, w + ksize - 1, 3), device=cuda, generator=g)
    cot = torch.randn((b, h, w, 3), device=cuda, generator=g)
    return cot, buf, lg


def _check_outer_softmax_tiled(cot, buf, lg, ksize):
    """K2's tiled body: bit for bit the first body and itself over two
    launches, within K1_TOL (f32 logits) or K2_BF16_TOL (bf16) of the plain
    version."""
    _build.reset_counts()
    got = ka.outer_softmax(cot, buf, lg, ksize)
    assert dict(_build.launches) == {"outer_softmax": 1} and not _build.plain_calls
    assert got.dtype == lg.dtype and got.is_contiguous()
    ref = ka.outer_softmax(cot, buf, lg, ksize, body="warp")
    assert torch.equal(got, ref), (got.float() - ref.float()).abs().max().item()
    del ref
    assert torch.equal(ka.outer_softmax(cot, buf, lg, ksize), got)
    _close(got, ka.outer_softmax_plain(cot, buf, lg, ksize),
           K1_TOL if lg.dtype == torch.float32 else K2_BF16_TOL)


def _check_scatter_softmax_banded(cot, lg, ksize):
    """K3's banded body within K1_TOL of the gather body and of the plain
    version (the same f32 probabilities, d buf summed in another order),
    and two launches bit for bit."""
    _build.reset_counts()
    got = ka.scatter_softmax(cot, lg, ksize)
    assert dict(_build.launches) == {"scatter_softmax": 1} and not _build.plain_calls
    _close(got, ka.scatter_softmax(cot, lg, ksize, body="gather"), K1_TOL)
    _close(got, ka.scatter_softmax_plain(cot, lg, ksize), K1_TOL)
    assert torch.equal(ka.scatter_softmax(cot, lg, ksize), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,ksize,view", SOFTMAX_CASES)
def test_outer_softmax_tiled(cuda, b, h, w, ksize, view, dtype):
    cot, buf, lg = _softmax_case(cuda, b, h, w, ksize, dtype, view, 36)
    assert ka.outer_softmax_route(cot, buf, lg, ksize).body == "tiled"
    _check_outer_softmax_tiled(cot, buf, lg, ksize)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,ksize,view", SOFTMAX_CASES)
def test_scatter_softmax_banded(cuda, b, h, w, ksize, view, dtype):
    """K3's banded body where its plan fits (K up to 13 here); at K = 21
    the plan gives the gather body, which the banded one cannot replace."""
    cot, _, lg = _softmax_case(cuda, b, h, w, ksize, dtype, view, 37)
    route = ka.scatter_softmax_route(cot, lg, ksize, _build.sm_count(0))
    assert route.body == ("banded" if ksize <= 13 else "gather")
    if route.body == "banded":
        _check_scatter_softmax_banded(cot, lg, ksize)
    else:
        with pytest.raises(ValueError):
            ka.scatter_softmax(cot, lg, ksize, body="banded")
        _close(ka.scatter_softmax(cot, lg, ksize), ka.scatter_softmax_plain(cot, lg, ksize),
               K1_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_vjp_unaligned_inputs(cuda, dtype):
    """Logits 2 (bf16) or 4 (f32) bytes off 16, and a cotangent and buffer
    4 bytes off 16: every landed span takes its 4-byte or zero-filled
    16-byte copies, with the same bits."""
    g = _gen(38)
    b, h, w, k = 2, 21, 40, 13
    lg = _softmax_logits(cuda, g, b, h, w, k, dtype, "offset")
    assert lg.data_ptr() % 16
    flat = torch.randn(b * h * w * 3 + 1, device=cuda, generator=g)
    cot = flat[1:].view(b, h, w, 3)
    flat = torch.rand(b * (h + k - 1) * (w + k - 1) * 3 + 1, device=cuda, generator=g)
    buf = flat[1:].view(b, h + k - 1, w + k - 1, 3)
    assert cot.data_ptr() % 16 and buf.data_ptr() % 16
    assert ka.scatter_softmax_route(cot, lg, k).spans == "4-byte"
    _check_outer_softmax_tiled(cot, buf, lg, k)
    _check_scatter_softmax_banded(cot, lg, k)


@pytest.mark.parametrize("es", [2, 4])
@pytest.mark.parametrize("c", range(1, 9))
@pytest.mark.parametrize("ksize", [5, 13, 21])
def test_softmax_plans_are_the_kernels_shared_memory(cuda, ksize, c, es):
    """``outer_softmax_plan``'s and ``scatter_softmax_plan``'s totals are
    the dynamic shared memory K2's tiled body and K3's banded body give a
    block (each kernel also checks its own carve against it at every
    launch)."""
    import ctypes

    lib = _build.library()
    outer, splat = lib.wcmc_outer_softmax_tiled_smem, lib.wcmc_scatter_softmax_banded_smem
    for fn in (outer, splat):
        fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_longlong
    for w in (17, 72, 128):
        plan = ka.outer_softmax_plan(2, 16, w, c, ksize, es)
        assert outer(plan.run, c, ksize, es) == plan.total
        plan = ka.scatter_softmax_plan(2, 16, w, c, ksize, es)
        if plan.banded:
            assert splat(plan.cols, c, ksize, es) == plan.total


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,c,ksize", [(2, 11, 13, 4, 5), (3, 20, 17, 3, 21),
                                           (64, 128, 128, 4, 21)])
def test_gather(cuda, b, h, w, c, ksize, dtype):
    """K9 with f32 or bf16 weights as a strided view (taps contiguous),
    at small shapes and at the splat's d(x) shape."""
    g = _gen(25)
    buf = torch.randn((b, h + ksize - 1, w + ksize - 1, c), device=cuda, generator=g)
    big = torch.rand((b, h + 1, w + 2, ksize * ksize), device=cuda, generator=g).to(dtype)
    wt = big[:, 1:, 2:]
    assert wt.stride(-1) == 1 and (h == 0 or not wt.is_contiguous())
    _build.reset_counts()
    got = ka.gather(buf, wt, ksize)
    assert dict(_build.launches) == {"gather": 1} and not _build.plain_calls
    assert got.shape == (b, h, w, c) and got.dtype == torch.float32
    _close(got, ka.gather_plain(buf, wt, ksize), K1_TOL)
    del big


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_gather_autograd(cuda, dtype):
    """``kernel_gather`` (``kernel_apply(softmax=False)``): K9 forward, K8
    (d w) and K7 (d buf) backward, gradients in the inputs' dtypes."""
    g = _gen(26)
    b, h, w, k = 2, 19, 23, 7
    buf = torch.randn((b, h + k - 1, w + k - 1, 3), device=cuda, generator=g).requires_grad_()
    wt = torch.rand((b, h, w, k * k), device=cuda, generator=g).to(dtype).requires_grad_()
    cot = torch.randn((b, h, w, 3), device=cuda, generator=g)
    _build.reset_counts()
    out = ka.kernel_apply(buf, wt, k, softmax=False)
    dbuf, dw = torch.autograd.grad(out, [buf, wt], cot)
    assert dict(_build.launches) == {"gather": 1, "outer": 1, "scatter": 1}
    assert not _build.plain_calls
    assert dbuf.dtype == torch.float32 and dw.dtype == dtype
    _close(out, ka.gather_plain(buf.detach(), wt.detach(), k), K1_TOL)
    _close(dbuf, ka.scatter_plain(cot, wt.detach().float(), k), K1_TOL)
    _close(dw, ka.outer_plain(cot, buf.detach(), k).to(dtype),
           K1_TOL if dtype == torch.float32 else K2_BF16_TOL)


@pytest.mark.parametrize("b,s,hw", [(2, 3, 100), (8, 8, 16384)])
def test_pathnet_embed_sbmc(cuda, b, s, hw):
    """K4-fwd in Multisteps' form: 95 -> 128 -> 128 -> 128, leaky relu."""
    g = _gen(22)
    dims = (95, 128, 128, 128)
    x = torch.randn((b, s, hw, 95), device=cuda, generator=g).to(torch.bfloat16)
    ws = [torch.randn((ci, co), device=cuda, generator=g) / ci**0.5
          for ci, co in zip(dims[:-1], dims[1:])]
    bs = [0.1 * torch.randn(co, device=cuda, generator=g) for co in dims[1:]]
    _build.reset_counts()
    e, mean = pf.pathnet_embed(x, ws, bs, LEAKY3)
    assert dict(_build.launches) == {"pathnet_embed": 1} and not _build.plain_calls
    we, wm = pf._embed_plain(x, ws, bs, LEAKY3)
    _close(e, we, BF16_TOL)
    _close(mean, wm, BF16_TOL)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("moments", [True, False])
@pytest.mark.parametrize("b,s,hw", [(2, 3, 100), (8, 8, 16384)])
def test_pathnet_head_sbmc(cuda, b, s, hw, moments, out_dtype):
    """K5-fwd in Multisteps' update form: [128 | 128] -> 128 -> 128, leaky
    relu; the moments are summed from the unrounded f32 output."""
    g = _gen(23)
    e = torch.randn((b, s, hw, 128), device=cuda, generator=g).to(torch.bfloat16)
    ctx = torch.randn((b, hw, 128), device=cuda, generator=g).to(torch.bfloat16)
    ws = [torch.randn((256, 128), device=cuda, generator=g) / 16.0,
          torch.randn((128, 128), device=cuda, generator=g) / 128**0.5]
    bs = [0.1 * torch.randn(128, device=cuda, generator=g) for _ in range(2)]
    _build.reset_counts()
    got = pf.pathnet_head(e, ctx, ws, bs, LEAKY3[:2], moments, out_dtype=out_dtype)
    assert dict(_build.launches) == {"pathnet_head": 1} and not _build.plain_calls
    want = pf._head_plain(e, ctx, ws, bs, LEAKY3[:2], moments, out_dtype=out_dtype)
    got, want = (got, want) if moments else ((got,), (want,))
    assert got[0].dtype == out_dtype and got[0].shape == (b, s, hw, 128)
    for gt, wt in zip(got, want):
        _close(gt, wt, BF16_TOL)


# K5-fwd's tiled body: (activations, Ce = Cc, C1, Cout, output dtype) of
# Multisteps' update chain, KPCN's merged head and the 64-wide PathNet head
HEAD_FWD_FORMS = {"multisteps": (LEAKY3[:2], 128, 128, 128, torch.bfloat16),
                  "kpcn": (pf.HEAD_ACTS, 128, 256, 6, torch.float32),
                  "pathnet64": (pf.HEAD_ACTS, 64, 128, 3, torch.float32)}
# the paths' layouts: Multisteps channels-last, KPCN both (serving,
# training), the 64-wide head channels-last (and channel-major, which no
# path runs but the body takes)
HEAD_FWD_CASES = [("multisteps", False), ("kpcn", False), ("kpcn", True),
                  ("pathnet64", False), ("pathnet64", True)]


def _head_fwd_case(cuda, form, b, s, hw, seed):
    acts, ce, c1, cout, dtype = HEAD_FWD_FORMS[form]
    g = _gen(seed)
    e = torch.randn((b, s, hw, ce), device=cuda, generator=g).to(torch.bfloat16)
    ctx = torch.randn((b, hw, ce), device=cuda, generator=g).to(torch.bfloat16)
    ws = [torch.randn((2 * ce, c1), device=cuda, generator=g) / (2 * ce) ** 0.5,
          torch.randn((c1, cout), device=cuda, generator=g) / c1 ** 0.5]
    bs = [0.1 * torch.randn(c1, device=cuda, generator=g),
          0.1 * torch.randn(cout, device=cuda, generator=g)]
    return acts, dtype, e, ctx, ws, bs


@pytest.mark.parametrize("form,cmajor", HEAD_FWD_CASES)
@pytest.mark.parametrize("b,s,hw", [(2, 3, 100), (8, 8, 16384), (1, 1, 64), (3, 2, 65),
                                    (1, 5, 1)])
def test_pathnet_head_tiled(cuda, form, cmajor, b, s, hw):
    """K5-fwd's tiled body in every form a path runs, at the path shape
    and beside it (a ragged 64-pixel unit, one unit, one pixel, fewer units
    than blocks): within 2e-2 of max |plain| (bf16 hidden layer summed in
    another order), two launches bit for bit, and the output without
    moments the output with them, bit for bit."""
    acts, dtype, e, ctx, ws, bs = _head_fwd_case(cuda, form, b, s, hw, 31)
    c1, cout = ws[1].shape
    assert pf.head_fwd_plan(acts, e.shape[-1], ctx.shape[-1], c1, cout, dtype, cmajor).form == form
    _build.reset_counts()
    got = pf.pathnet_head(e, ctx, ws, bs, acts, True, cmajor, dtype)
    assert dict(_build.launches) == {"pathnet_head": 1} and not _build.plain_calls
    want = pf._head_plain(e, ctx, ws, bs, acts, True, cmajor, dtype)
    shape = (b, s, cout, hw) if cmajor else (b, s, hw, cout)
    assert got[0].dtype == dtype and tuple(got[0].shape) == shape
    for gt, wt in zip(got, want):
        _close(gt, wt, BF16_TOL)
    again = pf.pathnet_head(e, ctx, ws, bs, acts, True, cmajor, dtype)
    for gt, wt in zip(again, got):
        assert torch.equal(gt, wt)
    no_moments = pf.pathnet_head(e, ctx, ws, bs, acts, False, cmajor, dtype)
    assert torch.equal(no_moments, got[0])


@pytest.mark.parametrize("form,cmajor", HEAD_FWD_CASES)
def test_pathnet_head_tiled_repeats_the_wmma_body(cuda, form, cmajor):
    """The tiled body sums what the wmma body sums in the same order
    (ctx . W1c from zero and then b1, e . W1e added k16 step by k16 step,
    h1 . W2 from zero, the moments in sample order), so its output and
    moments are the wmma body's bit for bit."""
    acts, dtype, e, ctx, ws, bs = _head_fwd_case(cuda, form, 3, 5, 1000, 33)
    got = pf.pathnet_head(e, ctx, ws, bs, acts, True, cmajor, dtype)
    want = pf._head_fwd_kernel(e, ctx, ws, bs, acts, True, cmajor, dtype, wmma=True)
    for gt, wt in zip(got, want):
        assert torch.equal(gt, wt)


def test_pathnet_head_tiled_shares_the_pack_with_the_backward(cuda):
    """A forward and backward through autograd pack the head once: the
    backward finds the forward's pack."""
    acts, dtype, e, ctx, ws, bs = _head_fwd_case(cuda, "multisteps", 2, 3, 100, 32)
    params = [t.clone().requires_grad_() for t in ws + bs]
    pf._packed.clear()
    out, ssum, _ = pf.pathnet_head(e, ctx, params[:2], params[2:], acts, True, False, dtype)
    (out.float().sum() + ssum.sum()).backward()
    assert (pf._packed.misses, pf._packed.hits) == (1, 1)
    pf._packed.clear()


@pytest.mark.parametrize("acts,dims,out_dtype,cmajor", [
    (LEAKY3[:2], (128, 128, 128, 128), torch.bfloat16, False),
    (pf.HEAD_ACTS, (128, 128, 256, 6), torch.float32, True),
    (pf.HEAD_ACTS, (64, 64, 128, 3), torch.float32, False),
    (LEAKY3[:2], (128, 128, 128, 128), torch.float32, False),   # the wmma body
    (pf.HEAD_ACTS, (32, 32, 64, 6), torch.float32, False)])
def test_head_fwd_plan_is_the_kernels_shared_memory(cuda, acts, dims, out_dtype, cmajor):
    """``head_fwd_plan``'s total is the dynamic shared memory K5-fwd's
    entry point gives a block of the form (the tiled kernel also checks its
    own carve against it at every launch)."""
    import ctypes

    fn = _build.library().wcmc_pathnet_head_smem
    fn.argtypes, fn.restype = [ctypes.c_int] * 8, ctypes.c_longlong
    plan = pf.head_fwd_plan(tuple(acts), *dims, out_dtype, cmajor)
    codes = [mf.ACTS.index(a) for a in acts]
    assert fn(*dims, *codes, int(out_dtype == torch.bfloat16), int(cmajor)) == plan.total


def _sbmc_embed_case(cuda, b, s, hw, seed):
    g = _gen(seed)
    dims = (95, 128, 128, 128)
    x = torch.randn((b, s, hw, dims[0]), device=cuda, generator=g).to(torch.bfloat16)
    ws = [torch.randn((ci, co), device=cuda, generator=g) / ci**0.5
          for ci, co in zip(dims[:-1], dims[1:])]
    bs = [0.1 * torch.randn(co, device=cuda, generator=g) for co in dims[1:]]
    ge = torch.randn((b, s, hw, dims[-1]), device=cuda, generator=g).to(torch.bfloat16)
    gmean = torch.randn((b, hw, dims[-1]), device=cuda, generator=g)
    return x, ws, bs, ge, gmean


@pytest.mark.parametrize("b,s,hw", [(1, 11, 37)] + EMBED_BWD_SHAPES)
def test_pathnet_embed_backward_sbmc(cuda, b, s, hw):
    """K4-bwd in Multisteps' form: 95 -> 128 -> 128 -> 128, leaky relu x 3,
    with d(x) (rows of 95 bf16 values) and without."""
    x, ws, bs, ge, gmean = _sbmc_embed_case(cuda, b, s, hw, 27)
    _build.reset_counts()
    dx, dws, dbs = pf.pathnet_embed_bwd(x, ge, gmean, ws, bs, LEAKY3, compute_dx=True)
    assert dict(_build.launches) == {"pathnet_embed_bwd": 1} and not _build.plain_calls
    wdx, wdws, wdbs = pf._embed_bwd_plain(x, ge, gmean, ws, bs, LEAKY3, compute_dx=True)
    assert dx.dtype == torch.bfloat16 and dx.shape == x.shape and dx.is_contiguous()
    _close_l2(dx, wdx, 1e-2)
    for got, want in zip(dws + dbs, wdws + wdbs):
        assert got.dtype == torch.float32
        _close(got, want, BF16_TOL)
    # a second launch repeats bit for bit (partials summed in block order)
    dx2, dws2, dbs2 = pf.pathnet_embed_bwd(x, ge, gmean, ws, bs, LEAKY3, compute_dx=True)
    for got, want in zip([dx2, *dws2, *dbs2], [dx, *dws, *dbs]):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    # either cotangent absent
    for cots in ((None, gmean), (ge, None)):
        gdx, gws, gbs = pf.pathnet_embed_bwd(x, *cots, ws, bs, LEAKY3, compute_dx=True)
        pdx, pws, pbs = pf._embed_bwd_plain(x, *cots, ws, bs, LEAKY3, compute_dx=True)
        _close_l2(gdx, pdx, 1e-2)
        for got, want in zip(gws + gbs, pws + pbs):
            _close(got, want, BF16_TOL)
    none, dws2, dbs2 = pf.pathnet_embed_bwd(x, ge, gmean, ws, bs, LEAKY3)
    assert none is None
    for got, want in zip(dws2 + dbs2, dws + dbs):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    # through autograd: x and the weights require grad
    xg = x.clone().requires_grad_()
    params = [w.clone().requires_grad_() for w in ws + bs]
    e, mean = pf.pathnet_embed(xg, params[:3], params[3:], LEAKY3, compute_dx=True)
    _build.reset_counts()
    grads = torch.autograd.grad([e, mean], [xg, *params], [ge, gmean])
    assert dict(_build.launches) == {"pathnet_embed_bwd": 1}
    for got, want in zip(grads, [dx, *dws, *dbs]):
        torch.testing.assert_close(got, want.to(got.dtype), rtol=0, atol=0)
    with pytest.raises(ValueError):
        pf.pathnet_embed_bwd(x, ge, gmean, ws, bs, ("leaky_relu", "relu", "linear"))


def test_pathnet_embed_backward_other_inputs(cuda):
    """K4-bwd's other inputs, which the models do not pass: Multisteps' form
    with 40 input channels (padded to 48, where both warpgroups form d(x))
    and narrower layers (32, 48, 64, run zero-padded to 128); rows x that do
    not start on 16 bytes (every span by 2-byte loads); PathNet's form with
    60 input channels, 64 and 128 wide (the tiled body, C0 padded to 96),
    and 144 wide (the row-chunk body, C0 padded to 64); PathNet's form with
    150 input channels (the tiled body, slabs of 96)."""
    g = _gen(31)
    cases = [(LEAKY3, (40, 32, 48, 64), True, False), (LEAKY3, (95, 128, 128, 128), True, True),
             (pf.EMBED_ACTS, (60, 64, 64, 64), False, False),
             (pf.EMBED_ACTS, (60, 128, 128, 128), False, False),
             (pf.EMBED_ACTS, (60, 144, 144, 144), False, False),
             (pf.EMBED_ACTS, (150, 128, 128, 128), False, True)]
    for acts, dims, compute_dx, offset in cases:
        b, s, hw = 2, 3, 45
        x = torch.randn((b, s, hw, dims[0]), device=cuda, generator=g).to(torch.bfloat16)
        if offset:   # 2 bytes past a 16-byte boundary
            flat = torch.cat([torch.zeros(1, device=cuda, dtype=x.dtype), x.reshape(-1)])
            x = flat[1:].view(x.shape)
            assert x.data_ptr() % 16 == 2
        ws = [torch.randn((ci, co), device=cuda, generator=g) / ci**0.5
              for ci, co in zip(dims[:-1], dims[1:])]
        bs = [0.1 * torch.randn(co, device=cuda, generator=g) for co in dims[1:]]
        ge = torch.randn((b, s, hw, dims[-1]), device=cuda, generator=g).to(torch.bfloat16)
        gmean = torch.randn((b, hw, dims[-1]), device=cuda, generator=g)
        dx, dws, dbs = pf.pathnet_embed_bwd(x, ge, gmean, ws, bs, acts, compute_dx)
        wdx, wdws, wdbs = pf._embed_bwd_plain(x, ge, gmean, ws, bs, acts, compute_dx)
        if compute_dx:
            assert dx.shape == x.shape
            _close_l2(dx, wdx, 1e-2)
        for got, want in zip(dws + dbs, wdws + wdbs):
            assert got.shape == want.shape
            _close(got, want, BF16_TOL)


@pytest.mark.parametrize("c0", [97, 100, 128, 150])
@pytest.mark.parametrize("b,s,hw", [(2, 3, 45), (8, 8, 16384)])
def test_pathnet_embed_backward_sbmc_wide_input(cuda, b, s, hw, c0):
    """Multisteps' form at more input channels than 96 (``--pnet_out_size``
    5 or more gives 92 + the embedding width): C0 in slabs of 96, the
    block's dW0 added to in its partial chunk by chunk."""
    x, ws, bs, ge, gmean = _embed_case(cuda, b, s, hw, 33, (c0, 128, 128, 128))
    _build.reset_counts()
    dx, dws, dbs = pf.pathnet_embed_bwd(x, ge, gmean, ws, bs, LEAKY3, True)
    assert dict(_build.launches) == {"pathnet_embed_bwd": 1} and not _build.plain_calls
    wdx, wdws, wdbs = pf._embed_bwd_plain(x, ge, gmean, ws, bs, LEAKY3, True)
    assert dx.shape == x.shape
    _close_l2(dx, wdx, 1e-2)
    for got, want in zip(dws + dbs, wdws + wdbs):
        assert got.shape == want.shape
        _close(got, want, BF16_TOL)
    # a second launch repeats bit for bit (partials summed in block order)
    dx2, dws2, dbs2 = pf.pathnet_embed_bwd(x, ge, gmean, ws, bs, LEAKY3, True)
    for got, want in zip([dx2, *dws2, *dbs2], [dx, *dws, *dbs]):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def _sbmc_head_case(cuda, b, s, hw, seed):
    g = _gen(seed)
    e = torch.randn((b, s, hw, 128), device=cuda, generator=g).to(torch.bfloat16)
    ctx = torch.randn((b, hw, 128), device=cuda, generator=g).to(torch.bfloat16)
    ws = [torch.randn((256, 128), device=cuda, generator=g) / 16.0,
          torch.randn((128, 128), device=cuda, generator=g) / 128**0.5]
    bs = [0.1 * torch.randn(128, device=cuda, generator=g) for _ in range(2)]
    gout = torch.randn((b, s, hw, 128), device=cuda, generator=g).to(torch.bfloat16)
    gsum = torch.randn((b, hw, 128), device=cuda, generator=g)
    return e, ctx, ws, bs, gout, gsum


@pytest.mark.parametrize("moments", [True, False])
@pytest.mark.parametrize("b,s,hw", [
    (2, 3, 100), (1, 11, 37), (8, 8, 16384),
    # the tiled kernel's 32-pixel tile: HW at P - 1, P and P + 1; S = 1
    # and 2; fewer tiles (2 to 6) than the card's 132 blocks
    (2, 1, 31), (1, 2, 32), (3, 5, 33),
    # many more tiles than blocks, not a whole number per block
    (5, 2, 4099),
])
def test_pathnet_head_backward_sbmc(cuda, b, s, hw, moments):
    """K5-bwd in Multisteps' update form: [128 | 128] -> 128 -> 128, leaky
    relu, Cout 128, a bf16 channels-last output cotangent, with the
    ``gsum`` cotangent (steps 0 and 1; ``gsq`` None) or no moments (step 2)."""
    e, ctx, ws, bs, gout, gsum = _sbmc_head_case(cuda, b, s, hw, 28)
    gsum = gsum if moments else None
    _build.reset_counts()
    got = pf.pathnet_head_bwd(e, ctx, gout, gsum, None, ws, bs, LEAKY3[:2])
    assert dict(_build.launches) == {"pathnet_head_bwd": 1} and not _build.plain_calls
    want = pf._head_bwd_plain(e, ctx, gout, gsum, None, ws, bs, LEAKY3[:2])
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    _close_l2(got[0], want[0], 1e-2)
    _close_l2(got[1], want[1], 1e-2)
    for gt, wt in zip([*got[2], *got[3]], [*want[2], *want[3]]):
        _close(gt, wt, BF16_TOL)
    # a second launch repeats bit for bit (partials summed in block order)
    again = pf.pathnet_head_bwd(e, ctx, gout, gsum, None, ws, bs, LEAKY3[:2])
    for gt, wt in zip([again[0], again[1], *again[2], *again[3]],
                      [got[0], got[1], *got[2], *got[3]]):
        torch.testing.assert_close(gt, wt, rtol=0, atol=0)
    # through autograd, as Multisteps calls it
    params = [t.clone().requires_grad_() for t in (e, ctx, *ws, *bs)]
    res = pf.pathnet_head(params[0], params[1], params[2:4], params[4:], LEAKY3[:2], moments,
                          out_dtype=torch.bfloat16)
    outs, cots = ((res[0], res[1]), (gout, gsum)) if moments else ((res,), (gout,))
    _build.reset_counts()
    grads = torch.autograd.grad(outs, params, cots)
    assert dict(_build.launches) == {"pathnet_head_bwd": 1}
    for gt, wt in zip(grads, [got[0], got[1], *got[2], *got[3]]):
        torch.testing.assert_close(gt, wt.to(gt.dtype), rtol=0, atol=0)
    with pytest.raises(ValueError):   # an f32 cotangent is not Multisteps' form
        pf.pathnet_head_bwd(e, ctx, gout.float(), gsum, None, ws, bs, LEAKY3[:2])


def test_pathnet_head_backward_sbmc_other_inputs(cuda):
    """The update form's other inputs, which Multisteps does not pass: a
    ``gsq`` cotangent, a channel-major cotangent, a cotangent view that
    does not start on 16 bytes, and a narrower chain (Ce 64, Cc 32, C1 96,
    Cout 100, run zero-padded to the tiled widths)."""
    e, ctx, ws, bs, gout, gsum = _sbmc_head_case(cuda, 2, 3, 45, 29)
    gsq = 0.1 * gsum.flip(-1)
    flat = torch.cat([torch.zeros(1, device=cuda), gsum.reshape(-1)])
    gsum = flat[1:].view(gsum.shape)   # 4 bytes past a 16-byte boundary
    got = pf.pathnet_head_bwd(e, ctx, gout.transpose(2, 3), gsum, gsq, ws, bs, LEAKY3[:2],
                              cmajor=True)
    want = pf._head_bwd_plain(e, ctx, gout, gsum, gsq, ws, bs, LEAKY3[:2])
    _close_l2(got[0], want[0], 1e-2)
    _close_l2(got[1], want[1], 1e-2)
    for gt, wt in zip([*got[2], *got[3]], [*want[2], *want[3]]):
        _close(gt, wt, BF16_TOL)
    ce, cc, c1, cout = 64, 32, 96, 100
    w1 = torch.cat([ws[0][:ce, :c1], ws[0][128:128 + cc, :c1]])
    nws, nbs = [w1, ws[1][:c1, :cout]], [bs[0][:c1], bs[1][:cout]]
    ne, nctx = e[..., :ce].contiguous(), ctx[..., :cc].contiguous()
    ng = gout[..., :cout]
    got = pf.pathnet_head_bwd(ne, nctx, ng, gsum[..., :cout], None, nws, nbs, LEAKY3[:2])
    want = pf._head_bwd_plain(ne, nctx, ng, gsum[..., :cout], None, nws, nbs, LEAKY3[:2])
    assert got[0].shape == ne.shape and got[1].shape == nctx.shape
    _close_l2(got[0], want[0], 1e-2)
    _close_l2(got[1], want[1], 1e-2)
    for gt, wt in zip([*got[2], *got[3]], [*want[2], *want[3]]):
        assert gt.shape == wt.shape
        _close(gt, wt, BF16_TOL)


@pytest.mark.parametrize("acts,widths", [(LEAKY3[:2], (128, 128, 128)),
                                         (pf.HEAD_ACTS, (128, 128, 256)),
                                         (pf.HEAD_ACTS, (128, 128, 128)),
                                         (pf.HEAD_ACTS, (144, 128, 256))])
def test_head_bwd_plan_is_the_kernels_shared_memory(cuda, acts, widths):
    """``head_bwd_plan``'s total is the dynamic shared memory K5-bwd's
    entry point gives a block of the form (the tiled kernel also checks
    its own carve against it at every launch)."""
    import ctypes

    fn = _build.library().wcmc_pathnet_head_bwd_smem
    fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_longlong
    code = 2 if acts == LEAKY3[:2] else 1
    plan = pf.head_bwd_plan(tuple(acts), *widths)
    assert fn(code, *plan.widths) == plan.total


@pytest.mark.parametrize("c0", [36, 95, 97, 150])
def test_embed_bwd_plan_is_the_kernels_shared_memory(cuda, c0):
    """``embed_bwd_plan``'s total is the dynamic shared memory K4-bwd's
    entry point gives a block for rows of ``c0`` values (the kernel also
    checks its own carve against it at every launch)."""
    import ctypes

    fn = _build.library().wcmc_pathnet_embed_bwd_smem
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_longlong
    assert fn(c0) == pf.embed_bwd_plan(c0).total


# K4-fwd's tiled body: (activations, (C0, C1, C2, C3)) of Multisteps'
# embedding, KPCN's merged PathNet and the 64-wide PathNet at their path widths
EMBED_FWD_FORMS = {"multisteps": (LEAKY3, (95, 128, 128, 128)),
                   "kpcn": (pf.EMBED_ACTS, (36, 128, 128, 128)),
                   "pathnet64": (pf.EMBED_ACTS, (36, 64, 64, 64))}


def _embed_fwd_case(cuda, acts, dims, b, s, hw, seed):
    g = _gen(seed)
    x = torch.randn((b, s, hw, dims[0]), device=cuda, generator=g).to(torch.bfloat16)
    ws = [torch.randn((ci, co), device=cuda, generator=g) / ci**0.5
          for ci, co in zip(dims[:-1], dims[1:])]
    bs = [0.1 * torch.randn(co, device=cuda, generator=g) for co in dims[1:]]
    return x, ws, bs


def _check_embed_tiled(cuda, form, acts, dims, b, s, hw, seed):
    x, ws, bs = _embed_fwd_case(cuda, acts, dims, b, s, hw, seed)
    assert pf.embed_fwd_plan(acts, *dims).form == form
    _build.reset_counts()
    e, mean = pf.pathnet_embed(x, ws, bs, acts)
    assert dict(_build.launches) == {"pathnet_embed": 1} and not _build.plain_calls
    assert e.dtype == torch.bfloat16 and tuple(e.shape) == (b, s, hw, dims[-1])
    assert mean.dtype == torch.float32 and tuple(mean.shape) == (b, hw, dims[-1])
    we, wm = pf._embed_plain(x, ws, bs, acts)
    _close(e, we, BF16_TOL)
    _close(mean, wm, BF16_TOL)
    again = pf.pathnet_embed(x, ws, bs, acts)
    assert torch.equal(again[0], e) and torch.equal(again[1], mean)
    rows = pf._embed_fwd_kernel(x, ws, bs, acts, rows=True)
    _close(rows[0], we, BF16_TOL)
    _close(rows[1], wm, BF16_TOL)
    assert torch.equal(rows[0], e) and torch.equal(rows[1], mean)


@pytest.mark.parametrize("form", list(EMBED_FWD_FORMS))
@pytest.mark.parametrize("b,s,hw", [(2, 3, 100), (8, 8, 16384), (1, 1, 64), (3, 2, 65),
                                    (1, 5, 1), (2, 3, 37), (2, 1, 200)])
def test_pathnet_embed_tiled(cuda, form, b, s, hw):
    """K4-fwd's tiled body in every form a path runs, at the path shape
    and beside it (x spans that do not start on 16 bytes: HW 37 at C0 36
    and 95, HW 100 at C0 95; a tail unit shorter than 64 pixels; one unit;
    one pixel; S = 1 and 3): within 2e-2 of max |plain| (bf16 hidden layers
    summed in another order), two launches bit for bit, and the row-chunk
    body's embedding and mean bit for bit (both sum every layer from zero
    in k16 steps, the bias after, and the mean in sample order)."""
    acts, dims = EMBED_FWD_FORMS[form]
    _check_embed_tiled(cuda, form, acts, dims, b, s, hw, 41)


@pytest.mark.parametrize("form,c0", [("multisteps", 36), ("multisteps", 96), ("kpcn", 95),
                                     ("kpcn", 1), ("kpcn", 48), ("pathnet64", 49),
                                     ("pathnet64", 17)])
def test_pathnet_embed_tiled_other_inputs(cuda, form, c0):
    """The tiled forms at other input widths: C0 padded to 48 or 96 (even
    and odd C0, both landing-stage loads)."""
    acts, dims = EMBED_FWD_FORMS[form]
    _check_embed_tiled(cuda, form, acts, (c0, *dims[1:]), 2, 3, 300, 42)


def test_pathnet_embed_tiled_shares_the_pack_with_the_backward(cuda):
    """A forward and backward through autograd pack the embedding once:
    the backward finds the forward's pack."""
    acts, dims = EMBED_FWD_FORMS["multisteps"]
    x, ws, bs = _embed_fwd_case(cuda, acts, dims, 2, 3, 100, 43)
    params = [t.clone().requires_grad_() for t in ws + bs]
    pf._packed.clear()
    e, mean = pf.pathnet_embed(x, params[:3], params[3:], acts)
    (e.float().sum() + mean.sum()).backward()
    assert (pf._packed.misses, pf._packed.hits) == (1, 1)
    pf._packed.clear()


@pytest.mark.parametrize("acts,dims", [
    (LEAKY3, (95, 128, 128, 128)), (LEAKY3, (36, 128, 128, 128)),
    (pf.EMBED_ACTS, (36, 128, 128, 128)), (pf.EMBED_ACTS, (95, 128, 128, 128)),
    (pf.EMBED_ACTS, (36, 64, 64, 64)), (pf.EMBED_ACTS, (96, 64, 64, 64)),
    (LEAKY3, (97, 128, 128, 128)), (pf.EMBED_ACTS, (36, 32, 32, 32))])   # the row-chunk body
def test_embed_fwd_plan_is_the_kernels_shared_memory(cuda, acts, dims):
    """``embed_fwd_plan``'s total is the dynamic shared memory K4-fwd's
    entry point gives a block of the form (the tiled kernel also checks its
    own carve against it at every launch)."""
    import ctypes

    fn = _build.library().wcmc_pathnet_embed_tiled_smem
    fn.argtypes, fn.restype = [ctypes.c_int] * 7, ctypes.c_longlong
    codes = [mf.ACTS.index(a) for a in acts]
    assert fn(*dims, *codes) == pf.embed_fwd_plan(acts, *dims).total


def _sbmc_step_setup(cuda, b, patch):
    import numpy as np

    from wcmc_tpu_torch.data.batches import synthetic_batch
    from wcmc_tpu_torch.train.factory import TrainConfig, init_interfaces

    cfg = TrainConfig(base_model="sbmc", use_llpm_buf=True, manif_learn=True,
                      manif_loss="FMSE")
    card = init_interfaces(cfg, device=cuda)[0]
    batch = synthetic_batch(np.random.default_rng(0), "sbmc", b, patch, 8, True)
    card.to_train_mode()
    draws = card.draw_pairings((b, 8, patch, patch, card.models["backbone"].outc))
    return cfg, card, batch, draws


SBMC_STEP_LAUNCHES = {"pathnet_embed": 2, "pathnet_embed_bwd": 2, "pathnet_head": 4,
                      "pathnet_head_bwd": 4, "scatter": 1, "outer": 1}


def test_sbmc_train_batch_on_the_card_matches_the_cpu(cuda):
    """One bf16 SBMC + manifold train step on the card (K4 and K5 forward
    and backward in the PathNet's and Multisteps' forms, K7, K8) against
    the same fresh weights, batch (2 patches of 32 px, 8 spp) and draws
    on the CPU (every plain version), with exact launch counts: the
    radiance is data, so the splat's d(x) (K9) does not run.  bf16 SBMC
    is sensitive to rounding: the gain-10 logit standardization amplifies
    it before exp, more at this size than at the flagship's.  Measured
    on an H100: losses within 1.49e-2 relative (rmse), gradient cosine
    0.99046 (Multisteps) and 0.99454 (PathNet), norm ratio 1 +- 0.083;
    held to about 2.5x: 3.7e-2, 0.976 and 0.21."""
    from wcmc_tpu_torch import convert
    from wcmc_tpu_torch.train.factory import init_interfaces

    cfg, card, batch, draws = _sbmc_step_setup(cuda, 2, 32)
    cpu = init_interfaces(cfg, device="cpu")[0]
    for name, m in card.models.items():
        convert.load_flax_params(cpu.models[name], convert.to_flax(m))
    cpu.to_train_mode()
    card.preprocess(batch)
    cpu.preprocess(batch)
    _build.reset_counts()
    ld_card = card.train_batch(batch, grad_hook_mode=True, draws=draws)
    assert dict(_build.launches) == SBMC_STEP_LAUNCHES and not _build.plain_calls
    ld_cpu = cpu.train_batch(batch, grad_hook_mode=True, draws=draws)
    measured = {k: abs(float(ld_card[k]) - float(v)) / abs(float(v)) for k, v in ld_cpu.items()}
    for name, m in card.models.items():
        a = torch.cat([p.grad.flatten().double().cpu() for p in m.parameters()])
        b = torch.cat([p.grad.flatten().double() for p in cpu.models[name].parameters()])
        assert bool(torch.isfinite(a).all())
        measured[name] = (float(a @ b / (a.norm() * b.norm())), float(a.norm() / b.norm()))
    print(measured)
    for k in ld_cpu:
        assert measured[k] <= 3.7e-2, (k, measured)
    for name in card.models:
        cos, ratio = measured[name]
        assert cos >= 0.976 and abs(ratio - 1) <= 0.21, (name, measured)


def test_sbmc_train_batch_repeats_bit_for_bit(cuda):
    """The same SBMC step three times from the same weights, batch and
    draws gives the same gradients bit for bit: every kernel writes each
    output once or sums in a fixed order (K8 writes each weight gradient
    once; K4-bwd and K5-bwd sum their partials in block order)."""
    _, iface, batch, draws = _sbmc_step_setup(cuda, 4, 64)
    batch = {k: v.to(cuda) for k, v in batch.items()}
    grads = []
    for _ in range(3):
        iface.preprocess(batch)
        _build.reset_counts()
        iface.train_batch(batch, grad_hook_mode=True, draws=draws)
        assert dict(_build.launches) == SBMC_STEP_LAUNCHES
        grads.append([p.grad.clone() for m in iface.models.values() for p in m.parameters()])
    for other in grads[1:]:
        assert all(torch.equal(a, b) for a, b in zip(grads[0], other))


# ---------------------------------------------------------------------------
# The fused convolution K6 (the opt-in fused KPCN inference)
# ---------------------------------------------------------------------------

# of max |plain|: the same bf16 products summed in f32 in another order,
# rounded once; a sum on a rounding boundary can go to the neighbouring
# bf16 value, one step being at most 2^-7 of a value (so of max |plain|)
CONV_TOL = 8e-3


def _conv_case(cuda, b, h, w, cin, cout, k, seed):
    g = _gen(seed)
    x = torch.randn((b, h, w, cin), device=cuda, generator=g).to(torch.bfloat16)
    wgt = torch.randn((k, k, cin, cout), device=cuda, generator=g) / (k * k * cin) ** 0.5
    bias = 0.1 * torch.randn(cout, device=cuda, generator=g)
    return x, wgt, bias


@pytest.mark.parametrize("b,h,w,cin,cout,k,act", [
    (8, 128, 128, 39, 100, 5, "relu"),      # KPCN layer 1 with paths (n_in 39)
    (8, 96, 96, 100, 441, 5, None),         # KPCN layer 9: the 441 kernel logits
    (2, 260, 300, 34, 100, 5, "relu"),      # layer 1 without paths, a wide frame
    (3, 21, 37, 100, 100, 5, "leaky_relu"), # partial tiles in rows and columns
    (2, 19, 23, 7, 9, 3, "linear"),         # 3x3, narrow odd channel counts
    (1, 40, 40, 200, 130, 5, "relu"),       # two input chunks, two output slices
    (1, 30, 34, 151, 60, 5, "relu"),        # two input chunks of an odd Cin
    # Cout at the pass boundaries (passes of 104 channels up to 104, of 224
    # above) and Cin % 8 in {0, 2, 7}
    (1, 20, 36, 48, 104, 5, "relu"),        # one full 104-channel pass
    (1, 22, 34, 50, 105, 5, "relu"),        # one past it: a 224-channel pass
    (2, 19, 40, 23, 224, 5, None),          # one full 224-channel pass
    (1, 24, 20, 100, 225, 5, "leaky_relu"), # two passes, the second of one channel
    (1, 17, 33, 64, 448, 5, None),          # two full passes
    (1, 21, 18, 40, 449, 3, "relu"),        # three passes
])
def test_conv5(cuda, b, h, w, cin, cout, k, act):
    from wcmc_tpu_torch.ops import conv5

    x, wgt, bias = _conv_case(cuda, b, h, w, cin, cout, k, 7)
    _build.reset_counts()
    got = conv5.conv2d(x, wgt, bias, k, act)
    assert dict(_build.launches) == {"conv5": 1} and not _build.plain_calls
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert tuple(got.shape) == (b, h - k + 1, w - k + 1, cout)
    _close(got, conv5.conv2d_plain(x, wgt, bias, k, act), CONV_TOL)
    # no split reduction, no atomics: a second launch gives the same bits
    torch.testing.assert_close(conv5.conv2d(x, wgt, bias, k, act), got, rtol=0, atol=0)


def test_conv5_padded_chain(cuda):
    """The fused chain's layouts: layer 1's 39 channels copied once to a
    pitch of 40, hidden layers written at a pitch of 104 (pad channels
    zero) and read by the next launch as that strided view, the logits
    contiguous; each launch against the plain version on its own input,
    and bit for bit on a second launch."""
    from wcmc_tpu_torch.ops import conv5

    x, _, _ = _conv_case(cuda, 2, 44, 41, 39, 1, 5, 11)
    layers = [(39, 100, "relu"), (100, 100, "relu"), (100, 441, None)]
    h = x
    for i, (cin, cout, act) in enumerate(layers):
        _, wgt, bias = _conv_case(cuda, 1, 5, 5, cin, cout, 5, 12 + i)
        conv = conv5.conv2d_padded if act else conv5.conv2d
        _build.reset_counts()
        got = conv(h, wgt, bias, 5, act)
        assert dict(_build.launches) == {"conv5": 1} and not _build.plain_calls
        pitch = 104 if act else 441
        assert got.stride()[2:] == (pitch, 1) and got.shape[-1] == cout
        if act:
            assert not got._base[..., cout:].any()
        _close(got, conv5.conv2d_plain(h, wgt, bias, 5, act), CONV_TOL)
        torch.testing.assert_close(conv(h, wgt, bias, 5, act), got, rtol=0, atol=0)
        h = got
    assert h.is_contiguous()


def test_conv5_refuses_what_it_does_not_compute(cuda):
    from wcmc_tpu_torch.ops import conv5

    x, wgt, bias = _conv_case(cuda, 1, 12, 12, 8, 16, 5, 8)
    with pytest.raises(ValueError, match="bfloat16"):
        conv5.conv2d(x.float(), wgt, bias, 5, "relu")
    with pytest.raises(ValueError, match="activations"):
        conv5.conv2d(x, wgt, bias, 5, "elu")
    with pytest.raises(ValueError, match="weight"):
        conv5.conv2d(x[..., :4], wgt, bias, 5, None)
    with pytest.raises(ValueError, match="smaller"):
        conv5.conv2d(x[:, :3], wgt, bias, 5, None)
    with pytest.raises(ValueError, match="one CUDA device"):
        conv5.conv2d(x, wgt.cpu(), bias, 5, None)


def test_conv5_backward_uses_library_convolutions(cuda):
    """The VJP on the card (library d(x) and d(w), as the reference keeps
    its backward in XLA) against the same VJP of the plain version on the
    CPU, in bf16."""
    from wcmc_tpu_torch.ops import conv5

    x, wgt, bias = _conv_case(cuda, 2, 24, 20, 39, 100, 5, 9)
    cot = torch.randn((2, 20, 16, 100), device=cuda, generator=_gen(10))
    grads = []
    for dev in (cuda, torch.device("cpu")):
        xs, ws, bs = (t.to(dev).detach().requires_grad_() for t in (x, wgt, bias))
        torch.autograd.backward(conv5.conv2d(xs, ws, bs, 5, "relu"), cot.to(dev))
        grads.append([xs.grad, ws.grad, bs.grad])
    for got, want in zip(*grads):
        assert got.dtype == want.dtype
        _close(got.cpu(), want, 2e-2)


def test_fused_kpcn_tile_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """The README flagship (KPCN k21 d9 w100 + dual PathNet) served fused
    (``WCMC_FUSED_INFERENCE=1``) on the card, on 2 tiles of 128 px at 8
    spp: 18 launches of K6, 2 of K1 and one each of K4-fwd and K5-fwd, no
    plain call; against the same fresh weights served fused on the CPU in
    bf16, within 1e-2 of max |ref|, as ``chip_smoke.py`` holds a served
    tile (SERVE_BF16_TOL)."""
    import numpy as np

    from wcmc_tpu_torch import convert
    from wcmc_tpu_torch.data.batches import synthetic_batch
    from wcmc_tpu_torch.train.factory import TrainConfig, init_interfaces

    monkeypatch.setenv("WCMC_FUSED_INFERENCE", "1")
    cfg = TrainConfig(kpcn_ksize=21, use_llpm_buf=True)
    card = init_interfaces(cfg, device=cuda)[0]
    cpu = init_interfaces(cfg, device="cpu")[0]
    for name, m in card.models.items():
        convert.load_flax_params(cpu.models[name], convert.to_flax(m))
    batch = synthetic_batch(np.random.default_rng(1), "kpcn", 2, 128, 8, True)
    card.to_eval_mode()
    cpu.to_eval_mode()
    _build.reset_counts()
    rad, p = card.validate_batch(batch)
    assert dict(_build.launches) == {"conv5": 18, "gather_softmax": 2, "pathnet_embed": 1,
                                     "pathnet_head": 1}
    assert not _build.plain_calls
    ref_rad, ref_p = cpu.validate_batch(batch)
    _close(rad.cpu(), ref_rad, 1e-2)
    for k in ref_p:
        _close(p[k].cpu(), ref_p[k], 1e-2)
