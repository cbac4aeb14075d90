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
max |d x|).  TF32 is off for every f32 product compared here."""

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
        pf.pathnet_embed(x.to(torch.bfloat16), ws, bs, ("relu", "relu", "relu"))


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


def _embed_case(cuda, b, s, hw, seed):
    g = _gen(seed)
    dims = (36, 128, 128, 128)
    x = torch.randn((b, s, hw, dims[0]), device=cuda, generator=g).to(torch.bfloat16)
    ws = [torch.randn((ci, co), device=cuda, generator=g) / ci**0.5
          for ci, co in zip(dims[:-1], dims[1:])]
    bs = [0.1 * torch.randn(co, device=cuda, generator=g) for co in dims[1:]]
    ge = torch.randn((b, s, hw, dims[-1]), device=cuda, generator=g).to(torch.bfloat16)
    gmean = torch.randn((b, hw, dims[-1]), device=cuda, generator=g)
    return x, ws, bs, ge, gmean


@pytest.mark.parametrize("b,s,hw", [(2, 3, 100), (1, 11, 40), (8, 8, 16384)])
def test_pathnet_embed_backward(cuda, b, s, hw):
    x, ws, bs, ge, gmean = _embed_case(cuda, b, s, hw, 4)
    _build.reset_counts()
    _, dws, dbs = pf.pathnet_embed_bwd(x, ge, gmean, ws, bs)
    assert _build.launches["pathnet_embed_bwd"] == 1 and not _build.plain_calls
    _, wdws, wdbs = pf._embed_bwd_plain(x, ge, gmean, ws, bs, pf.EMBED_ACTS)
    for got, want in zip(dws + dbs, wdws + wdbs):
        assert got.dtype == torch.float32
        _close(got, want, BF16_TOL)
    # through autograd: weights that require grad launch K4-bwd
    params = [w.clone().requires_grad_() for w in ws + bs]
    e, mean = pf.pathnet_embed(x, params[:3], params[3:])
    _build.reset_counts()
    grads = torch.autograd.grad([e, mean], params, [ge, gmean])
    assert _build.launches["pathnet_embed_bwd"] == 1
    for got, want in zip(grads, dws + dbs):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def _head_case(cuda, b, s, hw, seed):
    g = _gen(seed)
    ce = cc = 128
    e = torch.randn((b, s, hw, ce), device=cuda, generator=g).to(torch.bfloat16)
    ctx = torch.randn((b, hw, cc), device=cuda, generator=g).to(torch.bfloat16)
    ws = [torch.randn((ce + cc, 256), device=cuda, generator=g) / 16.0,
          torch.randn((256, 6), device=cuda, generator=g) / 16.0]
    bs = [0.1 * torch.randn(256, device=cuda, generator=g),
          0.1 * torch.randn(6, device=cuda, generator=g)]
    cot = [torch.randn((b, s, 6, hw), device=cuda, generator=g),
           torch.randn((b, hw, 6), device=cuda, generator=g),
           0.1 * torch.randn((b, hw, 6), device=cuda, generator=g)]
    return e, ctx, ws, bs, cot


@pytest.mark.parametrize("b,s,hw", [(2, 3, 100), (1, 11, 40), (8, 8, 16384)])
def test_pathnet_head_backward(cuda, b, s, hw):
    e, ctx, ws, bs, (g, gsum, gsq) = _head_case(cuda, b, s, hw, 5)
    _build.reset_counts()
    got = pf.pathnet_head_bwd(e, ctx, g, gsum, gsq, ws, bs, cmajor=True)
    assert _build.launches["pathnet_head_bwd"] == 1 and not _build.plain_calls
    want = pf._head_bwd_plain(e, ctx, g, gsum, gsq, ws, bs, pf.HEAD_ACTS, cmajor=True)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    _close_l2(got[0], want[0], 1e-2)
    _close_l2(got[1], want[1], 1e-2)
    for gt, wt in zip([*got[2], *got[3]], [*want[2], *want[3]]):
        _close(gt, wt, BF16_TOL)
    # the channels-last cotangent gives the same gradients
    flat = pf.pathnet_head_bwd(e, ctx, g.transpose(2, 3).contiguous(), gsum, gsq, ws, bs)
    for gt, wt in zip(flat[2] + flat[3], got[2] + got[3]):
        torch.testing.assert_close(gt, wt, rtol=0, atol=0)


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
