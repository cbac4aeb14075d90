"""Each hand-written CUDA kernel against its plain PyTorch version, on the
card (marked ``gpu``; skips without one).  Runs without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py

Tolerances (of max |plain|): K1 1e-5 — both read the same logits and
run the softmax in f32, only the summation order differs; K4/K5 2e-2 —
bf16 hidden layers summed in another order can round to a neighbouring
bf16 value.  TF32 is off for every f32 product compared here."""

import pytest
import torch

from wcmc_tpu_torch.ops import _build
from wcmc_tpu_torch.ops import kernel_apply as ka
from wcmc_tpu_torch.ops import pathnet_fused as pf

pytestmark = pytest.mark.gpu

K1_TOL, BF16_TOL = 1e-5, 2e-2


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
