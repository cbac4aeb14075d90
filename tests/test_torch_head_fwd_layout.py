"""What surrounds K5-fwd (the PathNet / Multisteps head forward) on the
card, on the CPU: its plan (which body runs a form, the tile and the
shared memory per form), a plain walk of the tiled body's order of
products and moment sums, and the pack it shares with K5-bwd.

* The plan: each form at its path widths fits the 227 KB a block may opt
  into; the three forms the models run take the tiled body, everything
  else the wmma body, and what neither computes is refused.
* The walk against ``_head_plain`` in f32 within 1e-5 (absolute, every
  value O(1)): only the order of the f32 sums differs.  On inputs whose
  every product and sum is exact in f32 (few mantissa bits, no negative
  layer-1 pre-activation for the leaky form) the walk's output equals
  the plain version's bit for bit, and its moments equal the sample-order
  sums of that output bit for bit.
* The walk against ``wcmc_tpu``'s ``_head_fwd_pallas`` (interpreted) in
  bf16 within 2e-2 of max |ref| (a product summed in another order can
  round to the neighbouring bf16 value at h1) and ``_head_xla`` in f32
  within 1e-5 of max |ref| (other summation order).
* A train step's forward packs the head once and its backward finds that
  pack (the cache's hit count).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wcmc_tpu_torch.ops import pathnet_fused as pf

jpf = importlib.import_module("wcmc_tpu.ops.pathnet_fused")
jmf = importlib.import_module("wcmc_tpu.ops.mlp_fused")
jpk = importlib.import_module("wcmc_tpu.ops.pallas_kernels")

WALK_ATOL, F32_TOL, BF16_TOL = 1e-5, 1e-5, 2e-2
LEAKY2 = pf.LEAKY[:2]
BF, F32 = torch.bfloat16, torch.float32
# (activations, (Ce = Cc, C1, Cout), output dtype): the three forms the
# models run (Multisteps' update chain, KPCN's merged head, the 64-wide head)
FORMS = {"multisteps": (LEAKY2, (128, 128, 128), BF),
         "kpcn": (pf.HEAD_ACTS, (128, 256, 6), F32),
         "pathnet64": (pf.HEAD_ACTS, (64, 128, 3), F32)}


def _case(b, s, hw, ce, c1, cout, seed, exact=False):
    """e, ctx, ws, bs; with ``exact``, values of few mantissa bits whose
    products and sums are exact in f32, layer 1's inputs non-negative."""
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0):
        if exact:
            return torch.from_numpy(rng.integers(0, 5, shape).astype(np.float32) * scale)
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))

    e = f(b, s, hw, ce, scale=0.25)
    ctx = f(b, hw, ce, scale=0.25)
    ws = [f(2 * ce, c1, scale=1 / 64 if exact else (2 * ce) ** -0.5),
          f(c1, cout, scale=1 / 64 if exact else c1 ** -0.5)]
    if exact:   # the second layer signed, so the leaky form takes both slopes
        ws[1] = ws[1] - 2 / 64
    bs = [f(c1, scale=1 / 8 if exact else 0.1), f(cout, scale=1 / 8 if exact else 0.1) - 0.25]
    return e, ctx, ws, bs


@pytest.mark.parametrize("form,cmajor", [("multisteps", False), ("kpcn", False),
                                         ("kpcn", True), ("pathnet64", False),
                                         ("pathnet64", True)])
def test_plan_fits_the_tiled_forms(form, cmajor):
    acts, (ce, c1, cout), dtype = FORMS[form]
    plan = pf.head_fwd_plan(acts, ce, ce, c1, cout, dtype, cmajor)
    assert plan.tiled and plan.form == form
    assert plan.total == sum(n for _, n in plan.smem) <= pf.SMEM_LIMIT
    assert all(n % 128 == 0 for _, n in plan.smem)
    sizes = dict(plan.smem)
    # 64 pixels x 1 sample a product (a wgmma's m64), two walkers a block,
    # each with its own ring of blocked e / context tiles
    assert (plan.pix, plan.workers) == (64, 2)
    assert sizes["ring"] == 2 * plan.stages * 64 * 2 * ce and plan.stages >= 2
    assert sizes["w1e"] == 2 * ce * c1
    assert sizes["h"] >= 2 * 2 * 64 * c1
    if form == "multisteps":   # ctx . W1c + b1 in f32 a walker; the output staged over h1
        assert sizes["zc"] == 2 * 4 * 64 * c1 and sizes["h"] >= 2 * 2 * 64 * (128 + 8)
    else:                      # PathNet: in registers; f32 output and moment stages
        assert sizes["zc"] == 0 and sizes["out"] > 0 and sizes["moments"] > 0


@pytest.mark.parametrize("acts,dims,dtype,cmajor", [
    (LEAKY2, (128, 128, 128, 128), F32, False),     # Multisteps with an f32 output
    (LEAKY2, (128, 128, 128, 128), BF, True),       # ... channel-major
    (LEAKY2, (64, 32, 96, 96), BF, False),          # narrower
    (pf.HEAD_ACTS, (32, 32, 64, 6), F32, False),    # other PathNet widths
    (pf.HEAD_ACTS, (128, 128, 256, 32), F32, False),  # Cout above 16
    (("relu", "linear"), (128, 128, 256, 6), F32, False),
])
def test_plan_keeps_the_wmma_body(acts, dims, dtype, cmajor):
    plan = pf.head_fwd_plan(acts, *dims, dtype, cmajor)
    assert not plan.tiled and plan.form is None and plan.pix == 32
    assert plan.total == sum(n for _, n in plan.smem) <= pf.SMEM_LIMIT


@pytest.mark.parametrize("acts,dims,dtype,err", [
    (pf.HEAD_ACTS, (128, 128, 256, 17), F32, ValueError),   # Cout 17: not a multiple of 16
    (pf.HEAD_ACTS, (128, 128, 256, 144), F32, ValueError),  # above 128
    (pf.HEAD_ACTS, (120, 128, 256, 6), F32, ValueError),    # Ce not a multiple of 16
    (("relu", "gelu"), (128, 128, 256, 6), F32, ValueError),
    (pf.HEAD_ACTS, (128, 128, 256, 6), torch.float16, TypeError),
    (LEAKY2, (512, 512, 512, 128), BF, ValueError),         # the wmma body's tiles outgrow 227 KB
])
def test_plan_refuses(acts, dims, dtype, err):
    with pytest.raises(err):
        pf.head_fwd_plan(acts, *dims, dtype)


@pytest.mark.parametrize("moments", [False, True])
@pytest.mark.parametrize("form,cmajor,s", [("multisteps", False, 3), ("kpcn", False, 2),
                                           ("kpcn", True, 4), ("pathnet64", False, 3),
                                           ("pathnet64", True, 2)])
def test_walk_matches_plain(form, cmajor, s, moments):
    """HW 100: a whole 64-pixel unit and a ragged one; f32 throughout."""
    acts, (ce, c1, cout), _ = FORMS[form]
    e, ctx, ws, bs = _case(2, s, 100, ce, c1, cout, 11)
    got = pf._head_fwd_walk(e, ctx, ws, bs, acts, moments, cmajor, F32, n_blocks=2)
    want = pf._head_plain(e, ctx, ws, bs, acts, moments, cmajor, F32)
    got, want = (got, want) if moments else ((got,), (want,))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        torch.testing.assert_close(g, w, rtol=0, atol=WALK_ATOL)


@pytest.mark.parametrize("form,cmajor", [("multisteps", False), ("kpcn", True),
                                         ("pathnet64", False)])
def test_walk_is_exact_on_exact_inputs(form, cmajor):
    """Every product and sum exact: the walk's order cannot show, so its
    output is the plain one bit for bit and its moments are the
    sample-order sums of that output (zero first, then sample 0, 1, ...)."""
    acts, (ce, c1, cout), dtype = FORMS[form]
    b, s, hw = 2, 4, 100
    e, ctx, ws, bs = _case(b, s, hw, ce, c1, cout, 5, exact=True)
    out, ssum, ssq = pf._head_fwd_walk(e, ctx, ws, bs, acts, True, cmajor, dtype, n_blocks=1)
    want = pf._head_plain(e, ctx, ws, bs, acts, True, cmajor, dtype)
    assert torch.equal(out, want[0]) and out.dtype == dtype
    # the unrounded f32 output, which the moments sum
    o = pf._head_plain(e, ctx, ws, bs, acts, False, False, F32)
    seq_sum, seq_sq = torch.zeros((b, hw, cout)), torch.zeros((b, hw, cout))
    for si in range(s):
        seq_sum, seq_sq = seq_sum + o[:, si], seq_sq + o[:, si] * o[:, si]
    assert torch.equal(ssum, seq_sum) and torch.equal(ssq, seq_sq)
    # both sides of the second activation occur
    assert torch.count_nonzero(o > 0) > 0
    assert torch.count_nonzero(o < 0 if acts == LEAKY2 else o == 0) > 0
    torch.testing.assert_close(ssum, want[1], rtol=1e-6, atol=1e-6)


def _pallas(fn, *args, **kw):
    jpk.INTERPRET, jmf.FORCE_PALLAS = True, True
    try:
        return fn(*args, **kw)
    finally:
        jpk.INTERPRET, jmf.FORCE_PALLAS = False, False


def _close(got, want, tol):
    got = np.asarray(torch.as_tensor(got).float(), np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want))


@pytest.mark.parametrize("form,cmajor", [("multisteps", False), ("pathnet64", True)])
def test_walk_matches_wcmc_tpu(form, cmajor):
    """The walk in bf16 against the Pallas head interpreted, and in f32
    against the XLA head, each with moments."""
    acts, (ce, c1, cout), dtype = FORMS[form]
    e, ctx, ws, bs = _case(1, 2, 72, ce, c1, cout, 9)
    jws, jbs = [jnp.asarray(w.numpy()) for w in ws], [jnp.asarray(b.numpy()) for b in bs]
    jdt = jnp.bfloat16 if dtype == BF else jnp.float32
    want = _pallas(jpf.pathnet_head, jnp.asarray(e.numpy(), jnp.bfloat16),
                   jnp.asarray(ctx.numpy()), jws, jbs, acts, True, jdt, cmajor)
    got = pf._head_fwd_walk(e.to(BF), ctx, ws, bs, acts, True, cmajor, dtype)
    for g, w in zip(got, want):
        _close(g, w, BF16_TOL)
    want = jpf._head_xla(jnp.asarray(e.numpy()), jnp.asarray(ctx.numpy()), jws, jbs, acts,
                         True, jnp.float32, cmajor)
    got = pf._head_fwd_walk(e, ctx, ws, bs, acts, True, cmajor, F32)
    for g, w in zip(got, want):
        _close(g, w, F32_TOL)


def test_forward_and_backward_share_the_pack(monkeypatch):
    """On the card a tiled forward packs the head through ``_packed_head``
    and the backward asks for the pack of the tensors autograd saved; here
    both sides ask the cache as the card path does before their plain
    versions run.  One step: one pack, one hit; after an optimizer's
    in-place update the next step packs anew."""
    acts, (ce, c1, cout), dtype = FORMS["multisteps"]
    e, ctx, ws, bs = _case(1, 2, 40, ce, c1, cout, 3)
    params = [torch.nn.Parameter(t) for t in ws + bs]
    plain_fwd, plain_bwd = pf._head_fwd, pf.pathnet_head_bwd

    def fwd(e, ctx, ws, bs, acts, moments, cmajor, out_dtype):
        if pf.head_fwd_plan(tuple(acts), e.shape[-1], ctx.shape[-1], ws[0].shape[1],
                            ws[1].shape[1], out_dtype, cmajor).tiled:
            pf._packed_head(ws, bs, acts, e.shape[-1])
        return plain_fwd(e, ctx, ws, bs, acts, moments, cmajor, out_dtype)

    def bwd(e, ctx, g, gsum, gsq, ws, bs, acts, cmajor):
        pf._packed_head(ws, bs, acts, e.shape[-1])
        return plain_bwd(e, ctx, g, gsum, gsq, ws, bs, acts, cmajor)

    monkeypatch.setattr(pf, "_head_fwd", fwd)
    monkeypatch.setattr(pf, "pathnet_head_bwd", bwd)
    pf._packed.clear()
    for step in range(2):
        out, ssum, _ = pf.pathnet_head(e.to(BF), ctx.to(BF), params[:2], params[2:], acts,
                                       moments=True, out_dtype=dtype)
        (out.float().sum() + ssum.sum()).backward()
        assert (pf._packed.misses, pf._packed.hits) == (step + 1, step + 1)
        with torch.no_grad():
            for p in params:
                p.sub_(1e-3 * p.grad)
                p.grad = None
    pf._packed.clear()


def test_chip_smoke_tells_the_bodies_apart():
    """``chip_smoke.py`` files K5-fwd's device entries by body and refuses
    a profile in which the wmma body ran, or the tiled body did not."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    tiled = "void wcmc::pathnet_head_tiled_kernel<128, 256, 16, 1, 2, float, -1>(wcmc::FwdArgs)"
    wmma = "void wcmc::pathnet_head_kernel<float, 1, 1, 16>(__nv_bfloat16 const*, int)"
    assert cs.device_kind(tiled) == "pathnet_head_tiled"
    assert cs.device_kind(wmma) == "pathnet_head"
    cs.check_head_body({"pathnet_head_tiled": 0.3, "pathnet_head_bwd": 1.0}, "serve")
    for kinds in ({"pathnet_head_tiled": 0.3, "pathnet_head": 0.1}, {"pathnet_head_bwd": 1.0}):
        with pytest.raises(AssertionError):
            cs.check_head_body(kinds, "serve")
