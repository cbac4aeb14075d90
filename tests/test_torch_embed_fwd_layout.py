"""What surrounds K4-fwd (the PathNet / Multisteps embedding forward) on
the card, on the CPU: its plan (which body runs a form, the tile and the
shared memory per form), a plain walk of the tiled body's order of
products and mean sums, and the pack it shares with K4-bwd.

* The plan: each tiled form fits the 227 KB a block may opt into, in
  128-byte pieces; the three forms the models run take the tiled body at
  any C0 up to 96, everything else the row-chunk body, and what neither
  computes is refused.
* The walk against ``_embed_plain`` in f32 within 1e-5 (absolute, every
  value O(1)): only the order of the f32 sums differs.  On inputs whose
  every product and sum is exact in f32 (few mantissa bits) the walk's
  embedding equals the plain version's bit for bit, and its mean equals
  the sample-order sum of f32(e) * (1 / S), which at S = 4 is the plain
  mean, bit for bit.
* The walk in bf16 against ``wcmc_tpu``'s ``_embed_fwd_pallas``
  (interpreted) within 2e-2 of max |ref| (a product summed in another
  order can round to the neighbouring bf16 value at a hidden layer).
* A train step's forward packs the embedding once and its backward finds
  that pack (the cache's hit count).
* ``chip_smoke.py`` tells K4-fwd's two bodies apart in a profile.
"""

import importlib
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wcmc_tpu_torch.ops import pathnet_fused as pf

jpf = importlib.import_module("wcmc_tpu.ops.pathnet_fused")
jpk = importlib.import_module("wcmc_tpu.ops.pallas_kernels")

WALK_ATOL, BF16_TOL = 1e-5, 2e-2
BF, F32 = torch.bfloat16, torch.float32
# (activations, (C0, C1 = C2 = C3)) of the three forms the models run at
# their path widths: Multisteps' embedding, KPCN's merged PathNet
# branches, the 64-wide PathNet
FORMS = {"multisteps": (pf.LEAKY, (95, 128)),
         "kpcn": (pf.EMBED_ACTS, (36, 128)),
         "pathnet64": (pf.EMBED_ACTS, (36, 64))}


def _dims(form, c0=None):
    acts, (f_c0, c) = FORMS[form]
    return acts, (c0 or f_c0, c, c, c)


def _case(acts, dims, b, s, hw, seed, exact=False):
    """x, ws, bs; with ``exact``, values of few mantissa bits whose
    products and sums are exact in f32: x, W0 and the hidden biases
    non-negative (so Multisteps' hidden layers, which feed products, never
    take the 0.01 slope), W2 and b2 signed (both sides of the last
    activation), and PathNet's W1 signed (relu's zero side, exact)."""
    rng = np.random.default_rng(seed)
    if exact:
        def f(*shape, scale=1.0):
            return torch.from_numpy(rng.integers(0, 3, shape).astype(np.float32) * scale)
        x = f(b, s, hw, dims[0], scale=0.25)
        ws = [f(ci, co, scale=1 / 32) for ci, co in zip(dims[:-1], dims[1:])]
        bs = [f(co, scale=1 / 8) for co in dims[1:]]
        ws[2], bs[2] = ws[2] - 1 / 32, bs[2] - 1 / 8
        if acts == pf.EMBED_ACTS:
            ws[1] = ws[1] - 1 / 32
        return x, ws, bs

    def g(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))
    x = g(b, s, hw, dims[0])
    ws = [g(ci, co, scale=ci ** -0.5) for ci, co in zip(dims[:-1], dims[1:])]
    bs = [g(co, scale=0.1) for co in dims[1:]]
    return x, ws, bs


@pytest.mark.parametrize("form,c0", [("multisteps", 95), ("multisteps", 36), ("kpcn", 36),
                                     ("kpcn", 95), ("kpcn", 1), ("pathnet64", 36),
                                     ("pathnet64", 96), ("pathnet64", 49)])
def test_plan_fits_the_tiled_forms(form, c0):
    acts, dims = _dims(form, c0)
    plan = pf.embed_fwd_plan(acts, *dims)
    assert plan.tiled and plan.form == form
    assert plan.total == sum(n for _, n in plan.smem) <= pf.SMEM_LIMIT
    assert all(n % 128 == 0 for _, n in plan.smem)
    sizes = dict(plan.smem)
    c = dims[1]
    # C0 padded as K4-bwd's pack pads W0; 64 pixels x 1 sample a product
    # (a wgmma's m64), two walkers a block, each with its own ring of x
    # spans and two staged e tiles
    assert plan.k0 == (48 if c0 <= 48 else 96) == pf.embed_bwd_plan(c0).k0
    assert (plan.pix, plan.workers, plan.stages) == (64, 2, 4 if plan.k0 == 48 else 3)
    assert sizes["w0"] == 2 * plan.k0 * 128 and sizes["w1"] == sizes["w2"] == 2 * c * 128
    assert sizes["ring"] == 2 * plan.stages * 2 * 64 * plan.k0
    assert sizes["e"] == 2 * 2 * 2 * 64 * c


@pytest.mark.parametrize("acts,dims", [
    (pf.LEAKY, (97, 128, 128, 128)),                      # C0 above 96
    (pf.EMBED_ACTS, (150, 128, 128, 128)),
    (pf.LEAKY, (36, 64, 64, 64)),                         # leaky at 64 wide
    (pf.EMBED_ACTS, (36, 32, 32, 32)),                    # other widths
    (pf.EMBED_ACTS, (36, 128, 64, 128)),
    (pf.EMBED_ACTS, (36, 96, 96, 96)),
    (("relu", "relu", "relu"), (36, 128, 128, 128)),      # other activations
    (("linear", "leaky_relu", "relu"), (95, 128, 128, 128)),
])
def test_plan_keeps_the_row_chunk_body(acts, dims):
    plan = pf.embed_fwd_plan(acts, *dims)
    assert not plan.tiled and plan.form is None and plan.pix == 64
    assert plan.k0 == -(-dims[0] // 16) * 16
    assert plan.total == sum(n for _, n in plan.smem) <= pf.SMEM_LIMIT
    assert all(n % 128 == 0 for _, n in plan.smem)


@pytest.mark.parametrize("acts,dims", [
    (("relu", "gelu", "linear"), (36, 128, 128, 128)),   # an activation neither body has
    (pf.EMBED_ACTS, (36, 120, 128, 128)),                # C1 not a multiple of 16
    (pf.EMBED_ACTS, (0, 128, 128, 128)),                 # no input
    (pf.LEAKY, (95, 512, 512, 512)),                     # the row-chunk tiles outgrow 227 KB
])
def test_plan_refuses(acts, dims):
    with pytest.raises(ValueError):
        pf.embed_fwd_plan(acts, *dims)


@pytest.mark.parametrize("form,s", [("multisteps", 3), ("multisteps", 1), ("kpcn", 2),
                                    ("kpcn", 4), ("pathnet64", 3), ("pathnet64", 2)])
def test_walk_matches_plain(form, s):
    """HW 100: a whole 64-pixel unit and a ragged one; f32 throughout."""
    acts, dims = _dims(form)
    x, ws, bs = _case(acts, dims, 2, s, 100, 11)
    got = pf._embed_fwd_walk(x, ws, bs, acts, n_blocks=2)
    want = pf._embed_plain(x, ws, bs, acts)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        torch.testing.assert_close(g, w, rtol=0, atol=WALK_ATOL)


@pytest.mark.parametrize("form", list(FORMS))
def test_walk_is_exact_on_exact_inputs(form):
    """Every product and sum exact: the walk's order cannot show, so its
    embedding is the plain one bit for bit, and its mean is the
    sample-order sum of f32(e) / S (the first sample taken as it is), here
    at S = 4 also the plain mean bit for bit."""
    acts, dims = _dims(form)
    b, s, hw = 2, 4, 100
    x, ws, bs = _case(acts, dims, b, s, hw, 5, exact=True)
    e, mean = pf._embed_fwd_walk(x, ws, bs, acts, n_blocks=1)
    want_e, want_mean = pf._embed_plain(x, ws, bs, acts)
    # the precondition: every layer's f32 sum is its f64 sum
    h = x
    for w, v, a in zip(ws, bs, acts):
        z = h @ w + v
        assert torch.equal(z.double(), h.double() @ w.double() + v.double())
        h = pf._act(a, z)
    assert torch.equal(e, want_e) and e.dtype == F32
    seq = e[:, 0] * 0.25
    for si in range(1, s):
        seq = seq + e[:, si] * 0.25
    assert torch.equal(mean, seq) and torch.equal(mean, want_mean)
    # both sides of the last activation occur
    assert torch.count_nonzero(e > 0) > 0 and torch.count_nonzero(e < 0) > 0


def _pallas_embed(x, ws, bs, acts):
    jpk.INTERPRET = True
    try:
        return jpf._embed_fwd_pallas(x, ws, bs, acts)
    finally:
        jpk.INTERPRET = False


def _close(got, want, tol):
    got = np.asarray(torch.as_tensor(got).float(), np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want))


@pytest.mark.parametrize("form", ["multisteps", "pathnet64"])
def test_walk_matches_wcmc_tpu(form):
    """The walk in bf16 against the Pallas embedding interpreted."""
    acts, dims = _dims(form)
    x, ws, bs = _case(acts, dims, 1, 3, 72, 9)
    want = _pallas_embed(jnp.asarray(x.numpy(), jnp.bfloat16), [jnp.asarray(w.numpy()) for w in ws],
                         [jnp.asarray(v.numpy()) for v in bs], acts)
    got = pf._embed_fwd_walk(x.to(BF), ws, bs, acts)
    assert got[0].dtype == BF and got[1].dtype == F32
    for g, w in zip(got, want):
        _close(g, w, BF16_TOL)


def test_forward_and_backward_share_the_pack(monkeypatch):
    """On the card a tiled forward packs the embedding through
    ``_packed_embed`` and the backward asks for the pack of the tensors
    autograd saved; here both sides ask the cache as the card path does
    before their plain versions run.  One step: one pack, one hit; after an
    optimizer's in-place update the next step packs anew."""
    acts, dims = _dims("multisteps")
    x, ws, bs = _case(acts, dims, 1, 2, 40, 3)
    params = [torch.nn.Parameter(t) for t in ws + bs]
    plain_fwd, plain_bwd = pf._embed_fwd, pf.pathnet_embed_bwd

    def fwd(x, ws, bs, acts):
        if pf.embed_fwd_plan(tuple(acts), x.shape[-1], *(w.shape[1] for w in ws)).tiled:
            pf._packed_embed(ws, bs)
        return plain_fwd(x, ws, bs, acts)

    def bwd(x, ge, gmean, ws, bs, acts, compute_dx):
        pf._packed_embed(ws, bs)
        return plain_bwd(x, ge, gmean, ws, bs, acts, compute_dx)

    monkeypatch.setattr(pf, "_embed_fwd", fwd)
    monkeypatch.setattr(pf, "pathnet_embed_bwd", bwd)
    pf._packed.clear()
    for step in range(2):
        e, mean = pf.pathnet_embed(x.to(BF), params[:3], params[3:], acts)
        (e.float().sum() + mean.sum()).backward()
        assert (pf._packed.misses, pf._packed.hits) == (step + 1, step + 1)
        with torch.no_grad():
            for p in params:
                p.sub_(1e-3 * p.grad)
                p.grad = None
    pf._packed.clear()


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_chip_smoke_tells_the_bodies_apart():
    """``chip_smoke.py`` files K4-fwd's device entries by body (and apart
    from K4-bwd's) and refuses a profile in which the row-chunk body ran,
    or the tiled body did not."""
    cs = _chip_smoke()
    tiled = "void wcmc::pathnet_embed_tiled_kernel<96, 128, 2, 2, 2, 3>(wcmc::EmbedFwdArgs)"
    rows = "void wcmc::pathnet_embed_kernel<1, 1, 0>(__nv_bfloat16 const*, int, wcmc::EmbedDims)"
    bwd = "void wcmc::pathnet_embed_bwd_kernel<96, 2, 2, 2, true, false>(wcmc::EmbedBwdArgs)"
    assert cs.device_kind(tiled) == "pathnet_embed_tiled"
    assert cs.device_kind(rows) == "pathnet_embed"
    assert cs.device_kind(bwd) == "pathnet_embed_bwd"
    cs.check_embed_body({"pathnet_embed_tiled": 0.3, "pathnet_embed_bwd": 1.0}, "serve")
    for kinds in ({"pathnet_embed_tiled": 0.3, "pathnet_embed": 0.1},
                  {"pathnet_embed": 0.4}, {"pathnet_embed_bwd": 1.0}):
        with pytest.raises(AssertionError):
            cs.check_embed_body(kinds, "serve")


def test_chip_smoke_reads_device_time_by_kind():
    """``chip_smoke.py``'s ``device_ms`` takes the median over the calls of
    each call's device time in the entries of the named kinds (a call's
    entries summed, the calls in time order); entries of other kinds do not
    count, and a count that does not divide into the calls reads None."""
    cs = _chip_smoke()
    tiled = "void wcmc::pathnet_embed_tiled_kernel<48, 64, 1, 1, 0, 4>(wcmc::EmbedFwdArgs)"
    events = [(tiled, 40.0, 100.0), ("elementwise_kernel", 1.0, 50.0), (tiled, 0.0, 300.0),
              (tiled, 90.0, 200.0), ("void wcmc::reduce_parts_kernel(float const*)", 5.0, 9.0)]
    assert cs.median_device_ms(events, ("pathnet_embed_tiled",), 3) == 0.2
    assert cs.median_device_ms(events, ("pathnet_embed_tiled",), 1) == 0.6
    assert cs.median_device_ms(events, ("pathnet_embed_tiled",), 2) is None
    assert cs.median_device_ms(events, ("pathnet_embed",), 3) is None
