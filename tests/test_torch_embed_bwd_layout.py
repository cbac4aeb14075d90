"""What surrounds K4-bwd (the PathNet / Multisteps embedding backward) on
the card, on the CPU: the packed weight layout it reads, the cache that
packs an embedding once per parameter value, its plan (tile, stages and
shared memory per input width), and a plain walk of the kernel's order
of sums.

* ``pack_embed_weights`` / ``unpack_embed_weights``: an exact round trip,
  for Multisteps' (C0 95 padded to 96) and PathNet's (C0 36 padded to 48)
  chains and for 64-wide chains zero-padded to 128; the blocks are 8 x 8
  core matrices, element by element, and the pads are zero; above 96
  input channels W0 is padded to slabs of 96 rows.  (The tiled body takes
  Multisteps' form and PathNet's chains up to 128 wide; wider PathNet
  chains run the row-chunk body, which reads no pack.)
* The cache: a hit for the same parameter values, a new pack after an
  in-place update (the version counter), a pack on every call for
  tensors made in inference mode.
* The plan: its buffers fit the 227 KB a block may opt into, for each
  padded input width; above 96 input channels, slabs of 96 in the carve
  of 96.
* The walk: the kernel's order over blocks, pixel tiles, sample chunks and
  k16 steps, dW0^T added to the block's copy once per chunk and the
  per-block partials summed in block order, in f32, within 1e-5
  (absolute) of ``_embed_bwd_plain`` in f32: only the order of the f32
  sums differs.  Inputs are scaled so every gradient is O(1).
"""

import numpy as np
import pytest
import torch

from wcmc_tpu_torch.ops import conv5
from wcmc_tpu_torch.ops import pathnet_fused as pf

WALK_ATOL = 1e-5
SBMC, LBMC = (95, 128, 128, 128), (36, 64, 64, 64)


def _case(b, s, hw, dims, seed):
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))

    x = f(b, s, hw, dims[0], scale=0.5)
    ws = [f(ci, co, scale=ci ** -0.5) for ci, co in zip(dims[:-1], dims[1:])]
    bs = [f(co, scale=0.1) for co in dims[1:]]
    return x, ws, bs, f(b, s, hw, dims[-1], scale=0.1), f(b, hw, dims[-1], scale=0.1)


@pytest.mark.parametrize("dims,k0", [(SBMC, 96), ((36, 128, 128, 128), 48), (LBMC, 48),
                                     ((48, 32, 96, 112), 48),
                                     ((49, 128, 16, 64), 96),
                                     ((150, 128, 128, 128), 192)])
def test_pack_round_trip(dims, k0):
    _, ws, bs, _, _ = _case(1, 1, 8, dims, 0)
    wp, bp = pf.pack_embed_weights(ws, bs, torch.float32)
    n = pf.EMBED_BWD_WIDTH
    assert wp.shape == ((k0 + 2 * n) * n,) and bp.shape == (3 * n,)
    w, b = pf.unpack_embed_weights(wp, bp, *dims)
    for got, want in zip(w + b, ws + bs):
        assert torch.equal(got, want)
    # zero where the pads are
    assert torch.count_nonzero(wp) == sum(torch.count_nonzero(t) for t in ws)
    assert torch.count_nonzero(bp) == sum(torch.count_nonzero(t) for t in bs)
    # bf16: the weights rounded once, as the kernel multiplies them
    wb, _ = pf.pack_embed_weights(ws, bs)
    assert wb.dtype == torch.bfloat16
    assert torch.equal(pf.unpack_embed_weights(wb, bp, *dims)[0][0], ws[0].to(torch.bfloat16))


def test_pack_layout():
    _, ws, bs, _, _ = _case(1, 1, 8, SBMC, 3)
    wp, bp = pf.pack_embed_weights(ws, bs, torch.float32)
    n = 128
    w0 = wp[:96 * n].view(12, 16, 8, 8)      # blocked: (row / 8, col / 8, row % 8, col % 8)
    for r, c in [(0, 0), (13, 37), (94, 127), (64, 8)]:
        assert w0[r // 8, c // 8, r % 8, c % 8] == ws[0][r, c]
    assert torch.count_nonzero(w0[11, :, 7]) == 0   # W0's row 95: the pad to k0 = 96
    w2 = wp[(96 + n) * n:].view(16, 16, 8, 8)
    assert w2[5, 3, 2, 1] == ws[2][42, 25]
    assert torch.equal(bp, torch.cat(bs))
    # a 64-wide chain: W1 and the biases zero-padded to 128
    _, ws, bs, _, _ = _case(1, 1, 8, LBMC, 4)
    wp, bp = pf.pack_embed_weights(ws, bs, torch.float32)
    w1 = pf.unblocked(wp[48 * n:(48 + n) * n].view(16, 16, 8, 8))
    assert torch.equal(w1[:64, :64], ws[1]) and torch.count_nonzero(w1[64:]) == 0
    assert torch.count_nonzero(w1[:, 64:]) == 0
    assert torch.equal(bp[n:n + 64], bs[1]) and torch.count_nonzero(bp[n + 64:2 * n]) == 0


def test_pack_cache():
    _, ws, bs, _, _ = _case(1, 1, 8, SBMC, 5)
    params = [torch.nn.Parameter(t.clone()) for t in ws + bs]
    ws, bs = params[:3], params[3:]
    pf._packed.clear()
    first = pf._packed_embed(ws, bs)
    again = pf._packed_embed(ws, bs)
    assert again[0] is first[0] and again[1] is first[1] and len(pf._packed) == 1
    with torch.no_grad():   # an optimizer's in-place update bumps the version
        ws[1].mul_(2.0)
    bumped = pf._packed_embed(ws, bs)
    assert bumped[0] is not first[0] and len(pf._packed) == 2
    assert torch.equal(pf.unpack_embed_weights(*bumped, *SBMC)[0][1],
                       ws[1].detach().to(torch.bfloat16))
    assert torch.equal(bumped[1], first[1])
    # tensors made in inference mode are packed on every call, never cached
    with torch.inference_mode():
        frozen = [t.detach().clone() for t in params]
    n = len(pf._packed)
    a = pf._packed_embed(frozen[:3], frozen[3:])
    b = pf._packed_embed(frozen[:3], frozen[3:])
    assert a[0] is not b[0] and torch.equal(a[0], b[0]) and len(pf._packed) == n
    pf._packed.clear()


@pytest.mark.parametrize("c0,k0", [(1, 48), (36, 48), (48, 48), (49, 96), (95, 96), (96, 96),
                                   (97, 192), (100, 192), (128, 192), (150, 192), (193, 288)])
def test_plan_fits(c0, k0):
    plan = pf.embed_bwd_plan(c0)
    assert plan.k0 == k0 and plan.slab == min(k0, 96) and k0 % plan.slab == 0
    assert plan.total == sum(n for _, n in plan.smem)
    assert all(n % 128 == 0 for _, n in plan.smem)
    assert plan.total <= conv5.SMEM_LIMIT   # the 227 KB a block may opt into on an H100
    # 64 rows per product (a wgmma's m64)
    assert (plan.pix, plan.samples) == pf.EMBED_BWD_TILE and plan.pix * plan.samples == 64
    sizes = dict(plan.smem)
    slab = plan.slab
    assert sizes["w0"] == 2 * slab * 128 and sizes["w1"] == sizes["w2"] == 2 * 128 * 128
    assert sizes["x_in"] == sizes["x"] == 2 * 64 * slab and sizes["dw0"] == 4 * 128 * slab
    # the staged d(x) spans (of a slab, above 96 channels) fit the freed h2 tile
    assert 2 * plan.samples * plan.pix * min(c0, slab) <= sizes["h2"]
    if k0 > 96:   # wide rows take the carve of 96
        assert plan.total == pf.embed_bwd_plan(96).total


def test_plan_refuses_wide_rows():
    """Rows of any width are taken (slabs of 96 above 96); only rows
    without a value, which the reference cannot take either, are refused."""
    for c0 in (97, 100, 150, 1000):
        assert pf.embed_bwd_plan(c0).k0 == -(-c0 // 96) * 96
    with pytest.raises(ValueError):
        pf.embed_bwd_plan(0)


@pytest.mark.parametrize("acts,dims,dx,b,s,hw,none", [
    (pf.LEAKY, SBMC, True, 2, 3, 37, ""),           # odd S, ragged HW
    (pf.LEAKY, SBMC, True, 1, 1, 33, "gmean"),      # S = 1, one pixel past a tile
    (pf.LEAKY, SBMC, False, 2, 2, 64, "ge"),        # whole tiles, no d(x), no ge
    (pf.LEAKY, (40, 32, 48, 64), True, 1, 5, 31, ""),   # k0 48, narrower, padded
    (pf.EMBED_ACTS, LBMC, False, 2, 3, 37, ""),     # LBMC's and SBMC's PathNet
    (pf.EMBED_ACTS, LBMC, False, 2, 2, 40, "gmean"),
    (pf.EMBED_ACTS, (60, 32, 64, 48), False, 1, 9, 17, "ge"),   # k0 96, narrower
    (pf.LEAKY, (97, 128, 128, 128), True, 2, 3, 37, ""),    # C0 past 96: slabs of 96
    (pf.LEAKY, (100, 128, 128, 128), True, 1, 2, 33, "gmean"),
    (pf.LEAKY, (150, 128, 128, 128), True, 1, 3, 40, ""),
    (pf.EMBED_ACTS, (150, 64, 64, 64), False, 1, 2, 33, "ge"),
])
def test_walk_matches_plain(acts, dims, dx, b, s, hw, none):
    x, ws, bs, ge, gmean = _case(b, s, hw, dims, 7)
    ge, gmean = (None if none == name else t for name, t in (("ge", ge), ("gmean", gmean)))
    got = pf._embed_bwd_walk(x, ge, gmean, ws, bs, acts, dx, n_blocks=3)
    want = pf._embed_bwd_plain(x, ge, gmean, ws, bs, acts, dx)
    assert (got[0] is None) == (want[0] is None) == (not dx)
    pairs = list(zip([*got[1], *got[2]], [*want[1], *want[2]]))
    if dx:
        pairs.append((got[0], want[0]))
    for a, w in pairs:
        assert a.shape == w.shape
        torch.testing.assert_close(a, w, rtol=0, atol=WALK_ATOL)
