"""What surrounds K5-bwd (the PathNet / Multisteps head backward) on the
card, on the CPU: the packed weight layout it reads, the cache that packs
a head once per parameter value, its plan (tile, ring and shared memory
per form), and a plain walk of the kernel's order of sums.

* ``pack_head_weights`` / ``unpack_head_weights``: an exact round trip;
  the tiled form's blocks are 8 x 8 core matrices and its W1c fragments
  those of mma.m16n8k16, element by element.
* The cache: a hit for the same parameter values, a new pack after an
  in-place update (the version counter), a pack on every call for
  tensors made in inference mode.
* The plan: each form's buffers fit the 227 KB a block may opt into.
* The walk: the kernel's order over blocks, pixel tiles, sample chunks
  and k16 steps, per-block partials summed in block order and the
  context's gradients from G = hi + lo, in f32, within 1e-5 (absolute)
  of ``_head_bwd_plain`` in f32: only the order of the f32 sums and G's
  two-term split differ.  Inputs are scaled so every gradient is O(1).
"""

import numpy as np
import pytest
import torch

from wcmc_tpu_torch.ops import conv5
from wcmc_tpu_torch.ops import pathnet_fused as pf

WALK_ATOL = 1e-5
LEAKY2 = pf.LEAKY[:2]


def _case(b, s, hw, ce, cc, c1, cout, cmajor, seed):
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))

    e = f(b, s, hw, ce, scale=0.25)
    ctx = f(b, hw, cc, scale=0.25)
    ws = [f(ce + cc, c1, scale=(ce + cc) ** -0.5), f(c1, cout, scale=c1 ** -0.5)]
    bs = [f(c1, scale=0.1), f(cout, scale=0.1)]
    g = f(*((b, s, cout, hw) if cmajor else (b, s, hw, cout)), scale=0.1)
    return e, ctx, g, f(b, hw, cout, scale=0.1), f(b, hw, cout, scale=0.01), ws, bs


@pytest.mark.parametrize("acts,dims", [(LEAKY2, (128, 128, 128, 128)),
                                       (LEAKY2, (64, 32, 96, 100)),
                                       (pf.HEAD_ACTS, (128, 128, 256, 6)),
                                       (pf.HEAD_ACTS, (64, 64, 128, 3))])
def test_pack_round_trip(acts, dims):
    ce, cc, c1, cout = dims
    _, _, _, _, _, ws, bs = _case(1, 1, 8, ce, cc, c1, cout, False, 0)
    wp, bp = pf.pack_head_weights(ws, bs, acts, ce, torch.float32)
    w, b = pf.unpack_head_weights(wp, bp, acts, ce, cc, c1, cout)
    for got, want in zip(w + b, ws + bs):
        assert torch.equal(got, want)
    # zero where the pads are (W1c is packed twice in the tiled form)
    copies = 2 if pf.head_bwd_plan(acts).tiled else 1
    nonzero = torch.count_nonzero(ws[0][:ce]) + copies * torch.count_nonzero(ws[0][ce:])
    assert torch.count_nonzero(wp) == nonzero + torch.count_nonzero(ws[1])
    # bf16: the weights rounded once, as the kernel multiplies them
    wb, _ = pf.pack_head_weights(ws, bs, acts, ce)
    assert wb.dtype == torch.bfloat16
    assert torch.equal(pf.unpack_head_weights(wb, bp, acts, ce, cc, c1, cout)[0][1],
                       ws[1].to(torch.bfloat16))


def test_pack_tiled_layout():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((128, 64)).astype(np.float32))
    xb = pf.blocked(x)
    assert tuple(xb.shape) == (16, 8, 8, 8)
    for r, c in [(0, 0), (13, 37), (127, 63), (64, 8)]:
        assert xb[r // 8, c // 8, r % 8, c % 8] == x[r, c]
    assert torch.equal(pf.unblocked(xb), x)
    # mma.m16n8k16's B fragment: lane l of (k16 step ks, n8 tile j) holds
    # B[16 ks + 2 (l % 4) + i % 2 + 8 (i // 2), 8 j + l // 4], i < 4
    fr = pf.frag_order(x)
    assert tuple(fr.shape) == (8, 8, 32, 4)
    for ks, j, lane, i in [(0, 0, 0, 0), (3, 5, 17, 2), (7, 7, 31, 3), (2, 1, 6, 1)]:
        assert fr[ks, j, lane, i] == x[16 * ks + 2 * (lane % 4) + i % 2 + 8 * (i // 2),
                                      8 * j + lane // 4]
    assert torch.equal(pf.unfrag_order(fr), x)
    # the packed tiled head: blocked W1e, blocked W2, then W1c's fragments
    # for ctx . W1c and for G . W1c^T
    _, _, _, _, _, ws, bs = _case(1, 1, 8, 128, 128, 128, 128, False, 4)
    wp, bp = pf.pack_head_weights(ws, bs, LEAKY2, 128, torch.float32)
    n = 128 * 128
    assert torch.equal(wp[:n], pf.blocked(ws[0][:128]).reshape(-1))
    assert torch.equal(wp[n:2 * n], pf.blocked(ws[1]).reshape(-1))
    assert torch.equal(wp[2 * n:3 * n], pf.frag_order(ws[0][128:]).reshape(-1))
    assert torch.equal(wp[3 * n:], pf.frag_order(ws[0][128:].t()).reshape(-1))
    assert torch.equal(bp, torch.cat(bs))


def test_pack_pathnet_tiled_layout():
    """PathNet's tiled form at KPCN's widths: blocked W1e (128 x 256) and
    W2 (256 x 6 padded to 16), W1c's fragments (K 128 x N 256) and W1c^T's
    (K 256 x N 128), b1 | b2 padded to 16; LBMC's 64-wide head padded to
    128 x 128."""
    _, _, _, _, _, ws, bs = _case(1, 1, 8, 128, 128, 256, 6, True, 6)
    wp, bp = pf.pack_head_weights(ws, bs, pf.HEAD_ACTS, 128, torch.float32)
    n = 128 * 256
    assert torch.equal(wp[:n], pf.blocked(ws[0][:128]).reshape(-1))
    w2 = pf.unblocked(wp[n:n + 256 * 16].view(32, 2, 8, 8))
    assert torch.equal(w2[:, :6], ws[1]) and torch.count_nonzero(w2[:, 6:]) == 0
    fc = wp[n + 256 * 16:2 * n + 256 * 16]
    assert torch.equal(fc, pf.frag_order(ws[0][128:]).reshape(-1))
    assert torch.equal(wp[2 * n + 256 * 16:], pf.frag_order(ws[0][128:].t()).reshape(-1))
    assert torch.equal(bp[:256], bs[0]) and torch.equal(bp[256:262], bs[1])
    assert torch.count_nonzero(bp[262:]) == 0
    _, _, _, _, _, ws, bs = _case(1, 1, 8, 64, 64, 128, 3, False, 6)
    wp, bp = pf.pack_head_weights(ws, bs, pf.HEAD_ACTS, 64, torch.float32)
    w1e = pf.unblocked(wp[:128 * 128].view(16, 16, 8, 8))
    assert torch.equal(w1e[:64], ws[0][:64]) and torch.count_nonzero(w1e[64:]) == 0
    assert wp.numel() == 3 * 128 * 128 + 128 * 16 and bp.numel() == 128 + 16


def test_pack_cache():
    _, _, _, _, _, ws, bs = _case(1, 1, 8, 128, 128, 128, 128, False, 5)
    params = [torch.nn.Parameter(t.clone()) for t in ws + bs]
    ws, bs = params[:2], params[2:]
    pf._packed.clear()
    first = pf._packed_head(ws, bs, LEAKY2, 128)
    again = pf._packed_head(ws, bs, LEAKY2, 128)
    assert again[0] is first[0] and again[1] is first[1] and len(pf._packed) == 1
    with torch.no_grad():   # an optimizer's in-place update bumps the version
        bs[1].add_(1.0)
    bumped = pf._packed_head(ws, bs, LEAKY2, 128)
    assert bumped[1] is not first[1] and len(pf._packed) == 2
    assert torch.equal(bumped[1][128:], (bs[1] + 0).detach())
    assert torch.equal(bumped[0], first[0])
    # tensors made in inference mode are packed on every call, never cached
    with torch.inference_mode():
        frozen = [t.detach().clone() for t in params]
    n = len(pf._packed)
    a = pf._packed_head(frozen[:2], frozen[2:], LEAKY2, 128)
    b = pf._packed_head(frozen[:2], frozen[2:], LEAKY2, 128)
    assert a[0] is not b[0] and torch.equal(a[0], b[0]) and len(pf._packed) == n
    pf._packed.clear()


@pytest.mark.parametrize("acts,dims", [(LEAKY2, (128, 128, 128)),
                                       (pf.HEAD_ACTS, (128, 128, 256)),
                                       (pf.HEAD_ACTS, (64, 64, 128)),
                                       (pf.HEAD_ACTS, (144, 128, 256)),
                                       (pf.HEAD_ACTS, (128, 128, 272))])
def test_plan_fits(acts, dims):
    plan = pf.head_bwd_plan(acts, *dims)
    assert plan.total == sum(n for _, n in plan.smem)
    assert all(n % 128 == 0 for _, n in plan.smem)
    assert plan.total <= conv5.SMEM_LIMIT   # the 227 KB a block may opt into on an H100
    sizes = dict(plan.smem)
    if plan.tiled and acts == LEAKY2:
        # 64 rows per product (a wgmma's m64), a ring of two e tiles
        assert (plan.pix, plan.samples) == pf.TILED_TILE and plan.pix * plan.samples == 64
        assert sizes["e"] == pf.TILED_STAGES * sizes["g"] == pf.TILED_STAGES * 64 * 2 * 128
        assert sizes["w1e"] == sizes["w2"] == 2 * 128 * 128
        assert plan.widths == (128, 128, 128)
    elif plan.tiled:
        # PathNet's tiled form: 16 pixels x 4 samples, 64 rows per product;
        # Ce and Cc padded to 128, C1 to 128 or 256 (KPCN's merged branches)
        assert (plan.pix, plan.samples) == pf.PN_TILE and plan.pix * plan.samples == 64
        n1 = 128 if dims[2] <= 128 else 256
        assert plan.widths == (128, 128, n1)
        assert sizes["e"] == pf.TILED_STAGES * 64 * 2 * 128
        assert sizes["w1e"] == 2 * 128 * n1 and sizes["w2"] == 2 * n1 * 16
        # h1 / g1 holds the chunk's 64 rows and the tile's [G_hi | G_lo]
        assert sizes["h"] >= max(2 * 64 * n1, 2 * 16 * (2 * n1 + 8))
    else:   # wider than the tiled forms: the wmma body at the head's own widths
        assert max(dims[:2]) > 128 or dims[2] > 256
        assert (plan.pix, plan.samples) == pf.PATHNET_TILE and plan.widths == dims


@pytest.mark.parametrize("acts,dims,cmajor,b,s,hw,none", [
    (LEAKY2, (128, 128, 128, 128), False, 2, 3, 37, ""),      # odd S, ragged HW
    (LEAKY2, (128, 128, 128, 128), False, 1, 1, 33, "gsq"),   # S = 1, one pixel past a tile
    (LEAKY2, (128, 128, 128, 128), False, 2, 2, 64, "g"),     # whole tiles, no g
    (LEAKY2, (64, 32, 96, 100), False, 1, 5, 31, "gsum"),     # narrower, padded
    (pf.HEAD_ACTS, (128, 128, 256, 6), True, 2, 3, 37, ""),   # KPCN: channel-major f32 g
    (pf.HEAD_ACTS, (128, 128, 256, 6), False, 1, 9, 17, "gsq"),
    (pf.HEAD_ACTS, (64, 64, 128, 3), False, 2, 2, 40, "g"),   # LBMC / SBMC's PathNet
    (pf.HEAD_ACTS, (128, 128, 256, 6), True, 1, 1, 33, "gsum"),   # KPCN: S = 1, ragged HW
    (pf.HEAD_ACTS, (128, 128, 256, 6), True, 2, 5, 32, "g"),      # odd S, whole tiles
    (pf.HEAD_ACTS, (128, 128, 256, 6), False, 1, 4, 18, ""),      # channels-last
    (pf.HEAD_ACTS, (64, 64, 128, 3), True, 1, 3, 23, "gsq"),
    (pf.HEAD_ACTS, (144, 128, 256, 6), True, 1, 3, 20, ""),       # wider: the wmma body
])
def test_walk_matches_plain(acts, dims, cmajor, b, s, hw, none):
    e, ctx, g, gsum, gsq, ws, bs = _case(b, s, hw, *dims, cmajor, 7)
    g, gsum, gsq = (None if none == name else t
                    for name, t in (("g", g), ("gsum", gsum), ("gsq", gsq)))
    got = pf._head_bwd_walk(e, ctx, g, gsum, gsq, ws, bs, acts, cmajor, n_blocks=3)
    want = pf._head_bwd_plain(e, ctx, g, gsum, gsq, ws, bs, acts, cmajor)
    for a, w in zip([got[0], got[1], *got[2], *got[3]], [want[0], want[1], *want[2], *want[3]]):
        assert a.shape == w.shape
        torch.testing.assert_close(a, w, rtol=0, atol=WALK_ATOL)
