"""PathNet's per-sample MLPs: the embedding with its fused sample mean,
and the head over [e | broadcast_S(ctx)] with its fused sample moments,
each an autograd Function whose backward is a kernel too.

Counterpart of ``wcmc_tpu/ops/pathnet_fused.py`` (reference dataflow:
``e = MLP_embed(paths)``, ``ctx = UNet(mean_S(e))``,
``out = MLP_head(concat(e, broadcast_S(ctx)))``).

* ``pathnet_embed``: forward CUDA kernel K4-fwd (``csrc/pathnet_embed.cu``),
  plain version ``_embed_plain``; backward K4-bwd
  (``csrc/pathnet_embed_bwd.cu``), plain version ``_embed_bwd_plain``.
  K4-bwd reads the embedding's parameters as ``pack_embed_weights`` lays
  them out (packed once per parameter value); ``embed_bwd_plan`` gives its
  tile and shared memory, and ``_embed_bwd_walk`` is a plain walk of its
  order of sums (CPU tests);
* ``pathnet_head``: forward K5-fwd (``csrc/pathnet_head.cu``), plain
  ``_head_plain``; backward K5-bwd (``csrc/pathnet_head_bwd.cu``), plain
  ``_head_bwd_plain``.  K5-bwd reads the head's parameters as
  ``pack_head_weights`` lays them out (packed once per parameter value);
  ``head_bwd_plan`` gives its tiles and shared memory per form, and
  ``_head_bwd_walk`` is a plain walk of its order of sums (CPU tests).

The SBMC ``Multisteps`` model runs the same two forms wider: an
embedding with leaky relu on every layer (95 -> 128 -> 128 -> 128) and
an update chain [128 | 128] -> 128 -> 128 with leaky relu and a bf16
output.  The forward kernels take any per-layer activation of
``ACTS``; the backward kernels compute the two forms the models run
(``EMBED_BWD_FORMS``: relu-relu-linear without d(x) and leaky x 3 with
it; ``HEAD_BWD_FORMS``: relu-relu with Cout <= 16 and an f32
output cotangent, leaky-leaky with Cout <= 128 and a bf16 one) and raise
``ValueError`` for any other chain.

CPU tensors run the plain versions; CUDA tensors launch the kernels,
which compute in bfloat16 with f32 accumulation and raise for other
dtypes.  The plain versions round where the reference's Pallas kernels
round: forward, after every embedding layer, after every hidden head
layer, and the last head layer only to the output dtype: its unrounded
f32 value feeds the moments (the reference's XLA head path rounds the
last layer to the compute dtype and sums the moments from it; in float32
the two agree); backward, the hiddens are recomputed in the compute
dtype, each layer's cotangent is rounded to it before its products, and
dW, db (from the unrounded cotangent) and d(ctx) stay f32.  A cotangent
that autograd passes as ``None`` is a zero.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from wcmc_tpu_torch.ops import _build
from wcmc_tpu_torch.ops._pack import PackCache
from wcmc_tpu_torch.ops.mlp_fused import (
    ACTS, _act, _act_grad, _mlp_bwd_rows, _mlp_plain, matmul_f32,
)

EMBED_ACTS = ("relu", "relu", "linear")
HEAD_ACTS = ("relu", "relu")
HEAD_MAX_OUT = 128   # K5-fwd's widest output (Cout <= 16, or a multiple of 16 up to this)
LEAKY = ("leaky_relu",) * 3
# the chains K4-bwd computes -> whether it writes d(x): PathNet's embedding
# (its paths are data) and Multisteps' (its features carry the PathNet's
# output under use_llpm_buf)
EMBED_BWD_FORMS = {EMBED_ACTS: False, LEAKY: True}
# the forms K5-bwd computes: activations -> (W2's staged width, the widest
# Cout; the output cotangent's dtype): PathNet's head, Multisteps' update chain
HEAD_BWD_FORMS = {HEAD_ACTS: (16, torch.float32), LEAKY[:2]: (128, torch.bfloat16)}


def _embed_plain(x, ws, bs, acts):
    _build.plain_calls["pathnet_embed"] += 1
    b, s, hw, c0 = x.shape
    e = _mlp_plain(x.reshape(-1, c0), ws, bs, acts).reshape(b, s, hw, ws[-1].shape[1])
    return e, e.float().mean(dim=1)


def _head_plain(e, ctx, ws, bs, acts, moments=False, cmajor=False, out_dtype=torch.float32):
    _build.plain_calls["pathnet_head"] += 1
    ce = e.shape[-1]
    w1 = ws[0]
    z = (matmul_f32(e, w1[:ce])
         + matmul_f32(ctx.to(e.dtype), w1[ce:])[:, None]
         + bs[0].float())
    h_f32 = _act(acts[0], z)
    for w, b, a in zip(ws[1:], bs[1:], acts[1:]):
        h_f32 = _act(a, matmul_f32(h_f32.to(e.dtype), w) + b.float())
    out = h_f32
    res = out.to(out_dtype)
    res = res.transpose(2, 3) if cmajor else res
    if moments:
        return res, out.sum(dim=1), (out * out).sum(dim=1)
    return res


def _require_cuda(name, *tensors):
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: inputs must all be on one CUDA device, got "
                         + ", ".join(str(t.device) for t in tensors))
    return dev


def _act_codes(name, acts, n):
    """The kernels' activation codes of ``n`` layers of ``ACTS``."""
    if len(acts) != n or any(a not in ACTS for a in acts):
        raise ValueError(f"{name} kernel computes {n} layers of {ACTS}, got {tuple(acts)}")
    return [ACTS.index(a) for a in acts]


def _check_embed_card(x, ws, acts):
    """What K4-fwd and K4-bwd compute: bf16 rows through three layers,
    widths multiples of 16; returns the layer widths and activation codes."""
    codes = _act_codes("pathnet_embed", acts, 3)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"pathnet_embed kernel computes in bfloat16, got {x.dtype}")
    dims = [x.shape[-1]] + [w.shape[1] for w in ws]
    for w, ci, co in zip(ws, dims[:-1], dims[1:]):
        if tuple(w.shape) != (ci, co) or co % 16:
            raise ValueError(f"pathnet_embed: weight {tuple(w.shape)} is not "
                             f"({ci}, {co}) with {co} a multiple of 16")
    return dims, codes


def _check_head_card(e, acts):
    codes = _act_codes("pathnet_head", acts, 2)
    if e.dtype != torch.bfloat16:
        raise TypeError(f"pathnet_head kernel computes in bfloat16, got {e.dtype}")
    return codes


def _embed_fwd(x, ws, bs, acts):
    if x.device.type == "cpu":
        return _embed_plain(x, ws, bs, acts)
    dev = _require_cuda("pathnet_embed", x, *ws, *bs)
    dims, codes = _check_embed_card(x, ws, acts)
    b, s, hw, _ = x.shape
    x = x.contiguous()
    wb = [w.to(torch.bfloat16).contiguous() for w in ws]
    bf = [bb.float().contiguous() for bb in bs]
    e = torch.empty((b, s, hw, dims[-1]), dtype=torch.bfloat16, device=dev)
    mean = torch.empty((b, hw, dims[-1]), dtype=torch.float32, device=dev)
    P, INT = _build.PTR, _build.INT
    fn = _build.kernel("wcmc_pathnet_embed", *([P] * 9), *([INT] * 12), P)
    idx = dev.index or 0
    _build.check(fn(x.data_ptr(), wb[0].data_ptr(), bf[0].data_ptr(),
                    wb[1].data_ptr(), bf[1].data_ptr(), wb[2].data_ptr(),
                    bf[2].data_ptr(), e.data_ptr(), mean.data_ptr(),
                    b, s, hw, *dims, *codes, _build.sm_count(idx), idx,
                    _build.stream_of(dev)), "pathnet_embed")
    _build.launches["pathnet_embed"] += 1
    return e, mean


def _head_fwd(e, ctx, ws, bs, acts, moments, cmajor, out_dtype):
    if e.device.type == "cpu":
        return _head_plain(e, ctx, ws, bs, acts, moments, cmajor, out_dtype)
    dev = _require_cuda("pathnet_head", e, ctx, *ws, *bs)
    codes = _check_head_card(e, acts)
    b, s, hw, ce = e.shape
    cc = ctx.shape[-1]
    c1, cout = ws[0].shape[1], ws[1].shape[1]
    if (tuple(ctx.shape) != (b, hw, cc) or tuple(ws[0].shape) != (ce + cc, c1)
            or tuple(ws[1].shape) != (c1, cout)):
        raise ValueError("pathnet_head: shapes of e, ctx and the weights disagree")
    if ce % 16 or cc % 16 or c1 % 16 or cout > HEAD_MAX_OUT or (cout > 16 and cout % 16):
        raise ValueError("pathnet_head kernel needs Ce, Cc, C1 multiples of 16 and Cout "
                         f"<= 16 or a multiple of 16 up to {HEAD_MAX_OUT}, got {ce}, {cc}, "
                         f"{c1}, {cout}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"pathnet_head kernel writes float32 or bfloat16, got {out_dtype}")
    e = e.contiguous()
    ctx = ctx.to(torch.bfloat16).contiguous()
    w1, w2 = (w.to(torch.bfloat16).contiguous() for w in ws)
    b1, b2 = (bb.float().contiguous() for bb in bs)
    shape = (b, s, cout, hw) if cmajor else (b, s, hw, cout)
    out = torch.empty(shape, dtype=out_dtype, device=dev)
    ssum = ssq = None
    if moments:
        ssum = torch.empty((b, hw, cout), dtype=torch.float32, device=dev)
        ssq = torch.empty_like(ssum)
    P, INT = _build.PTR, _build.INT
    fn = _build.kernel("wcmc_pathnet_head", *([P] * 9), *([INT] * 13), P)
    idx = dev.index or 0
    _build.check(fn(e.data_ptr(), ctx.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                    w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
                    ssum.data_ptr() if moments else None,
                    ssq.data_ptr() if moments else None,
                    b, s, hw, ce, cc, c1, cout, *codes, int(out_dtype == torch.bfloat16),
                    int(cmajor), _build.sm_count(idx), idx, _build.stream_of(dev)),
                 "pathnet_head")
    _build.launches["pathnet_head"] += 1
    return (out, ssum, ssq) if moments else out


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def _embed_bwd_plain(x, ge, gmean, ws, bs, acts, compute_dx=False):
    """Plain version of K4-bwd: (dx or None, dWs, dbs), all f32 but dx."""
    _build.plain_calls["pathnet_embed_bwd"] += 1
    b, s, hw, c0 = x.shape
    cout = ws[-1].shape[1]
    g = torch.zeros((b, s, hw, cout), dtype=torch.float32, device=x.device)
    if ge is not None:
        g = g + ge.to(x.dtype).float()
    if gmean is not None:
        g = g + (gmean.float() / s)[:, None]
    dx, dws, dbs = _mlp_bwd_rows(x.reshape(-1, c0), g.reshape(-1, cout), ws, bs, acts,
                                 compute_dx)
    return (dx.reshape(x.shape) if compute_dx else None), dws, dbs


def _head_bwd_plain(e, ctx, g, gsum, gsq, ws, bs, acts, cmajor=False):
    """Plain version of K5-bwd: (de in e.dtype, dctx f32 summed over S,
    dWs, dbs f32).  The output's cotangent is ``g + gsum + 2 h gsq``
    with ``h`` the unrounded f32 last layer."""
    _build.plain_calls["pathnet_head_bwd"] += 1
    dt = e.dtype
    b, s, hw, ce = e.shape
    cout = ws[-1].shape[1]
    ctx_c = ctx.to(dt)
    w1 = ws[0]
    h_f32 = _act(acts[0], matmul_f32(e, w1[:ce]) + matmul_f32(ctx_c, w1[ce:])[:, None]
                 + bs[0].float())
    hs = [h_f32.to(dt)]
    for w, bb, a in zip(ws[1:], bs[1:], acts[1:]):
        h_f32 = _act(a, matmul_f32(hs[-1], w) + bb.float())
        hs.append(h_f32.to(dt))
    gg = torch.zeros((b, s, hw, cout), dtype=torch.float32, device=e.device)
    if g is not None:
        gg = gg + (g.transpose(2, 3) if cmajor else g).float()
    if gsum is not None:
        gg = gg + gsum.float()[:, None]
    if gsq is not None:
        gg = gg + 2.0 * h_f32 * gsq.float()[:, None]
    n = len(ws)
    dws, dbs = [None] * n, [None] * n
    for i in reversed(range(1, n)):
        gz = _act_grad(acts[i], hs[i], gg)
        gz_c = gz.to(dt).float()
        dws[i] = hs[i - 1].float().reshape(-1, hs[i - 1].shape[-1]).t() @ gz_c.reshape(
            -1, gz.shape[-1])
        dbs[i] = gz.sum(dim=(0, 1, 2))
        gg = gz_c @ ws[i].to(dt).float().t()
    g1 = _act_grad(acts[0], hs[0], gg)
    g1_c = g1.to(dt).float()
    c1 = g1.shape[-1]
    dw1e = e.float().reshape(-1, ce).t() @ g1_c.reshape(-1, c1)
    gsum_s = g1_c.sum(dim=1)                      # (B, HW, C1): sum over S
    dw1c = ctx_c.float().reshape(-1, ctx.shape[-1]).t() @ gsum_s.reshape(-1, c1)
    dws[0] = torch.cat([dw1e, dw1c], dim=0)
    dbs[0] = g1.sum(dim=(0, 1, 2))
    de = (g1_c @ w1[:ce].to(dt).float().t()).to(dt)
    dctx = gsum_s @ w1[ce:].to(dt).float().t()
    return de, dctx, dws, dbs


def _embed_bwd_form(acts, compute_dx):
    """(the activation codes, whether the kernel writes d(x)) of a chain
    K4-bwd computes: Multisteps' form always writes d(x) (the wrapper
    drops what was not asked for), PathNet's never; ValueError for any
    other chain, and for PathNet's with d(x)."""
    with_dx = EMBED_BWD_FORMS.get(tuple(acts))
    if with_dx is None or (compute_dx and not with_dx):
        raise ValueError("pathnet_embed_bwd kernel computes the chains (activations: "
                         f"d(x)) {EMBED_BWD_FORMS}, got {tuple(acts)} with "
                         f"compute_dx={compute_dx}")
    return tuple(ACTS.index(a) for a in acts), with_dx


def _head_bwd_form(acts, cout, g_dtype):
    """(W2's staged width, the output cotangent's dtype on the card) of
    the K5-bwd form of ``acts`` for ``cout`` outputs and a cotangent of
    ``g_dtype`` (None: no cotangent); ValueError for what neither form
    computes.  PathNet's f32 cotangent may come in any float dtype;
    Multisteps' is read as bf16 and is not rounded to it here."""
    form = HEAD_BWD_FORMS.get(tuple(acts))
    if form is None or cout > form[0] or (g_dtype is not None and form[1] == torch.bfloat16
                                          and g_dtype != torch.bfloat16):
        raise ValueError(
            "pathnet_head_bwd kernel computes the forms (activations: W2's width, the widest "
            f"Cout; output cotangent dtype) {HEAD_BWD_FORMS}, got {tuple(acts)}, Cout {cout}, "
            f"{g_dtype}")
    return form


# ---------------------------------------------------------------------------
# K5-bwd's layouts and plan (csrc/pathnet_head_bwd.cu), kept here so the
# CPU tests reach them
# ---------------------------------------------------------------------------

# The Multisteps form runs the tiled kernel at these widths (Ce = Cc = C1
# = 128, W2 staged 128 wide); narrower chains are zero-padded to them.
TILED_WIDTH = 128
# csrc/pathnet_head_bwd.cu's tiles: (pixels per tile, samples per chunk)
# of the tiled kernel (64 rows per product) and of PathNet's kernel
TILED_TILE, PATHNET_TILE = (32, 2), (16, 8)
TILED_STAGES = 2      # the e ring's stages
PACK_CACHE_SIZE = 16  # packed heads and embeddings kept (a train step has up to 6)


class HeadBwdPlan(NamedTuple):
    """How K5-bwd runs a form: ``pix`` pixels of one image per tile,
    ``samples`` samples per chunk (``pix * samples`` rows per product),
    and the block's shared memory, ``smem`` as (buffer, bytes) pairs, each
    rounded up to 128 bytes as the kernel carves them, ``total`` their sum."""
    tiled: bool
    pix: int
    samples: int
    smem: tuple
    total: int


def _r128(n):
    return -(-n // 128) * 128


@functools.lru_cache(maxsize=None)
def head_bwd_plan(acts, ce=TILED_WIDTH, cc=TILED_WIDTH, c1=TILED_WIDTH) -> HeadBwdPlan:
    """K5-bwd's plan for the form of ``acts`` (``HEAD_BWD_FORMS``) at
    widths Ce, Cc, C1 (the tiled form's are always 128).  The tiled form
    (Multisteps): the packed W1e and W2, a ring of e tiles and the
    cotangent tile (blocked), h1 / g1 and bf16(gz2) (the first also the
    tile's [G_hi | G_lo], the second the staged d(e)), two context tiles,
    ctx . W1c + b1, G and gsum in f32, b2, the warps' running bias sums and
    the mbarriers.  PathNet's: csrc/pathnet_head_bwd.cu's pathnet_bwd_smem.
    ``total`` is what wcmc_pathnet_head_bwd_smem of that file returns."""
    kout = HEAD_BWD_FORMS[tuple(acts)][0]
    if tuple(acts) == LEAKY[:2]:
        w = TILED_WIDTH
        pix, samples = TILED_TILE
        rows = pix * samples
        pb, pf = 2 * (w + 8), 4 * (w + 8)      # padded rows of bf16 / f32
        smem = (("w1e", 2 * w * w), ("w2", 2 * w * kout),
                ("e", TILED_STAGES * rows * 2 * w), ("g", rows * 2 * kout),
                ("h", max(2 * rows * w, pix * 2 * (2 * w + 8))),
                ("gz", max(2 * rows * kout, rows * pb)), ("ctx", 2 * pix * pb),
                ("zc", pix * pf), ("G", pix * pf), ("gsum", pix * 4 * (kout + 8)),
                ("b2", 4 * kout), ("db", 2 * 4 * 8 * 64), ("bars", 8 * 7))
        tiled = True
    else:
        pix, samples = PATHNET_TILE
        rows = pix * samples
        smem = (("ctx", pix * 2 * (cc + 8)), ("zc", pix * 4 * (c1 + 4)),
                ("e", rows * 2 * (ce + 8)), ("h", rows * 2 * (c1 + 8)),
                ("gz", rows * 2 * (kout + 8)), ("gf", rows * kout * 4),
                ("gsum", pix * kout * 4), ("gsq", pix * kout * 4), ("gacc", pix * c1 * 4),
                ("ghi", pix * 2 * (c1 + 8)), ("glo", pix * 2 * (c1 + 8)),
                ("stage", 8 * 256 * 4), ("dbpart", samples * c1 * 4), ("db1", c1 * 4),
                ("b1", c1 * 4), ("db2", kout * 4), ("b2", kout * 4))
        tiled = False
    smem = tuple((name, _r128(n)) for name, n in smem)
    return HeadBwdPlan(tiled, pix, samples, smem, sum(n for _, n in smem))


def blocked(x):
    """A (R, C) matrix as (R / 8, C / 8, 8, 8) blocks of 8 rows x 8
    columns, each block's rows 16 contiguous bytes in bf16: the 8 x 8 core
    matrices in which K5-bwd keeps its weights and tiles in shared memory.
    A wgmma reads such a matrix as a B operand either way round (rows
    along K or along N) through one descriptor, and ldmatrix reads any
    8 x 8 block of it, plain or transposed."""
    r, c = x.shape
    return x.reshape(r // 8, 8, c // 8, 8).permute(0, 2, 1, 3).contiguous()


def unblocked(xb):
    """The inverse of :func:`blocked`."""
    r8, c8 = xb.shape[:2]
    return xb.permute(0, 2, 1, 3).reshape(r8 * 8, c8 * 8)


def frag_order(b):
    """A (K, N) matrix as the B fragments of mma.m16n8k16 in the order a
    warp loads them from device memory: (K / 16, N / 8, 32, 4), lane l
    of k16 step ks and n8 tile j holding B[16 ks + 2 (l % 4) + (i % 2) +
    8 (i // 2), 8 j + l // 4] for i < 4 (8 contiguous bytes a lane)."""
    k, n = b.shape
    # (ks, khalf, t, pair, j, g) -> (ks, j, g, t, khalf, pair)
    x = b.reshape(k // 16, 2, 4, 2, n // 8, 8).permute(0, 4, 5, 2, 1, 3)
    return x.reshape(k // 16, n // 8, 32, 4).contiguous()


def unfrag_order(f):
    """The inverse of :func:`frag_order`."""
    ks, n8 = f.shape[:2]
    return f.reshape(ks, n8, 8, 4, 2, 2).permute(0, 4, 3, 5, 1, 2).reshape(16 * ks, 8 * n8)


def pack_head_weights(ws, bs, acts, ce, dtype=torch.bfloat16):
    """The head's parameters (``ws[0]``'s first ``ce`` rows take e) in
    the layout K5-bwd reads: ``(weights, biases)``, flat.  The tiled form (Multisteps, widths zero-padded to
    128): ``blocked(W1e) | blocked(W2) | frag_order(W1c) |
    frag_order(W1c^T)`` in ``dtype`` (the last two the B fragments of
    ctx . W1c and of G . W1c^T, read from device memory once per tile),
    and ``b1 | b2`` in f32.  PathNet's: ``W1 | W2`` with W2's columns
    zero-padded to 16, and ``b1 | b2`` likewise."""
    w1, w2 = ws
    b1, b2 = bs
    kout = HEAD_BWD_FORMS[tuple(acts)][0]
    c1, cout = w2.shape
    dev = w1.device
    if head_bwd_plan(tuple(acts)).tiled:
        n, cc = TILED_WIDTH, w1.shape[0] - ce
        w1e = torch.zeros((n, n), dtype=dtype, device=dev)
        w1e[:ce, :c1] = w1[:ce]
        w1c = torch.zeros((n, n), dtype=dtype, device=dev)
        w1c[:cc, :c1] = w1[ce:]
        w2p = torch.zeros((n, kout), dtype=dtype, device=dev)
        w2p[:c1, :cout] = w2
        wp = torch.cat([blocked(w1e).reshape(-1), blocked(w2p).reshape(-1),
                        frag_order(w1c).reshape(-1), frag_order(w1c.t()).reshape(-1)])
        bp = torch.zeros(n + kout, dtype=torch.float32, device=dev)
        bp[:c1] = b1
    else:
        w2p = torch.zeros((c1, kout), dtype=dtype, device=dev)
        w2p[:, :cout] = w2
        wp = torch.cat([w1.to(dtype).reshape(-1), w2p.reshape(-1)])
        bp = torch.zeros(c1 + kout, dtype=torch.float32, device=dev)
        bp[:c1] = b1
    bp[-kout:][:cout] = b2
    return wp, bp


def unpack_head_weights(wp, bp, acts, ce, cc, c1, cout):
    """The inverse of :func:`pack_head_weights`: ``([W1, W2], [b1,
    b2])``; the tiled form's two W1c copies must agree."""
    kout = HEAD_BWD_FORMS[tuple(acts)][0]
    if head_bwd_plan(tuple(acts)).tiled:
        n = TILED_WIDTH
        w1e, w2, fc, fct = torch.split(wp, [n * n, n * kout, n * n, n * n])
        w1c = unfrag_order(fc.view(n // 16, n // 8, 32, 4))
        if not torch.equal(unfrag_order(fct.view(n // 16, n // 8, 32, 4)).t(), w1c):
            raise ValueError("the packed W1c and W1c^T fragments disagree")
        w1 = torch.cat([unblocked(w1e.view(n // 8, n // 8, 8, 8))[:ce, :c1], w1c[:cc, :c1]])
        w2 = unblocked(w2.view(n // 8, kout // 8, 8, 8))[:c1, :cout]
        b1 = bp[:c1]
    else:
        w1 = wp[:(ce + cc) * c1].view(ce + cc, c1)
        w2 = wp[(ce + cc) * c1:].view(c1, kout)[:, :cout]
        b1 = bp[:c1]
    return [w1, w2], [b1, bp[-kout:][:cout]]


_packed = PackCache(PACK_CACHE_SIZE)


def _packed_head(ws, bs, acts, ce):
    """``pack_head_weights(ws, bs, acts, ce)``, made once per value of the
    four parameters (:class:`~wcmc_tpu_torch.ops._pack.PackCache`)."""
    return _packed.get((*ws, *bs), (tuple(acts), ce),
                       lambda w1, w2, b1, b2: pack_head_weights([w1, w2], [b1, b2], acts, ce))


def _into(acc, a, w):
    """``acc + a @ w``, summed k16 step by k16 step (of ``a``'s columns) as
    the kernels' products add into their accumulators."""
    for k in range(0, a.shape[1], 16):
        acc = acc + a[:, k:k + 16] @ w[k:k + 16]
    return acc


def _prod(a, w):
    """``a @ w`` in k16 steps (:func:`_into` from zero)."""
    return _into(torch.zeros((a.shape[0], w.shape[1])), a, w)


def _head_bwd_walk(e, ctx, g, gsum, gsq, ws, bs, acts, cmajor=False, n_blocks=3):
    """A plain walk of K5-bwd's order on the CPU: persistent blocks take
    pixel tiles in turn (``head_bwd_plan``'s tile and chunk), each tile
    computes ctx . W1c + b1 once, then its samples in chunks (the tiled
    form's rows pixel-major: pixel by pixel, the chunk's samples of each):
    h1, h2 and the cotangent, dW2, g1, the sum G of bf16(g1) over the
    samples in sample order, dW1e and de, every product summed k16 step by
    k16 step into its accumulator; at the tile's end d(ctx) (the hi and lo
    terms of each k16 step in turn) and dW1c from G = hi + lo (hi =
    bf16(G), lo = bf16(G - hi)).  Each block's weight and bias
    gradients are its partials, summed in block order.  Returns what
    ``_head_bwd_plain`` returns."""
    dt = e.dtype
    b, s, hw, ce = e.shape
    cc = ctx.shape[-1]
    c1, cout = ws[1].shape
    plan = head_bwd_plan(tuple(acts), ce, cc, c1)
    w1e, w1c = ws[0][:ce].to(dt).float(), ws[0][ce:].to(dt).float()
    w2 = ws[1].to(dt).float()
    b1, b2 = bs[0].float(), bs[1].float()
    gfull = torch.zeros((b, s, hw, cout))
    if g is not None:
        gfull += (g.transpose(2, 3) if cmajor else g).float()
    def rows(x):   # (samples, pixels, C) -> the chunk's rows
        return (x.transpose(0, 1) if plan.tiled else x).reshape(-1, x.shape[-1])

    def unrows(x, ns, npx):
        return (x.reshape(npx, ns, -1).transpose(0, 1) if plan.tiled
                else x.reshape(ns, npx, -1))

    de = torch.empty_like(e)
    dctx = torch.empty((b, hw, cc))
    per_image = -(-hw // plan.pix)
    n_tiles = b * per_image
    sums = None
    for blk in range(min(n_blocks, n_tiles)):
        dw1e, dw1c, dw2 = torch.zeros((ce, c1)), torch.zeros((cc, c1)), torch.zeros((c1, cout))
        db1, db2 = torch.zeros(c1), torch.zeros(cout)
        for t in range(blk, n_tiles, min(n_blocks, n_tiles)):
            bi, p0 = t // per_image, (t % per_image) * plan.pix
            p1 = min(p0 + plan.pix, hw)
            cx = ctx[bi, p0:p1].to(dt).float()
            zc = _prod(cx, w1c) + b1
            big_g = torch.zeros((p1 - p0, c1))
            for s0 in range(0, s, plan.samples):
                s1 = min(s0 + plan.samples, s)
                ns, npx = s1 - s0, p1 - p0
                ec = rows(e[bi, s0:s1, p0:p1].float())
                h1 = _act(acts[0], _into(rows(zc.expand(ns, -1, -1)), ec, w1e)).to(dt).float()
                h2 = _act(acts[1], _prod(h1, w2) + b2)
                gg = rows(gfull[bi, s0:s1, p0:p1])
                if gsum is not None:
                    gg = gg + rows(gsum[bi, p0:p1].float().expand(ns, -1, -1))
                if gsq is not None:
                    gg = gg + 2.0 * h2 * rows(gsq[bi, p0:p1].float().expand(ns, -1, -1))
                gz = _act_grad(acts[1], h2, gg)
                db2 += gz.sum(dim=0)
                gzc = gz.to(dt).float()
                dw2 = _into(dw2, h1.t(), gzc)
                g1 = _act_grad(acts[0], h1, _prod(gzc, w2.t()))
                db1 += g1.sum(dim=0)
                g1c = g1.to(dt).float()
                for g1s in unrows(g1c, ns, npx):
                    big_g = big_g + g1s
                dw1e = _into(dw1e, ec.t(), g1c)
                de[bi, s0:s1, p0:p1] = unrows(_prod(g1c, w1e.t()).to(dt), ns, npx)
            hi = big_g.to(torch.bfloat16).float()
            lo = (big_g - hi).to(torch.bfloat16).float()
            d = torch.zeros((p1 - p0, cc))
            for k in range(0, c1, 16):
                d = d + hi[:, k:k + 16] @ w1c.t()[k:k + 16] + lo[:, k:k + 16] @ w1c.t()[k:k + 16]
            dctx[bi, p0:p1] = d
            dw1c = _into(_into(dw1c, cx.t(), hi), cx.t(), lo)
        part = [torch.cat([dw1e, dw1c]), dw2, db1, db2]
        sums = part if sums is None else [a + p for a, p in zip(sums, part)]
    return de, dctx, sums[:2], sums[2:]


# ---------------------------------------------------------------------------
# K4-bwd's layouts and plan (csrc/pathnet_embed_bwd.cu), kept here so the
# CPU tests reach them
# ---------------------------------------------------------------------------

# K4-bwd's tiled body runs every chain at C1 = C2 = C3 = 128 (narrower ones
# zero-padded to it) and C0 zero-padded to the first of EMBED_BWD_K0 that
# holds it; tiles of (pixels, samples per chunk): 64 rows per product.  It
# takes Multisteps' form and PathNet's chains up to EMBED_BWD_PATHNET_TILED
# wide (LBMC's and SBMC's PathNet); wider PathNet chains (KPCN's merged
# branches) run the row-chunk body (csrc/pathnet_embed_bwd.cu).
EMBED_BWD_WIDTH = 128
EMBED_BWD_K0 = (48, 96)
EMBED_BWD_TILE = (32, 2)
EMBED_BWD_PATHNET_TILED = 64


class EmbedBwdPlan(NamedTuple):
    """How K4-bwd runs rows of C0 values: C0 padded to ``k0``, ``pix``
    pixels of one image per tile, ``samples`` samples per chunk, and the
    block's shared memory, ``smem`` as (buffer, bytes) pairs, each rounded
    up to 128 bytes as the kernel carves them, ``total`` their sum."""
    k0: int
    pix: int
    samples: int
    smem: tuple
    total: int


@functools.lru_cache(maxsize=None)
def embed_bwd_plan(c0) -> EmbedBwdPlan:
    """K4-bwd's plan for rows of ``c0`` values: the packed W0 (k0 x 128),
    W1 and W2, the landing stage of the chunk's x spans and the blocked x
    tile, the cotangent tile (ge, then g3), h1 / g1, h2 / g2 (then the
    staged d(x)), dW0^T and the tile's gmean / S in f32, the biases and the
    mbarriers.  ``total`` is what wcmc_pathnet_embed_bwd_smem returns."""
    if not 1 <= c0 <= EMBED_BWD_K0[-1]:
        raise ValueError(f"pathnet_embed_bwd kernel takes 1 to {EMBED_BWD_K0[-1]} input "
                         f"channels, got {c0}")
    k0 = next(k for k in EMBED_BWD_K0 if c0 <= k)
    w = EMBED_BWD_WIDTH
    pix, samples = EMBED_BWD_TILE
    rows = pix * samples
    smem = (("w0", 2 * k0 * w), ("w1", 2 * w * w), ("w2", 2 * w * w), ("x_in", 2 * rows * k0),
            ("x", 2 * rows * k0), ("g", 2 * rows * w), ("h1", 2 * rows * w), ("h2", 2 * rows * w),
            ("dw0", 4 * w * k0), ("gmean", 4 * pix * w), ("bias", 4 * 3 * w), ("bars", 8 * 4))
    smem = tuple((name, _r128(n)) for name, n in smem)
    return EmbedBwdPlan(k0, pix, samples, smem, sum(n for _, n in smem))


def pack_embed_weights(ws, bs, dtype=torch.bfloat16):
    """The embedding's parameters in the layout K4-bwd reads: ``(weights,
    biases)``, flat: ``blocked(W0) | blocked(W1) | blocked(W2)`` in
    ``dtype``, W0 zero-padded to (k0, 128) and W1, W2 to (128, 128); and
    ``b0 | b1 | b2`` in f32, each zero-padded to 128."""
    n = EMBED_BWD_WIDTH
    rows = (embed_bwd_plan(ws[0].shape[0]).k0, n, n)
    dev = ws[0].device
    wp, bp = [], torch.zeros(3 * n, dtype=torch.float32, device=dev)
    for i, (w, b, r) in enumerate(zip(ws, bs, rows)):
        wz = torch.zeros((r, n), dtype=dtype, device=dev)
        wz[:w.shape[0], :w.shape[1]] = w
        wp.append(blocked(wz).reshape(-1))
        bp[i * n:i * n + b.shape[0]] = b
    return torch.cat(wp), bp


def unpack_embed_weights(wp, bp, c0, c1, c2, c3):
    """The inverse of :func:`pack_embed_weights`: ``([W0, W1, W2], [b0,
    b1, b2])``."""
    n = EMBED_BWD_WIDTH
    k0 = embed_bwd_plan(c0).k0
    w0, w1, w2 = torch.split(wp, [k0 * n, n * n, n * n])
    ws = [unblocked(w.view(r // 8, n // 8, 8, 8))[:ci, :co]
          for w, r, ci, co in ((w0, k0, c0, c1), (w1, n, c1, c2), (w2, n, c2, c3))]
    return ws, [bp[:c1], bp[n:n + c2], bp[2 * n:2 * n + c3]]


def _packed_embed(ws, bs):
    """``pack_embed_weights(ws, bs)``, made once per value of the six
    parameters (:class:`~wcmc_tpu_torch.ops._pack.PackCache`)."""
    return _packed.get((*ws, *bs), ("embed",),
                       lambda *p: pack_embed_weights(list(p[:3]), list(p[3:])))


def _embed_bwd_walk(x, ge, gmean, ws, bs, acts, compute_dx=False, n_blocks=3):
    """A plain walk of K4-bwd's order on the CPU: persistent blocks take
    pixel tiles in turn (``embed_bwd_plan``'s tile), each tile its samples
    in chunks, rows sample-major: the hiddens recomputed, g3 from ge +
    gmean / S, dW2, g2, dW1, g1, each weight-gradient product summed k16
    step by k16 step (of the chunk's rows) into its block-long accumulator;
    dW0^T = g1^T . x as one product per chunk, added to the block's dW0^T;
    d(x) per chunk.  Each block's weight and bias gradients are its
    partials, summed in block order.  Returns what ``_embed_bwd_plain``
    returns."""
    dt = x.dtype
    b, s, hw, c0 = x.shape
    c3 = ws[-1].shape[1]
    plan = embed_bwd_plan(c0)
    wt = [w.to(dt).float() for w in ws]
    bias = [bb.float() for bb in bs]
    gfull = torch.zeros((b, s, hw, c3)) if ge is None else ge.to(dt).float()
    gm = torch.zeros((b, hw, c3)) if gmean is None else gmean.float() / s
    dx = torch.empty_like(x) if compute_dx else None
    per_image = -(-hw // plan.pix)
    n_tiles = b * per_image
    grid = min(n_blocks, n_tiles)
    sums = None
    for blk in range(grid):
        dw0t = torch.zeros((ws[0].shape[1], c0))
        dw = [torch.zeros(w.shape) for w in ws[1:]]
        db = [torch.zeros(w.shape[1]) for w in ws]
        for t in range(blk, n_tiles, grid):
            bi, p0 = t // per_image, (t % per_image) * plan.pix
            p1 = min(p0 + plan.pix, hw)
            for s0 in range(0, s, plan.samples):
                s1 = min(s0 + plan.samples, s)
                xc = x[bi, s0:s1, p0:p1].float().reshape(-1, c0)
                h1 = _act(acts[0], _prod(xc, wt[0]) + bias[0]).to(dt).float()
                h2 = _act(acts[1], _prod(h1, wt[1]) + bias[1]).to(dt).float()
                g = (gfull[bi, s0:s1, p0:p1] + gm[bi, p0:p1]).reshape(-1, c3)
                if acts[2] != "linear":
                    g = _act_grad(acts[2], _act(acts[2], _prod(h2, wt[2]) + bias[2]).to(dt), g)
                db[2] += g.sum(dim=0)
                g3 = g.to(dt).float()
                dw[1] = _into(dw[1], h2.t(), g3)
                g2 = _act_grad(acts[1], h2, _prod(g3, wt[2].t()))
                db[1] += g2.sum(dim=0)
                g2 = g2.to(dt).float()
                dw[0] = _into(dw[0], h1.t(), g2)
                g1 = _act_grad(acts[0], h1, _prod(g2, wt[1].t()))
                db[0] += g1.sum(dim=0)
                g1 = g1.to(dt).float()
                dw0t = dw0t + _prod(g1.t(), xc)
                if compute_dx:
                    dx[bi, s0:s1, p0:p1] = _prod(g1, wt[0].t()).to(dt).reshape(
                        s1 - s0, p1 - p0, c0)
        part = [dw0t.t(), *dw, *db]
        sums = part if sums is None else [a + p for a, p in zip(sums, part)]
    return dx, sums[:3], sums[3:]


def _embed_bwd_kernel(x, ge, gmean, ws, bs, acts, compute_dx):
    dev = _require_cuda("pathnet_embed_bwd", x, *ws, *bs)
    b, s, hw, c0 = x.shape
    codes, with_dx = _embed_bwd_form(acts, compute_dx)
    c1, c2, c3 = _check_embed_card(x, ws, acts)[0][1:]
    if ((ge is not None and tuple(ge.shape) != (b, s, hw, c3))
            or (gmean is not None and tuple(gmean.shape) != (b, hw, c3))):
        raise ValueError("pathnet_embed_bwd: cotangent shapes do not match the embedding")
    if not with_dx and max(c1, c2, c3) > EMBED_BWD_PATHNET_TILED:
        return _embed_bwd_rows(x, ge, gmean, ws, bs, dev)
    n = EMBED_BWD_WIDTH
    if max(c1, c2, c3) > n:
        raise ValueError(f"pathnet_embed_bwd kernel takes layer widths up to {n}, got "
                         f"{c1}, {c2}, {c3}")
    k0 = embed_bwd_plan(c0).k0
    wp, bp = _packed_embed(ws, bs)
    # the rows as they come (any alignment); the cotangents 16-byte aligned,
    # None is zero
    x = x.contiguous()
    ge = None if ge is None else _aligned(ge.to(torch.bfloat16).contiguous())
    gmean = None if gmean is None else _aligned(gmean.float().contiguous())
    dx = torch.empty_like(x) if with_dx else None
    idx = dev.index or 0
    n_blocks = _build.sm_count(idx)
    sizes = [k0 * n, n * n, n * n, n, n, n]
    parts = torch.empty(n_blocks * sum(sizes), dtype=torch.float32, device=dev)
    out = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    P, INT = _build.PTR, _build.INT
    fn = _build.kernel("wcmc_pathnet_embed_bwd", *([P] * 8), *([INT] * 10), P)
    ptr = (lambda t: None if t is None else t.data_ptr())
    _build.check(fn(x.data_ptr(), ptr(ge), ptr(gmean), wp.data_ptr(), bp.data_ptr(), ptr(dx),
                    parts.data_ptr(), out.data_ptr(), b, s, hw, c0, c3, *codes, n_blocks,
                    idx, _build.stream_of(dev)),
                 "pathnet_embed_bwd")
    _build.launches["pathnet_embed_bwd"] += 1
    dw0, dw1, dw2, db0, db1, db2 = torch.split(out, sizes)
    dws = [dw0.view(k0, n)[:c0, :c1], dw1.view(n, n)[:c1, :c2], dw2.view(n, n)[:c2, :c3]]
    return (dx if compute_dx else None), dws, [db0[:c1], db1[:c2], db2[:c3]]


def _embed_bwd_rows(x, ge, gmean, ws, bs, dev):
    """K4-bwd's row-chunk body for PathNet's chain (relu, relu, linear,
    no d(x)): W0 zero-padded to c0 rounded up to 16 rows, the weights in
    bf16 and the biases in f32 per call, absent cotangents as zeros."""
    b, s, hw, c0 = x.shape
    c1, c2, c3 = (w.shape[1] for w in ws)
    k0 = -(-c0 // 16) * 16
    bf = torch.bfloat16
    x = x.contiguous()
    ge = (torch.zeros((b, s, hw, c3), dtype=bf, device=dev) if ge is None
          else ge.to(bf).contiguous())
    gmean = (torch.zeros((b, hw, c3), dtype=torch.float32, device=dev) if gmean is None
             else gmean.float().contiguous())
    w0 = torch.zeros((k0, c1), dtype=bf, device=dev)
    w0[:c0] = ws[0]
    w1, w2 = (w.to(bf).contiguous() for w in ws[1:])
    b0, b1 = (bb.float().contiguous() for bb in bs[:2])
    sizes = [k0 * c1, c1 * c2, c2 * c3, c1, c2, c3]
    idx = dev.index or 0
    n_blocks = _build.sm_count(idx)
    parts = torch.empty(n_blocks * sum(sizes), dtype=torch.float32, device=dev)
    out = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    P, INT = _build.PTR, _build.INT
    fn = _build.kernel("wcmc_pathnet_embed_bwd_rows", *([P] * 10), *([INT] * 9), P)
    _build.check(fn(x.data_ptr(), ge.data_ptr(), gmean.data_ptr(), w0.data_ptr(), b0.data_ptr(),
                    w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), parts.data_ptr(),
                    out.data_ptr(), b, s, hw, c0, c1, c2, c3, n_blocks, idx,
                    _build.stream_of(dev)), "pathnet_embed_bwd")
    _build.launches["pathnet_embed_bwd"] += 1
    dw0, dw1, dw2, db0, db1, db2 = torch.split(out, sizes)
    return None, [dw0.view(k0, c1)[:c0], dw1.view(c1, c2), dw2.view(c2, c3)], [db0, db1, db2]


def _pad_last(t, n):
    """``t`` with its last axis zero-padded to ``n`` (``t`` itself when it is that wide)."""
    c = t.shape[-1]
    return t if c == n else torch.nn.functional.pad(t, (0, n - c))


def _aligned(t):
    """``t``, or a copy of it where its data does not start on 16 bytes."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _head_bwd_kernel(e, ctx, g, gsum, gsq, ws, bs, acts, cmajor):
    dev = _require_cuda("pathnet_head_bwd", e, ctx, *ws, *bs)
    codes = _check_head_card(e, acts)
    b, s, hw, ce = e.shape
    cc = ctx.shape[-1]
    c1, cout = ws[0].shape[1], ws[1].shape[1]
    kout, g_dtype = _head_bwd_form(acts, cout, None if g is None else g.dtype)
    if ce % 16 or cc % 16 or c1 % 16:
        raise ValueError("pathnet_head_bwd kernel needs Ce, Cc, C1 multiples of 16, got "
                         f"{ce}, {cc}, {c1}")
    g_shape = (b, s, cout, hw) if cmajor else (b, s, hw, cout)
    if (tuple(ctx.shape) != (b, hw, cc) or tuple(ws[0].shape) != (ce + cc, c1)
            or tuple(ws[1].shape) != (c1, cout)
            or (g is not None and tuple(g.shape) != g_shape)
            or any(m is not None and tuple(m.shape) != (b, hw, cout) for m in (gsum, gsq))):
        raise ValueError("pathnet_head_bwd: shapes of e, ctx, the weights and the "
                         "cotangents disagree")
    plan = head_bwd_plan(tuple(acts), ce, cc, c1)
    if plan.tiled and max(ce, cc, c1) > TILED_WIDTH:
        raise ValueError(f"pathnet_head_bwd kernel's {tuple(acts)} form takes Ce, Cc, C1 up "
                         f"to {TILED_WIDTH}, got {ce}, {cc}, {c1}")
    f32, bf = torch.float32, torch.bfloat16
    wp, bp = _packed_head(ws, bs, acts, ce)
    # the cotangents as they come (PathNet's kernel reads either layout, the
    # tiled one channels-last); None is zero
    if g is not None:
        g = g.to(g_dtype)
        g = (g.transpose(2, 3) if cmajor and plan.tiled else g).contiguous()
    gsum, gsq = (None if t is None else t.float().contiguous() for t in (gsum, gsq))
    e = e.contiguous()
    ctx = ctx.to(bf).contiguous()
    if plan.tiled:   # a narrower chain runs zero-padded to the tiled widths (exact)
        n = TILED_WIDTH
        # the tiled kernel's bulk copies need 16-byte aligned rows
        e, ctx = (_aligned(_pad_last(t, n)) for t in (e, ctx))
        g, gsum, gsq = (None if t is None else _aligned(_pad_last(t, kout))
                        for t in (g, gsum, gsq))
        dims = (n, n, n)
    else:
        dims = (ce, cc, c1)
    de = torch.empty_like(e)
    dctx = torch.empty((b, hw, dims[1]), dtype=f32, device=dev)
    n_parts = (dims[0] + dims[1]) * dims[2] + dims[2] * kout + dims[2] + kout
    idx = dev.index or 0
    n_blocks = _build.sm_count(idx)
    parts = torch.empty(n_blocks * n_parts, dtype=f32, device=dev)
    out = torch.empty(n_parts, dtype=f32, device=dev)
    P, INT = _build.PTR, _build.INT
    fn = _build.kernel("wcmc_pathnet_head_bwd", *([P] * 11), *([INT] * 13), P)
    ptr = (lambda t: None if t is None else t.data_ptr())
    _build.check(fn(e.data_ptr(), ctx.data_ptr(), ptr(g), ptr(gsum), ptr(gsq), wp.data_ptr(),
                    bp.data_ptr(), de.data_ptr(), dctx.data_ptr(), parts.data_ptr(),
                    out.data_ptr(), b, s, hw, *dims, cout, *codes, kout,
                    int(cmajor and not plan.tiled), n_blocks, idx, _build.stream_of(dev)),
                 "pathnet_head_bwd")
    _build.launches["pathnet_head_bwd"] += 1
    k1, kc, k2 = dims
    dw1, dw2, db1, db2 = torch.split(out, [(k1 + kc) * k2, k2 * kout, k2, kout])
    dw1 = dw1.view(k1 + kc, k2)
    if (k1, kc, k2) != (ce, cc, c1):
        dw1 = torch.cat([dw1[:ce, :c1], dw1[k1:k1 + cc, :c1]])
        de, dctx = de[..., :ce], dctx[..., :cc]
    dws = [dw1, dw2.view(k2, kout)[:c1, :cout]]
    return de, dctx, dws, [db1[:c1], db2[:cout]]


def pathnet_embed_bwd(x, ge, gmean, ws, bs, acts=EMBED_ACTS, compute_dx=False):
    """Gradients of :func:`pathnet_embed` for the cotangents ``ge`` of
    the embedding and ``gmean`` of its sample mean (either may be
    None): ``(dx or None, dWs, dbs)``, dx in x.dtype, dW and db in f32.
    K4-bwd for CUDA tensors (bf16; PathNet's relu-relu-linear chain
    without d(x) or Multisteps' leaky x 3), the plain version for CPU
    tensors."""
    if x.device.type == "cpu":
        return _embed_bwd_plain(x, ge, gmean, ws, bs, acts, compute_dx)
    return _embed_bwd_kernel(x, ge, gmean, ws, bs, acts, compute_dx)


def pathnet_head_bwd(e, ctx, g, gsum, gsq, ws, bs, acts=HEAD_ACTS, cmajor=False):
    """Gradients of :func:`pathnet_head` for the cotangents of its output
    ``g`` (channel-major with ``cmajor``) and of its moments ``gsum`` and
    ``gsq`` (any may be None): ``(de in e.dtype, dctx f32, dWs, dbs)``.
    K5-bwd for CUDA tensors (bf16; PathNet's relu-relu head with Cout <=
    16 and an f32 ``g``, or Multisteps' leaky-leaky update chain with
    Cout <= 128 and a bf16 ``g``), the plain version for CPU tensors."""
    if e.device.type == "cpu":
        return _head_bwd_plain(e, ctx, g, gsum, gsq, ws, bs, acts, cmajor)
    return _head_bwd_kernel(e, ctx, g, gsum, gsq, ws, bs, acts, cmajor)


class _Embed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, acts, compute_dx, n, *params):
        ctx.acts, ctx.compute_dx, ctx.n = acts, compute_dx, n
        ctx.save_for_backward(x, *params)
        return _embed_fwd(x, list(params[:n]), list(params[n:]), acts)

    @staticmethod
    def backward(ctx, ge, gmean):
        x, *params = ctx.saved_tensors
        n = ctx.n
        ws, bs = params[:n], params[n:]
        dx, dws, dbs = pathnet_embed_bwd(x, ge, gmean, ws, bs, ctx.acts,
                                         ctx.compute_dx and ctx.needs_input_grad[0])
        if dx is None and ctx.needs_input_grad[0]:
            dx = torch.zeros_like(x)   # compute_dx=False: x is taken as data
        return (dx, None, None, None, *[d.to(w.dtype) for d, w in zip(dws, ws)],
                *[d.to(bb.dtype) for d, bb in zip(dbs, bs)])


class _Head(torch.autograd.Function):
    @staticmethod
    def forward(ctx, e, c, acts, moments, cmajor, out_dtype, n, *params):
        ctx.acts, ctx.moments, ctx.cmajor, ctx.n = acts, moments, cmajor, n
        ctx.save_for_backward(e, c, *params)
        # an unused output (Multisteps' sum of squares) gets None, not a
        # zero tensor, and K5-bwd reads nothing for it
        ctx.set_materialize_grads(False)
        return _head_fwd(e, c, list(params[:n]), list(params[n:]), acts, moments, cmajor,
                         out_dtype)

    @staticmethod
    def backward(ctx, g, *moment_grads):
        e, c, *params = ctx.saved_tensors
        n = ctx.n
        ws, bs = params[:n], params[n:]
        gsum, gsq = moment_grads if ctx.moments else (None, None)
        de, dctx, dws, dbs = pathnet_head_bwd(e, c, g, gsum, gsq, ws, bs, ctx.acts, ctx.cmajor)
        return (de, dctx.to(c.dtype), None, None, None, None, None,
                *[d.to(w.dtype) for d, w in zip(dws, ws)],
                *[d.to(bb.dtype) for d, bb in zip(dbs, bs)])


def pathnet_embed(x, ws, bs, acts=EMBED_ACTS, compute_dx=False):
    """(B, S, HW, C0) rows -> (e (B, S, HW, Cout) in x.dtype,
    mean_S(e) (B, HW, Cout) f32), differentiable in the weights and
    biases (and in ``x`` only with ``compute_dx``; the KPCN paths are
    data)."""
    if len(ws) != len(bs) or len(ws) != len(acts):
        raise ValueError("pathnet_embed: ws, bs and acts differ in length")
    return _Embed.apply(x, tuple(acts), compute_dx, len(ws), *ws, *bs)


def pathnet_head(e, ctx, ws, bs, acts=HEAD_ACTS, moments=False, cmajor=False,
                 out_dtype=torch.float32):
    """Head chain over [e | broadcast_S(ctx)] without materializing the
    concat. e (B, S, HW, Ce) in compute dtype; ctx (B, HW, Cc), cast to
    the compute dtype before its product (a no-op for the UNet's output);
    ws[0] has shape (Ce + Cc, C1).  Returns (B, S, HW, Cout) in
    ``out_dtype`` — or (B, S, Cout, HW) with ``cmajor`` — and with
    ``moments`` also the f32 sum_S(out) and sum_S(out^2) of the unrounded
    output, each (B, HW, Cout).  Differentiable in e, ctx, the weights and
    the biases."""
    if len(ws) != len(bs) or len(ws) != len(acts):
        raise ValueError("pathnet_head: ws, bs and acts differ in length")
    return _Head.apply(e, ctx, tuple(acts), moments, cmajor, out_dtype, len(ws), *ws, *bs)
