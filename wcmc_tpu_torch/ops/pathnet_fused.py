"""PathNet's per-sample MLPs: the embedding with its fused sample mean,
and the head over [e | broadcast_S(ctx)] with its fused sample moments,
each an autograd Function whose backward is a kernel too.

Counterpart of ``wcmc_tpu/ops/pathnet_fused.py`` (reference dataflow:
``e = MLP_embed(paths)``, ``ctx = UNet(mean_S(e))``,
``out = MLP_head(concat(e, broadcast_S(ctx)))``).

* ``pathnet_embed``: forward CUDA kernel K4-fwd (``csrc/pathnet_embed.cu``),
  plain version ``_embed_plain``; backward K4-bwd
  (``csrc/pathnet_embed_bwd.cu``), plain version ``_embed_bwd_plain``.
  Both read the embedding's parameters as ``pack_embed_weights`` lays
  them out (packed once per parameter value, so a train step's backward
  finds its forward's pack; K4-fwd's row-chunk body, for the forms its
  tiled body does not take, reads them as they come); ``embed_fwd_plan``
  and ``embed_bwd_plan`` give their tiles and shared memory, and
  ``_embed_fwd_walk`` and ``_embed_bwd_walk`` are plain walks of their
  orders of sums (CPU tests);
* ``pathnet_head``: forward K5-fwd (``csrc/pathnet_head.cu``), plain
  ``_head_plain``; backward K5-bwd (``csrc/pathnet_head_bwd.cu``), plain
  ``_head_bwd_plain``.  Both read the head's parameters as
  ``pack_head_weights`` lays them out (packed once per parameter value,
  so a train step's backward finds its forward's pack; K5-fwd's wmma
  body, for the forms its tiled body does not take, reads them as they
  come); ``head_fwd_plan`` and ``head_bwd_plan`` give their tiles and
  shared memory per form, and ``_head_fwd_walk`` and ``_head_bwd_walk``
  are plain walks of their orders of sums (CPU tests).

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
which compute in bfloat16 with f32 accumulation (the bodies above) or in
float32 and raise ``TypeError`` for any other dtype.  In float32 all four
run bodies on the tensor cores in split TF32
(``csrc/pathnet_embed_tf32.cu``, ``csrc/pathnet_embed_bwd_tf32.cu``,
``csrc/pathnet_head_tf32.cu``, ``csrc/pathnet_head_bwd_tf32.cu``;
``embed_fwd_tc_plan``, ``embed_bwd_tc_plan``, ``head_fwd_tc_plan``,
``head_bwd_tc_plan``) wherever one of their forms holds the chain; any
chain no form holds runs the SIMT bodies
(``csrc/pathnet_f32.cu``: one for each of the four, the layer widths,
activations and layouts as arguments, every product a full f32 fused
multiply-add chain; ``embed_f32_plan`` and ``head_f32_plan`` give its
tiles, grid and shared memory), which ``body="simt"`` also selects.  The
plain versions round where the reference's Pallas kernels
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
from wcmc_tpu_torch.ops._tf32 import mm_k8, pack_b_tf32
from wcmc_tpu_torch.ops.conv5 import SMEM_LIMIT
from wcmc_tpu_torch.ops.kernel_apply import H100_SMS, SM_SMEM
from wcmc_tpu_torch.ops.mlp_fused import (
    ACTS, _act, _act_grad, _into, _mlp_bwd_rows, _mlp_plain, _prod, _r128, matmul_f32,
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


def _card_dtype(name, t):
    """The compute dtype of a K4 or K5 launch on ``t``: bfloat16 (the bf16
    bodies) or float32 (the f32 bodies); TypeError for any other."""
    if t.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name} kernel computes in bfloat16 or float32, got {t.dtype}")
    return t.dtype


def _check_embed_card(x, ws, acts):
    """What K4-fwd and K4-bwd compute in bf16: rows through three layers,
    widths multiples of 16; returns the layer widths and activation codes."""
    codes = _act_codes("pathnet_embed", acts, 3)
    _card_dtype("pathnet_embed", x)
    dims = [x.shape[-1]] + [w.shape[1] for w in ws]
    for w, ci, co in zip(ws, dims[:-1], dims[1:]):
        if tuple(w.shape) != (ci, co) or co % 16:
            raise ValueError(f"pathnet_embed: weight {tuple(w.shape)} is not "
                             f"({ci}, {co}) with {co} a multiple of 16")
    return dims, codes


def _check_head_card(e, acts):
    codes = _act_codes("pathnet_head", acts, 2)
    _card_dtype("pathnet_head", e)
    return codes


def _embed_fwd(x, ws, bs, acts):
    if x.device.type == "cpu":
        return _embed_plain(x, ws, bs, acts)
    return _embed_fwd_kernel(x, ws, bs, acts)


def _embed_fwd_kernel(x, ws, bs, acts, rows=False, body="tc"):
    """K4-fwd on the card.  bf16 ``x`` runs the body ``embed_fwd_plan``
    picks, or with ``rows`` the row-chunk body whatever the form (the card
    tests compare the two).  f32 ``x`` runs the tensor-core body
    (``body="tc"``) where one of its forms (``EMBED_TC_FORMS``) holds the
    chain, else the first f32 body, the SIMT one, which takes any chain up
    to 256 wide; ``body="simt"`` runs the SIMT body whatever the chain (the
    card tests' and ``chip_smoke.py``'s reference)."""
    dev = _require_cuda("pathnet_embed", x, *ws, *bs)
    if body not in ("tc", "simt"):
        raise ValueError(f"pathnet_embed: no f32 body {body!r}; 'tc' or 'simt'")
    if _card_dtype("pathnet_embed", x) == torch.float32:
        widths = [x.shape[-1]] + [w.shape[1] for w in ws]
        if body == "tc" and len(ws) == 3 and embed_tc_form(*widths):
            codes = _act_codes("pathnet_embed", acts, 3)
            return _embed_fwd_tc_kernel(x, ws, bs, codes, dev)
        return _embed_f32_kernel(x, ws, bs, acts, dev)
    dims, codes = _check_embed_card(x, ws, acts)
    b, s, hw, _ = x.shape
    plan = embed_fwd_plan(tuple(acts), *dims)
    e = torch.empty((b, s, hw, dims[-1]), dtype=torch.bfloat16, device=dev)
    mean = torch.empty((b, hw, dims[-1]), dtype=torch.float32, device=dev)
    P, INT = _build.PTR, _build.INT
    idx = dev.index or 0
    common = (b, s, hw, *dims, *codes, _build.sm_count(idx), idx, _build.stream_of(dev))
    if plan.tiled and not rows:
        # the pack K4-bwd reads, made once per parameter value (a train
        # step's backward finds the forward's); x 16-byte aligned
        wp, bp = _packed_embed(ws, bs)
        x = _aligned(x.contiguous())
        fn = _build.kernel("wcmc_pathnet_embed_tiled", *([P] * 5), *([INT] * 12), P)
        err = fn(x.data_ptr(), wp.data_ptr(), bp.data_ptr(), e.data_ptr(), mean.data_ptr(),
                 *common)
    else:
        x = x.contiguous()
        wb = [w.to(torch.bfloat16).contiguous() for w in ws]
        bf = [bb.float().contiguous() for bb in bs]
        fn = _build.kernel("wcmc_pathnet_embed", *([P] * 9), *([INT] * 12), P)
        err = fn(x.data_ptr(), wb[0].data_ptr(), bf[0].data_ptr(), wb[1].data_ptr(),
                 bf[1].data_ptr(), wb[2].data_ptr(), bf[2].data_ptr(), e.data_ptr(),
                 mean.data_ptr(), *common)
    _build.check(err, "pathnet_embed")
    _build.launches["pathnet_embed"] += 1
    return e, mean


def _head_fwd(e, ctx, ws, bs, acts, moments, cmajor, out_dtype):
    if e.device.type == "cpu":
        return _head_plain(e, ctx, ws, bs, acts, moments, cmajor, out_dtype)
    return _head_fwd_kernel(e, ctx, ws, bs, acts, moments, cmajor, out_dtype)


def _head_fwd_kernel(e, ctx, ws, bs, acts, moments, cmajor, out_dtype, wmma=False, body="tc"):
    """K5-fwd on the card.  bf16 ``e`` runs the body ``head_fwd_plan``
    picks, or with ``wmma`` the wmma body whatever the form (the card tests
    compare the two).  f32 ``e`` runs the tensor-core body (``body="tc"``)
    where one of its forms (``HEAD_TC_FORMS``) holds the head, else the
    first f32 body, the SIMT one, which takes any head up to 256 wide;
    ``body="simt"`` runs the SIMT body whatever the head (the card tests'
    and ``chip_smoke.py``'s reference)."""
    dev = _require_cuda("pathnet_head", e, ctx, *ws, *bs)
    codes = _check_head_card(e, acts)
    if body not in ("tc", "simt"):
        raise ValueError(f"pathnet_head: no f32 body {body!r}; 'tc' or 'simt'")
    b, s, hw, ce = e.shape
    cc = ctx.shape[-1]
    c1, cout = ws[0].shape[1], ws[1].shape[1]
    if (tuple(ctx.shape) != (b, hw, cc) or tuple(ws[0].shape) != (ce + cc, c1)
            or tuple(ws[1].shape) != (c1, cout)):
        raise ValueError("pathnet_head: shapes of e, ctx and the weights disagree")
    if e.dtype == torch.float32:
        if out_dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"pathnet_head kernel writes float32 or bfloat16, got {out_dtype}")
        if body == "tc" and head_tc_form(ce, cc, c1, cout):
            return _head_fwd_tc_kernel(e, ctx, ws, bs, codes, moments, cmajor, out_dtype, dev)
        return _head_f32_kernel(e, ctx, ws, bs, codes, moments, cmajor, out_dtype, dev)
    plan = head_fwd_plan(tuple(acts), ce, cc, c1, cout, out_dtype, cmajor)
    ctx = ctx.to(torch.bfloat16).contiguous()
    shape = (b, s, cout, hw) if cmajor else (b, s, hw, cout)
    out = torch.empty(shape, dtype=out_dtype, device=dev)
    ssum = ssq = None
    if moments:
        ssum = torch.empty((b, hw, cout), dtype=torch.float32, device=dev)
        ssq = torch.empty_like(ssum)
    P, INT = _build.PTR, _build.INT
    ptr = (lambda t: None if t is None else t.data_ptr())
    idx = dev.index or 0
    common = (b, s, hw, ce, cc, c1, cout, *codes, int(out_dtype == torch.bfloat16), int(cmajor),
              _build.sm_count(idx), idx, _build.stream_of(dev))
    if plan.tiled and not wmma:
        # the pack K5-bwd reads, made once per parameter value (a train
        # step's backward finds the forward's); rows 16-byte aligned
        wp, bp = _packed_head(ws, bs, acts, ce)
        e, ctx = _aligned(e.contiguous()), _aligned(ctx)
        fn = _build.kernel("wcmc_pathnet_head_tiled", *([P] * 7), *([INT] * 13), P)
        err = fn(e.data_ptr(), ctx.data_ptr(), wp.data_ptr(), bp.data_ptr(), out.data_ptr(),
                 ptr(ssum), ptr(ssq), *common)
    else:
        e = e.contiguous()
        w1, w2 = (w.to(torch.bfloat16).contiguous() for w in ws)
        b1, b2 = (bb.float().contiguous() for bb in bs)
        fn = _build.kernel("wcmc_pathnet_head", *([P] * 9), *([INT] * 13), P)
        err = fn(e.data_ptr(), ctx.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                 b2.data_ptr(), out.data_ptr(), ptr(ssum), ptr(ssq), *common)
    _build.check(err, "pathnet_head")
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
# K5-fwd's plan (csrc/pathnet_head.cu), kept here so the CPU tests reach it
# ---------------------------------------------------------------------------

# The forms K5-fwd runs on its tiled body: (activations, Ce = Cc, C1, the
# widest Cout, the output dtype, the e ring's stages).  Multisteps' update
# chain takes Cout 128 exactly, channels-last; the PathNet heads (KPCN's
# merged branches, LBMC's and SBMC's 64-wide one) Cout up to 16, in either
# layout, with or without moments.  Every other form runs the wmma body.
HEAD_FWD_TILED = {
    "multisteps": (LEAKY[:2], 128, 128, 128, torch.bfloat16, 2),
    "kpcn": (HEAD_ACTS, 128, 256, 16, torch.float32, 2),
    "pathnet64": (HEAD_ACTS, 64, 128, 16, torch.float32, 4),
}
HEAD_FWD_PIX = 64     # pixels of one image per unit of the tiled body; one sample a product
HEAD_WMMA_PIX = 32    # ... of the wmma body


class HeadFwdPlan(NamedTuple):
    """How K5-fwd runs a form: on the tiled body (``form``, a key of
    ``HEAD_FWD_TILED``) or the wmma one (``form`` None), ``pix`` pixels of
    one image per unit with its samples taken one at a time, ``workers``
    walkers a block (the tiled body's two warpgroups each walk their own
    units), ``stages`` e tiles in flight a walker, and the block's shared
    memory, ``smem`` as (buffer, bytes) pairs in the order the kernel
    carves them, each a multiple of 128 bytes, ``total`` their sum (what
    ``wcmc_pathnet_head_smem`` returns)."""
    tiled: bool
    form: str | None
    pix: int
    workers: int
    stages: int
    smem: tuple
    total: int


@functools.lru_cache(maxsize=None)
def head_fwd_plan(acts, ce, cc, c1, cout, out_dtype=torch.float32, cmajor=False) -> HeadFwdPlan:
    """K5-fwd's plan for a head [Ce | Cc] -> C1 -> Cout with activations
    ``acts``.  The tiled body: blocked W1e and W2, each warpgroup's ring of
    blocked e / context tiles, ctx . W1c + b1 in f32 (Multisteps only;
    PathNet keeps it in registers), h1 (Multisteps: also the staged bf16
    output, padded rows), PathNet's staged output and moments, the
    mbarriers.  The wmma body (32-pixel tiles): W1e, W1c and W2 in padded
    rows, ctx . W1c + b1, the e and h tiles, the warps' staging, the
    moments, b1 and b2.  ValueError (TypeError for the output dtype) for
    what neither body computes."""
    acts = tuple(acts)
    _act_codes("pathnet_head", acts, 2)
    if (min(ce, cc, c1) < 16 or ce % 16 or cc % 16 or c1 % 16 or cout < 1 or cout > HEAD_MAX_OUT
            or (cout > 16 and cout % 16)):
        raise ValueError("pathnet_head kernel needs Ce, Cc, C1 multiples of 16 and Cout "
                         f"<= 16 or a multiple of 16 up to {HEAD_MAX_OUT}, got {ce}, {cc}, "
                         f"{c1}, {cout}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"pathnet_head kernel writes float32 or bfloat16, got {out_dtype}")
    for form, (f_acts, f_ce, f_c1, f_cout, f_dtype, stages) in HEAD_FWD_TILED.items():
        wide = f_cout == 128
        if (acts == f_acts and ce == cc == f_ce and c1 == f_c1 and out_dtype == f_dtype
                and (cout == f_cout if wide else cout <= f_cout) and not (wide and cmajor)):
            tile, pix = 2 * HEAD_FWD_PIX * ce, HEAD_FWD_PIX
            smem = (("w1e", 2 * ce * c1), ("w2", 2 * c1 * f_cout), ("ring", 2 * stages * tile),
                    ("zc", 2 * 4 * pix * c1 if wide else 0),
                    ("h", 2 * max(2 * pix * c1, 2 * pix * (f_cout + 8) if wide else 0)),
                    ("out", 0 if wide else 2 * 4 * f_cout * (pix + 4)),
                    ("moments", 0 if wide else 2 * 2 * 4 * pix * f_cout),
                    ("bars", _r128(8 * (1 + 2 * stages))))
            return HeadFwdPlan(True, form, pix, 2, stages, smem, sum(n for _, n in smem))
    coutp, pix = -(-cout // 16) * 16, HEAD_WMMA_PIX
    smem = (("w1e", 2 * ce * (c1 + 8)), ("w1c", 2 * cc * (c1 + 8)), ("w2", 2 * c1 * (coutp + 8)),
            ("zc", 4 * pix * (c1 + 4)), ("e", 2 * pix * (ce + 8)), ("h", 2 * pix * (max(c1, cc) + 8)),
            ("stage", 4 * 8 * 256), ("sum", 4 * pix * coutp), ("sq", 4 * pix * coutp),
            ("b1", 4 * c1), ("b2", 4 * coutp))
    smem = tuple((name, _r128(n)) for name, n in smem)
    total = sum(n for _, n in smem)
    if total > SMEM_LIMIT:
        raise ValueError(f"pathnet_head kernel's wmma body needs {total} bytes of shared memory "
                         f"for [{ce} | {cc}] -> {c1} -> {cout}, over the {SMEM_LIMIT} a block "
                         "may use")
    return HeadFwdPlan(False, None, pix, 1, 1, smem, total)


def _head_fwd_walk(e, ctx, ws, bs, acts, moments=False, cmajor=False,
                   out_dtype=torch.float32, n_blocks=3):
    """A plain walk of K5-fwd's order on the CPU: the plan's walkers
    (``workers`` a block) take units of ``pix`` pixels of one image in
    turn; each unit computes ctx . W1c + b1 once (k16 step by k16 step from
    zero, then the bias), then its samples in order: z = that + e . W1e
    summed k16 step by k16 step into it, h1 = bf16(act(z)), o = act(h1 .
    W2 + b2) (from zero, k16 steps), the output o rounded to ``out_dtype``,
    and the moments sum_s o and sum_s o^2 added sample by sample from
    zero.  Returns what ``_head_plain`` returns."""
    dt = e.dtype
    b, s, hw, ce = e.shape
    cc = ctx.shape[-1]
    c1, cout = ws[1].shape
    plan = head_fwd_plan(tuple(acts), ce, cc, c1, cout, out_dtype, cmajor)
    w1e, w1c, w2 = ws[0][:ce].to(dt).float(), ws[0][ce:].to(dt).float(), ws[1].to(dt).float()
    b1, b2 = bs[0].float(), bs[1].float()
    out = torch.empty((b, s, hw, cout))
    ssum, ssq = torch.empty((b, hw, cout)), torch.empty((b, hw, cout))
    per_image = -(-hw // plan.pix)
    n_units = b * per_image
    walkers = min(plan.workers * n_blocks, n_units)
    for w in range(walkers):
        for t in range(w, n_units, walkers):
            bi, p0 = t // per_image, (t % per_image) * plan.pix
            p1 = min(p0 + plan.pix, hw)
            zc = _prod(ctx[bi, p0:p1].to(dt).float(), w1c) + b1
            msum, msq = torch.zeros((p1 - p0, cout)), torch.zeros((p1 - p0, cout))
            for si in range(s):
                h1 = _act(acts[0], _into(zc, e[bi, si, p0:p1].float(), w1e)).to(dt).float()
                o = _act(acts[1], _prod(h1, w2) + b2)
                out[bi, si, p0:p1] = o
                msum, msq = msum + o, msq + o * o
            ssum[bi, p0:p1], ssq[bi, p0:p1] = msum, msq
    res = out.to(out_dtype)
    res = res.transpose(2, 3) if cmajor else res
    return (res, ssum, ssq) if moments else res


# ---------------------------------------------------------------------------
# K5-bwd's layouts and plan (csrc/pathnet_head_bwd.cu), kept here so the
# CPU tests reach them
# ---------------------------------------------------------------------------

# The Multisteps form runs the tiled kernel at these widths (Ce = Cc = C1
# = 128, W2 staged 128 wide); narrower chains are zero-padded to them.
# PathNet's form runs its tiled kernel at Ce = Cc = 128 and C1 = 128 or
# PN_TILED_C1 (narrower heads zero-padded to them), the wmma body wider.
TILED_WIDTH = 128
PN_TILED_C1 = 256
# csrc/pathnet_head_bwd.cu's tiles: (pixels per tile, samples per chunk)
# of the tiled kernels (64 rows per product) and of the wmma PathNet body
TILED_TILE, PN_TILE, PATHNET_TILE = (32, 2), (16, 4), (16, 8)
TILED_STAGES = 2      # the e ring's stages
PACK_CACHE_SIZE = 16  # packed heads and embeddings kept (a train step has up to 6)


class HeadBwdPlan(NamedTuple):
    """How K5-bwd runs a form: on a tiled body (``tiled``; its rows
    pixel-major) or the wmma one, ``pix`` pixels of one image per tile,
    ``samples`` samples per chunk (``pix * samples`` rows per product),
    the block's shared memory, ``smem`` as (buffer, bytes) pairs, each
    rounded up to 128 bytes as the kernel carves them, ``total`` their sum,
    and ``widths``, the (Ce, Cc, C1) the kernel runs (zero-padded)."""
    tiled: bool
    pix: int
    samples: int
    smem: tuple
    total: int
    widths: tuple


@functools.lru_cache(maxsize=None)
def head_bwd_plan(acts, ce=TILED_WIDTH, cc=TILED_WIDTH, c1=TILED_WIDTH) -> HeadBwdPlan:
    """K5-bwd's plan for the form of ``acts`` (``HEAD_BWD_FORMS``) at
    widths Ce, Cc, C1.  The tiled form (Multisteps, always at 128): the
    packed W1e and W2, a ring of e tiles and the cotangent tile (blocked),
    h1 / g1 and bf16(gz2) (the first also the tile's [G_hi | G_lo], the
    second the staged d(e)), two context tiles, ctx . W1c + b1, G and gsum
    in f32, b2, the warps' running bias sums and the mbarriers.  PathNet's
    tiled form (Ce, Cc up to 128, C1 up to PN_TILED_C1): the packed W1e and
    W2, the e ring, h1 / g1 (also [G_hi | G_lo]), bf16(gz2), the staged
    d(e), two context tiles, ctx . W1c + b1 and G in f32, dW2 in f32, the
    chunk's cotangent and the tile's gsum and gsq, b2, the warps' running
    bias sums and the mbarriers.  Wider PathNet heads: the wmma body,
    csrc/pathnet_head_bwd.cu's pathnet_bwd_smem.  ``total`` is what
    wcmc_pathnet_head_bwd_smem of that file returns."""
    kout = HEAD_BWD_FORMS[tuple(acts)][0]
    if tuple(acts) == HEAD_ACTS and max(ce, cc) <= TILED_WIDTH and c1 <= PN_TILED_C1:
        w = TILED_WIDTH
        n1 = w if c1 <= w else PN_TILED_C1
        pix, samples = PN_TILE
        rows = pix * samples
        smem = (("w1e", 2 * w * n1), ("w2", 2 * n1 * kout), ("e", 2 * rows * 2 * w),
                ("h", max(2 * rows * n1, pix * 2 * (2 * n1 + 8))), ("gz", 2 * rows * kout),
                ("de", rows * 2 * (w + 8)), ("ctx", 2 * pix * 2 * (w + 8)),
                ("zc", pix * 4 * (n1 + 8)), ("G", pix * 4 * (n1 + 8)), ("dw2", 4 * n1 * kout),
                ("g", 4 * samples * kout * pix), ("gsum", 4 * pix * kout),
                ("gsq", 4 * pix * kout), ("b2", 4 * kout), ("db1", 4 * 8 * n1 // 2),
                ("db2", 4 * 8 * kout), ("bars", 8 * 7))
        smem = tuple((name, _r128(n)) for name, n in smem)
        return HeadBwdPlan(True, pix, samples, smem, sum(n for _, n in smem), (w, w, n1))
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
        tiled, widths = True, (w, w, w)
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
        tiled, widths = False, (ce, cc, c1)
    smem = tuple((name, _r128(n)) for name, n in smem)
    return HeadBwdPlan(tiled, pix, samples, smem, sum(n for _, n in smem), widths)


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
    the layout K5-bwd reads: ``(weights, biases)``, flat.  The tiled forms
    (widths zero-padded to ``head_bwd_plan``'s, Ce = Cc = 128 and C1 =
    n1): ``blocked(W1e) | blocked(W2) | frag_order(W1c) |
    frag_order(W1c^T)`` in ``dtype`` (the last two the B fragments of
    ctx . W1c and of G . W1c^T, read from device memory once per tile),
    and ``b1 | b2`` in f32, b1 n1 wide.  the wmma PathNet body: ``W1 | W2``
    with W2's columns zero-padded to 16, and ``b1 | b2`` likewise."""
    w1, w2 = ws
    b1, b2 = bs
    kout = HEAD_BWD_FORMS[tuple(acts)][0]
    c1, cout = w2.shape
    cc = w1.shape[0] - ce
    dev = w1.device
    plan = head_bwd_plan(tuple(acts), ce, cc, c1)
    if plan.tiled:
        n, _, n1 = plan.widths
        w1e = torch.zeros((n, n1), dtype=dtype, device=dev)
        w1e[:ce, :c1] = w1[:ce]
        w1c = torch.zeros((n, n1), dtype=dtype, device=dev)
        w1c[:cc, :c1] = w1[ce:]
        w2p = torch.zeros((n1, kout), dtype=dtype, device=dev)
        w2p[:c1, :cout] = w2
        wp = torch.cat([blocked(w1e).reshape(-1), blocked(w2p).reshape(-1),
                        frag_order(w1c).reshape(-1), frag_order(w1c.t()).reshape(-1)])
        bp = torch.zeros(n1 + kout, dtype=torch.float32, device=dev)
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
    plan = head_bwd_plan(tuple(acts), ce, cc, c1)
    if plan.tiled:
        n, _, n1 = plan.widths
        w1e, w2, fc, fct = torch.split(wp, [n * n1, n1 * kout, n * n1, n * n1])
        w1c = unfrag_order(fc.view(n // 16, n1 // 8, 32, 4))
        if not torch.equal(unfrag_order(fct.view(n1 // 16, n // 8, 32, 4)).t(), w1c):
            raise ValueError("the packed W1c and W1c^T fragments disagree")
        w1 = torch.cat([unblocked(w1e.view(n // 8, n1 // 8, 8, 8))[:ce, :c1], w1c[:cc, :c1]])
        w2 = unblocked(w2.view(n1 // 8, kout // 8, 8, 8))[:c1, :cout]
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


def _head_bwd_walk(e, ctx, g, gsum, gsq, ws, bs, acts, cmajor=False, n_blocks=3):
    """A plain walk of K5-bwd's order on the CPU: persistent blocks take
    pixel tiles in turn (``head_bwd_plan``'s tile and chunk), each tile
    computes ctx . W1c + b1 once, then its samples in chunks (the tiled
    form's rows pixel-major: pixel by pixel, the chunk's samples of each):
    h1, h2 and the cotangent, dW2, g1, the sum G of bf16(g1) over the
    samples in sample order, dW1e and de, every product summed k16 step by
    k16 step into its accumulator (PathNet's tiled form: dW2 as one
    product per chunk, added to the block's); at the tile's end d(ctx) (the hi and lo
    terms of each k16 step in turn) and dW1c from G = hi + lo (hi =
    bf16(G), lo = bf16(G - hi)).  Each block's weight and bias
    gradients are its partials, summed in block order.  Returns what
    ``_head_bwd_plain`` returns."""
    dt = e.dtype
    b, s, hw, ce = e.shape
    cc = ctx.shape[-1]
    c1, cout = ws[1].shape
    plan = head_bwd_plan(tuple(acts), ce, cc, c1)
    pn = plan.tiled and tuple(acts) == HEAD_ACTS
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
                dw2 = dw2 + _prod(h1.t(), gzc) if pn else _into(dw2, h1.t(), gzc)
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
# holds it, or, above the last, to slabs of that width; tiles of (pixels,
# samples per chunk): 64 rows per product.  It takes Multisteps' form and
# PathNet's chains up to EMBED_BWD_PATHNET_TILED wide (KPCN's merged
# branches, LBMC's and SBMC's PathNet); wider PathNet chains run the
# row-chunk body (csrc/pathnet_embed_bwd.cu).
EMBED_BWD_WIDTH = 128
EMBED_BWD_K0 = (48, 96)
EMBED_BWD_TILE = (32, 2)
EMBED_BWD_PATHNET_TILED = 128


class EmbedBwdPlan(NamedTuple):
    """How K4-bwd runs rows of C0 values: C0 padded to ``k0``, taken in
    slabs of ``slab`` columns (``k0`` itself up to 96, 96 above: W0's slab
    and the chunk's x slab loaded for each slab's products), ``pix``
    pixels of one image per tile, ``samples`` samples per chunk, and the
    block's shared memory, ``smem`` as (buffer, bytes) pairs, each rounded
    up to 128 bytes as the kernel carves them, ``total`` their sum."""
    k0: int
    pix: int
    samples: int
    smem: tuple
    total: int
    slab: int


@functools.lru_cache(maxsize=None)
def embed_bwd_plan(c0) -> EmbedBwdPlan:
    """K4-bwd's plan for rows of ``c0`` values: the packed W0 (a slab of
    it, k0 or 96 x 128), W1 and W2, the landing stage of the chunk's x
    spans and the blocked x tile, the cotangent tile (ge, then g3), h1 /
    g1, h2 / g2 (then the staged d(x)), dW0^T and the tile's gmean / S in
    f32, the biases and the mbarriers.  ``total`` is what
    wcmc_pathnet_embed_bwd_smem returns.  Above 96 columns the carve is
    the 96 one's, and the block's dW0 is added to in its partial in device
    memory, chunk by chunk."""
    if c0 < 1:
        raise ValueError(f"pathnet_embed_bwd kernel takes 1 or more input channels, got {c0}")
    top = EMBED_BWD_K0[-1]
    k0 = next((k for k in EMBED_BWD_K0 if c0 <= k), -(-c0 // top) * top)
    slab = min(k0, top)
    w = EMBED_BWD_WIDTH
    pix, samples = EMBED_BWD_TILE
    rows = pix * samples
    smem = (("w0", 2 * slab * w), ("w1", 2 * w * w), ("w2", 2 * w * w), ("x_in", 2 * rows * slab),
            ("x", 2 * rows * slab), ("g", 2 * rows * w), ("h1", 2 * rows * w),
            ("h2", 2 * rows * w), ("dw0", 4 * w * slab), ("gmean", 4 * pix * w),
            ("bias", 4 * 3 * w), ("bars", 8 * 4))
    smem = tuple((name, _r128(n)) for name, n in smem)
    return EmbedBwdPlan(k0, pix, samples, smem, sum(n for _, n in smem), slab)


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


# ---------------------------------------------------------------------------
# K4-fwd's plan (csrc/pathnet_embed.cu), kept here so the CPU tests reach it
# ---------------------------------------------------------------------------

# The forms K4-fwd runs on its tiled body: (activations, C1 = C2 = C3), each
# for C0 up to EMBED_BWD_K0[-1] (padded to the first of EMBED_BWD_K0 that
# holds it): Multisteps' embedding, KPCN's merged PathNet branches and the
# 64-wide PathNet (LBMC's, SBMC's).  Every other form runs the row-chunk body.
EMBED_FWD_TILED = {
    "multisteps": (LEAKY, 128),
    "kpcn": (EMBED_ACTS, 128),
    "pathnet64": (EMBED_ACTS, 64),
}
EMBED_FWD_PIX = 64    # pixels of one image per unit (tiled body) or tile (row-chunk body)


class EmbedFwdPlan(NamedTuple):
    """How K4-fwd runs a form: on the tiled body (``form``, a key of
    ``EMBED_FWD_TILED``) or the row-chunk one (``form`` None), C0 padded to
    ``k0``, ``pix`` pixels of one image per unit with its samples taken one
    at a time, ``workers`` walkers a block (the tiled body's two
    warpgroups each walk their own units), ``stages`` x spans in flight a
    walker, and the block's shared memory, ``smem`` as (buffer, bytes)
    pairs in the order the kernel carves them, each a multiple of 128
    bytes, ``total`` their sum (what ``wcmc_pathnet_embed_tiled_smem``
    returns)."""
    tiled: bool
    form: str | None
    k0: int
    pix: int
    workers: int
    stages: int
    smem: tuple
    total: int


@functools.lru_cache(maxsize=None)
def embed_fwd_plan(acts, c0, c1, c2, c3) -> EmbedFwdPlan:
    """K4-fwd's plan for an embedding C0 -> C1 -> C2 -> C3 with
    activations ``acts``.  The tiled body: blocked W0 (k0 x 128, the pack's
    full width), the first C rows of blocked W1 and W2, the biases, each
    warpgroup's ring of x landing stages (3 at k0 96, 4 at 48) and its two
    staged e tiles, the mbarriers.  The row-chunk body: W0, W1 and W2 in
    padded rows, the x, h1 and h2 tiles, the warps' staging, the mean and
    the biases.  ValueError for what neither body computes."""
    acts = tuple(acts)
    _act_codes("pathnet_embed", acts, 3)
    if c0 < 1 or min(c1, c2, c3) < 16 or c1 % 16 or c2 % 16 or c3 % 16:
        raise ValueError("pathnet_embed kernel needs C0 >= 1 and C1, C2, C3 multiples of 16, "
                         f"got {c0}, {c1}, {c2}, {c3}")
    pix, n = EMBED_FWD_PIX, EMBED_BWD_WIDTH
    for form, (f_acts, width) in EMBED_FWD_TILED.items():
        if acts == f_acts and c1 == c2 == c3 == width and c0 <= EMBED_BWD_K0[-1]:
            k0 = next(k for k in EMBED_BWD_K0 if c0 <= k)
            stages = 3 if k0 == EMBED_BWD_K0[-1] else 4
            smem = (("w0", 2 * k0 * n), ("w1", 2 * width * n), ("w2", 2 * width * n),
                    ("bias", 4 * 3 * n), ("ring", 2 * stages * 2 * pix * k0),
                    ("e", 2 * 2 * 2 * pix * width), ("bars", _r128(8 * (1 + 2 * stages))))
            return EmbedFwdPlan(True, form, k0, pix, 2, stages, smem, sum(m for _, m in smem))
    k0 = -(-c0 // 16) * 16
    smem = (("w0", 2 * k0 * (c1 + 8)), ("w1", 2 * c1 * (c2 + 8)), ("w2", 2 * c2 * (c3 + 8)),
            ("x", 2 * pix * (k0 + 8)), ("h1", 2 * pix * (c1 + 8)), ("h2", 2 * pix * (c2 + 8)),
            ("stage", 4 * 8 * 256), ("mean", 4 * pix * c3), ("b0", 4 * c1), ("b1", 4 * c2),
            ("b2", 4 * c3))
    smem = tuple((name, _r128(m)) for name, m in smem)
    total = sum(m for _, m in smem)
    if total > SMEM_LIMIT:
        raise ValueError(f"pathnet_embed kernel's row-chunk body needs {total} bytes of shared "
                         f"memory for {c0} -> {c1} -> {c2} -> {c3}, over the {SMEM_LIMIT} a "
                         "block may use")
    return EmbedFwdPlan(False, None, k0, pix, 1, 1, smem, total)


def _embed_fwd_walk(x, ws, bs, acts, n_blocks=3):
    """A plain walk of K4-fwd's order on the CPU: the plan's walkers
    (``workers`` a block) take units of ``pix`` pixels of one image in
    turn, and each unit its samples in order: every layer summed k16 step
    by k16 step from zero, then its bias, its activation and the rounding
    to x's dtype; the mean added sample by sample, f32(e) * (1 / S) rounded
    to f32 and then added (the first sample's taken as it is).  Returns
    what ``_embed_plain`` returns."""
    dt = x.dtype
    b, s, hw, c0 = x.shape
    c3 = ws[-1].shape[1]
    plan = embed_fwd_plan(tuple(acts), c0, *(w.shape[1] for w in ws))
    wt = [w.to(dt).float() for w in ws]
    bias = [bb.float() for bb in bs]
    inv_s = torch.tensor(1.0 / s, dtype=torch.float32)
    e = torch.empty((b, s, hw, c3))
    mean = torch.empty((b, hw, c3))
    per_image = -(-hw // plan.pix)
    n_units = b * per_image
    walkers = min(plan.workers * n_blocks, n_units)
    for w in range(walkers):
        for t in range(w, n_units, walkers):
            bi, p0 = t // per_image, (t % per_image) * plan.pix
            p1 = min(p0 + plan.pix, hw)
            for si in range(s):
                h = x[bi, si, p0:p1].float()
                for wi, bb, a in zip(wt, bias, acts):
                    h = _act(a, _prod(h, wi) + bb).to(dt).float()
                e[bi, si, p0:p1] = h
                contrib = h * inv_s
                m = contrib if si == 0 else m + contrib
            mean[bi, p0:p1] = m
    return e.to(dt), mean


def _embed_bwd_walk(x, ge, gmean, ws, bs, acts, compute_dx=False, n_blocks=3):
    """A plain walk of K4-bwd's order on the CPU: persistent blocks take
    pixel tiles in turn (``embed_bwd_plan``'s tile), each tile its samples
    in chunks, rows sample-major: the hiddens recomputed, g3 from ge +
    gmean / S, dW2, g2, dW1, g1, each weight-gradient product summed k16
    step by k16 step (of the chunk's rows) into its block-long accumulator;
    dW0^T = g1^T . x as one product per chunk (per slab above 96 columns),
    added to the block's dW0^T; d(x) per chunk.  The layer-1 product
    sums the k16 steps of all slabs in order, as one product.  Each block's weight and bias gradients are its
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


def _embed_bwd_kernel(x, ge, gmean, ws, bs, acts, compute_dx, body="tc"):
    """K4-bwd on the card.  f32 ``x`` runs the tensor-core body
    (``body="tc"``) where one of its forms (``EMBED_TC_FORMS``) holds the
    chain, else the first f32 body, the SIMT one, which takes any chain up
    to 256 wide; ``body="simt"`` runs the SIMT body whatever the chain (the
    card tests' and ``chip_smoke.py``'s reference).  bf16 ``x`` runs the
    bf16 bodies."""
    dev = _require_cuda("pathnet_embed_bwd", x, *ws, *bs)
    if body not in ("tc", "simt"):
        raise ValueError(f"pathnet_embed_bwd: no f32 body {body!r}; 'tc' or 'simt'")
    if _card_dtype("pathnet_embed_bwd", x) == torch.float32:
        widths = [x.shape[-1]] + [w.shape[1] for w in ws]
        if body == "tc" and len(ws) == 3 and embed_tc_form(*widths):
            codes = _act_codes("pathnet_embed_bwd", acts, 3)
            return _embed_bwd_tc_kernel(x, ge, gmean, ws, bs, codes, compute_dx, dev)
        return _embed_bwd_f32_kernel(x, ge, gmean, ws, bs, acts, compute_dx, dev)
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


def _head_bwd_kernel(e, ctx, g, gsum, gsq, ws, bs, acts, cmajor, body="tc"):
    """K5-bwd on the card.  f32 ``e`` runs the tensor-core body
    (``body="tc"``) where one of its forms holds the head, else the first
    f32 body, the SIMT one, which takes any head up to 256 wide (a dual
    PathNet head with more than 8 outputs a branch); ``body="simt"`` runs
    the SIMT body whatever the head (the card tests' and
    ``chip_smoke.py``'s reference).  bf16 ``e`` runs the bf16 bodies."""
    dev = _require_cuda("pathnet_head_bwd", e, ctx, *ws, *bs)
    codes = _check_head_card(e, acts)
    if body not in ("tc", "simt"):
        raise ValueError(f"pathnet_head_bwd: no f32 body {body!r}; 'tc' or 'simt'")
    b, s, hw, ce = e.shape
    cc = ctx.shape[-1]
    c1, cout = ws[0].shape[1], ws[1].shape[1]
    if e.dtype == torch.float32 and body == "tc" and head_tc_form(ce, cc, c1, cout):
        return _head_bwd_tc_kernel(e, ctx, g, gsum, gsq, ws, bs, codes, cmajor, dev)
    if e.dtype == torch.float32:
        return _head_bwd_f32_kernel(e, ctx, g, gsum, gsq, ws, bs, codes, cmajor, dev)
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
    multisteps = tuple(acts) == LEAKY[:2]
    if multisteps and max(ce, cc, c1) > TILED_WIDTH:
        raise ValueError(f"pathnet_head_bwd kernel's {tuple(acts)} form takes Ce, Cc, C1 up "
                         f"to {TILED_WIDTH}, got {ce}, {cc}, {c1}")
    f32, bf = torch.float32, torch.bfloat16
    wp, bp = _packed_head(ws, bs, acts, ce)
    # the cotangents as they come (PathNet's kernels read either layout,
    # the Multisteps one channels-last); None is zero
    if g is not None:
        g = g.to(g_dtype)
        g = (g.transpose(2, 3) if cmajor and multisteps else g).contiguous()
    gsum, gsq = (None if t is None else t.float().contiguous() for t in (gsum, gsq))
    e = e.contiguous()
    ctx = ctx.to(bf).contiguous()
    dims = plan.widths
    if plan.tiled:   # a narrower head runs zero-padded to the tiled widths (exact)
        # the tiled kernels' copies need 16-byte aligned rows
        e, ctx = (_aligned(_pad_last(t, dims[0])) for t in (e, ctx))
        if multisteps:
            g, gsum, gsq = (None if t is None else _aligned(_pad_last(t, kout))
                            for t in (g, gsum, gsq))
        elif g is not None:
            g = _aligned(g)
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
                    int(cmajor and not multisteps), n_blocks, idx, _build.stream_of(dev)),
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


# ---------------------------------------------------------------------------
# the f32 bodies (csrc/pathnet_f32.cu): plans and wrappers
# ---------------------------------------------------------------------------

F32_ROWS = 32          # pixels of one image a tile of the f32 bodies: a product's rows
F32_MAX_WIDTH = 256    # the widest layer they take


class F32Plan(NamedTuple):
    """How an f32 body of K4 or K5 runs: tiles of ``rows`` pixels of one
    image walked by ``blocks`` persistent blocks (``per_sm`` resident an
    SM), each tile its samples in order; ``smem`` the block's shared
    memory as (buffer, bytes) pairs in the order the kernel carves them,
    each a multiple of 128 bytes, ``total`` their sum (what
    ``wcmc_pathnet_embed_f32_smem`` / ``wcmc_pathnet_head_f32_smem``
    return).  The backward bodies keep one f32 partial of the weight and
    bias gradients a block, ``parts`` floats each."""
    rows: int
    per_sm: int
    blocks: int
    smem: tuple
    total: int
    parts: int


def _f32_plan(name, b, hw, smem, parts, sms):
    smem = tuple((n, _r128(4 * F32_ROWS * c)) for n, c in smem)
    total = sum(m for _, m in smem)
    if total > SMEM_LIMIT:
        raise ValueError(f"{name} f32 body needs {total} bytes of shared memory, over the "
                         f"{SMEM_LIMIT} a block may use")
    per_sm = min(2, SM_SMEM // (total + 1024))
    tiles = b * -(-hw // F32_ROWS)
    return F32Plan(F32_ROWS, per_sm, max(1, min(tiles, per_sm * sms)), smem, total, parts)


def _f32_widths(name, widths):
    if any(not 1 <= c <= F32_MAX_WIDTH for c in widths):
        raise ValueError(f"{name} f32 body takes widths 1 to {F32_MAX_WIDTH}, got {widths}")


@functools.lru_cache(maxsize=None)
def embed_f32_plan(b, hw, c0, c1, c2, c3, sms=H100_SMS) -> F32Plan:
    """The f32 body of K4-fwd and K4-bwd for (b, ., hw) rows of an
    embedding C0 -> C1 -> C2 -> C3: the x, h1 and h2 tiles and the fourth
    (the running sum forward, the cotangent backward), 32 rows each; two
    blocks an SM where two fit.  ValueError for widths outside 1-256."""
    _f32_widths("pathnet_embed", (c0, c1, c2, c3))
    return _f32_plan("pathnet_embed", b, hw, (("x", c0), ("h1", c1), ("h2", c2), ("out", c3)),
                     c0 * c1 + c1 * c2 + c2 * c3 + c1 + c2 + c3, sms)


@functools.lru_cache(maxsize=None)
def head_f32_plan(b, hw, ce, cc, c1, cout, moments=False, bwd=False, sms=H100_SMS) -> F32Plan:
    """The f32 body of K5-fwd (``bwd`` False) or K5-bwd for a head [Ce | Cc]
    -> C1 -> Cout over (b, ., hw) rows: the context tile, ctx . W1c, the e
    and h1 tiles, and forward the running sum and sum of squares (with
    ``moments``), backward G = sum_s g1 and the cotangent, gsum and gsq
    tiles; 32 rows each.  ValueError for widths outside 1-256 or a carve
    over a block's shared memory."""
    _f32_widths("pathnet_head", (ce, cc, c1, cout))
    smem = (("ctx", cc), ("zc", c1), ("e", ce), ("h", c1))
    if bwd:
        smem += (("G", c1), ("g", cout), ("gsum", cout), ("gsq", cout))
    elif moments:
        smem += (("sum", cout), ("sq", cout))
    return _f32_plan("pathnet_head", b, hw, smem, (ce + cc) * c1 + c1 * cout + c1 + cout, sms)


def _f32_dims(name, c0, ws):
    dims = [c0] + [w.shape[1] for w in ws]
    for w, ci, co in zip(ws, dims[:-1], dims[1:]):
        if tuple(w.shape) != (ci, co):
            raise ValueError(f"{name}: weight {tuple(w.shape)} is not ({ci}, {co})")
    return dims


def _f32(ts):
    return [t.float().contiguous() for t in ts]


def _embed_f32_kernel(x, ws, bs, acts, dev):
    """K4-fwd's f32 body (``embed_f32_plan``)."""
    codes = _act_codes("pathnet_embed", acts, 3)
    b, s, hw, c0 = x.shape
    dims = _f32_dims("pathnet_embed", c0, ws)
    idx = dev.index or 0
    plan = embed_f32_plan(b, hw, *dims, sms=_build.sm_count(idx))
    x = x.contiguous()
    wf, bf = _f32(ws), _f32(bs)
    e = torch.empty((b, s, hw, dims[-1]), dtype=torch.float32, device=dev)
    mean = torch.empty((b, hw, dims[-1]), dtype=torch.float32, device=dev)
    P, INT = _build.PTR, _build.INT
    fn = _build.kernel("wcmc_pathnet_embed_f32", *([P] * 9), *([INT] * 12), P)
    _build.check(fn(x.data_ptr(), wf[0].data_ptr(), bf[0].data_ptr(), wf[1].data_ptr(),
                    bf[1].data_ptr(), wf[2].data_ptr(), bf[2].data_ptr(), e.data_ptr(),
                    mean.data_ptr(), b, s, hw, *dims, *codes, plan.blocks, idx,
                    _build.stream_of(dev)), "pathnet_embed")
    _build.launches["pathnet_embed"] += 1
    return e, mean


def _embed_bwd_f32_kernel(x, ge, gmean, ws, bs, acts, compute_dx, dev):
    """K4-bwd's f32 body: any chain, d(x) where asked; the cotangents read
    as f32, None as zero; the weights' transposes made here."""
    codes = _act_codes("pathnet_embed_bwd", acts, 3)
    b, s, hw, c0 = x.shape
    dims = _f32_dims("pathnet_embed_bwd", c0, ws)
    c3 = dims[-1]
    if ((ge is not None and tuple(ge.shape) != (b, s, hw, c3))
            or (gmean is not None and tuple(gmean.shape) != (b, hw, c3))):
        raise ValueError("pathnet_embed_bwd: cotangent shapes do not match the embedding")
    idx = dev.index or 0
    plan = embed_f32_plan(b, hw, *dims, sms=_build.sm_count(idx))
    x = x.contiguous()
    wf, bf = _f32(ws), _f32(bs)
    wt = [w.t().contiguous() for w in wf]
    ge, gmean = (None if t is None else t.float().contiguous() for t in (ge, gmean))
    dx = torch.empty_like(x) if compute_dx else None
    parts = torch.empty(plan.blocks * plan.parts, dtype=torch.float32, device=dev)
    out = torch.empty(plan.parts, dtype=torch.float32, device=dev)
    P, INT = _build.PTR, _build.INT
    ptr = (lambda t: None if t is None else t.data_ptr())
    fn = _build.kernel("wcmc_pathnet_embed_bwd_f32", *([P] * 15), *([INT] * 12), P)
    _build.check(fn(x.data_ptr(), ptr(ge), ptr(gmean), wf[0].data_ptr(), bf[0].data_ptr(),
                    wf[1].data_ptr(), bf[1].data_ptr(), wf[2].data_ptr(), bf[2].data_ptr(),
                    wt[0].data_ptr(), wt[1].data_ptr(), wt[2].data_ptr(), ptr(dx),
                    parts.data_ptr(), out.data_ptr(), b, s, hw, *dims, *codes, plan.blocks,
                    idx, _build.stream_of(dev)), "pathnet_embed_bwd")
    _build.launches["pathnet_embed_bwd"] += 1
    c0, c1, c2, c3 = dims
    dw0, dw1, dw2, db0, db1, db2 = torch.split(out, [c0 * c1, c1 * c2, c2 * c3, c1, c2, c3])
    return dx, [dw0.view(c0, c1), dw1.view(c1, c2), dw2.view(c2, c3)], [db0, db1, db2]


def _head_f32_kernel(e, ctx, ws, bs, codes, moments, cmajor, out_dtype, dev):
    """K5-fwd's f32 body (``head_f32_plan``): the context read as f32, the
    output written as ``out_dtype`` (f32 or bf16), the moments of the
    unrounded f32 output."""
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"pathnet_head kernel writes float32 or bfloat16, got {out_dtype}")
    b, s, hw, ce = e.shape
    cc, (c1, cout) = ctx.shape[-1], ws[1].shape
    idx = dev.index or 0
    plan = head_f32_plan(b, hw, ce, cc, c1, cout, moments, sms=_build.sm_count(idx))
    e, ctx = e.contiguous(), ctx.float().contiguous()
    (w1, w2), (b1, b2) = _f32(ws), _f32(bs)
    shape = (b, s, cout, hw) if cmajor else (b, s, hw, cout)
    out = torch.empty(shape, dtype=out_dtype, device=dev)
    ssum = ssq = None
    if moments:
        ssum = torch.empty((b, hw, cout), dtype=torch.float32, device=dev)
        ssq = torch.empty_like(ssum)
    P, INT = _build.PTR, _build.INT
    ptr = (lambda t: None if t is None else t.data_ptr())
    fn = _build.kernel("wcmc_pathnet_head_f32", *([P] * 9), *([INT] * 13), P)
    _build.check(fn(e.data_ptr(), ctx.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                    b2.data_ptr(), out.data_ptr(), ptr(ssum), ptr(ssq), b, s, hw, ce, cc, c1,
                    cout, *codes, int(out_dtype == torch.bfloat16), int(cmajor), plan.blocks,
                    idx, _build.stream_of(dev)), "pathnet_head")
    _build.launches["pathnet_head"] += 1
    return (out, ssum, ssq) if moments else out


def _head_bwd_f32_kernel(e, ctx, g, gsum, gsq, ws, bs, codes, cmajor, dev):
    """K5-bwd's f32 body: any head; the cotangents read as f32 (the
    output's in its layout), None as zero; the weights' transposes made
    here."""
    b, s, hw, ce = e.shape
    cc, (c1, cout) = ctx.shape[-1], ws[1].shape
    g_shape = (b, s, cout, hw) if cmajor else (b, s, hw, cout)
    if (tuple(ctx.shape) != (b, hw, cc) or tuple(ws[0].shape) != (ce + cc, c1)
            or (g is not None and tuple(g.shape) != g_shape)
            or any(m is not None and tuple(m.shape) != (b, hw, cout) for m in (gsum, gsq))):
        raise ValueError("pathnet_head_bwd: shapes of e, ctx, the weights and the "
                         "cotangents disagree")
    idx = dev.index or 0
    plan = head_f32_plan(b, hw, ce, cc, c1, cout, bwd=True, sms=_build.sm_count(idx))
    e, ctx = e.contiguous(), ctx.float().contiguous()
    (w1, w2), (b1, b2) = _f32(ws), _f32(bs)
    w1et, w1ct, w2t = w1[:ce].t().contiguous(), w1[ce:].t().contiguous(), w2.t().contiguous()
    g, gsum, gsq = (None if t is None else t.float().contiguous() for t in (g, gsum, gsq))
    de = torch.empty_like(e)
    dctx = torch.empty((b, hw, cc), dtype=torch.float32, device=dev)
    parts = torch.empty(plan.blocks * plan.parts, dtype=torch.float32, device=dev)
    out = torch.empty(plan.parts, dtype=torch.float32, device=dev)
    P, INT = _build.PTR, _build.INT
    ptr = (lambda t: None if t is None else t.data_ptr())
    fn = _build.kernel("wcmc_pathnet_head_bwd_f32", *([P] * 16), *([INT] * 12), P)
    _build.check(fn(e.data_ptr(), ctx.data_ptr(), ptr(g), ptr(gsum), ptr(gsq), w1.data_ptr(),
                    b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), w1et.data_ptr(),
                    w1ct.data_ptr(), w2t.data_ptr(), de.data_ptr(), dctx.data_ptr(),
                    parts.data_ptr(), out.data_ptr(), b, s, hw, ce, cc, c1, cout, *codes,
                    int(cmajor), plan.blocks, idx, _build.stream_of(dev)), "pathnet_head_bwd")
    _build.launches["pathnet_head_bwd"] += 1
    dw1, dw2, db1, db2 = torch.split(out, [(ce + cc) * c1, c1 * cout, c1, cout])
    return de, dctx, [dw1.view(ce + cc, c1), dw2.view(c1, cout)], [db1, db2]


# ---------------------------------------------------------------------------
# K5-bwd's tensor-core f32 body (csrc/pathnet_head_bwd_tf32.cu): forms, plan,
# weight pack, walk and wrapper
# ---------------------------------------------------------------------------

# (Ce = Cc, C1, Cout padded) of the body's instantiations: KPCN's head and
# the 64-wide PathNet's, each for Cout up to 8 and up to 16 (what the bf16
# body takes), Multisteps' update chain
HEAD_TC_FORMS = ((128, 256, 8), (128, 256, 16), (64, 128, 8), (64, 128, 16), (128, 128, 128))
HEAD_TC_PIX, HEAD_TC_SAMPLES = 16, 4   # a tile's pixels; a chunk's samples (64 rows)
# a k8 step of a warp's ring of weight fragments, in floats: 4 n8 tiles x 32
# lanes x 4; 8 warps
HEAD_TC_RING_STEP, HEAD_TC_WARPS = 4 * 32 * 4, 8


class HeadTcPlan(NamedTuple):
    """How K5-bwd's tensor-core f32 body runs a head: the instantiation
    ``form`` (Ce = Cc, C1, Cout padded) its widths are zero-padded to;
    ``blocks`` persistent blocks (one an SM) over ``tiles`` tiles of 16
    pixels, each tile its samples in chunks of 4; ``smem`` the block's
    shared memory as (buffer, bytes) pairs in the kernel's carve order,
    each a multiple of 128 bytes, ``total`` their sum (what
    ``wcmc_pathnet_head_bwd_tf32_smem`` returns); ``ring`` the k8 steps
    each warp's ring of weight fragments holds (three where they fit, else
    two); ``parts`` the floats of a block's partial (dW1e | dW1c | dW2 |
    db1 | db2 at the padded widths)."""
    form: tuple
    tiles: int
    blocks: int
    smem: tuple
    total: int
    ring: int
    parts: int


def head_tc_form(ce, cc, c1, cout):
    """The cheapest instantiation of ``HEAD_TC_FORMS`` that holds the head
    (by multiply-adds a row at the padded widths), None if none does;
    ValueError for a width below 1."""
    if min(ce, cc, c1, cout) < 1:
        raise ValueError(f"pathnet_head_bwd: widths (Ce, Cc, C1, Cout) {(ce, cc, c1, cout)}")
    fits = [f for f in HEAD_TC_FORMS if max(ce, cc) <= f[0] and c1 <= f[1] and cout <= f[2]]
    return min(fits, key=lambda f: f[0] * f[1] + f[1] * f[2]) if fits else None


def _tc_pitch(c):
    return c if c == 8 else c + 8


@functools.lru_cache(maxsize=None)
def head_bwd_tc_plan(b, hw, ce, cc, c1, cout, sms=H100_SMS) -> HeadTcPlan:
    """K5-bwd's tensor-core body for (b, ., hw) rows of a head [Ce | Cc] ->
    C1 -> Cout: the form, the grid, and the carve: e twice (the chunk and
    the next), h1 / g1 and g / gz at 64 rows, the context, ctx . W1c, G,
    gsum and gsq at 16 pixels, f32, rows at a pitch of the width + 8 floats
    (8 for a width of 8); then the warps' rings of weight fragments, three
    k8 steps deep where the block's shared memory holds them, else two.
    ValueError for a head no form holds."""
    form = head_tc_form(ce, cc, c1, cout)
    if form is None:
        raise ValueError(f"pathnet_head_bwd tf32 body takes heads up to one of {HEAD_TC_FORMS} "
                         f"(Ce = Cc, C1, Cout), got {(ce, cc, c1, cout)}")
    kce, kc1, kout = form
    rows = HEAD_TC_PIX * HEAD_TC_SAMPLES
    smem = (("e0", rows * _tc_pitch(kce)), ("e1", rows * _tc_pitch(kce)),
            ("h", rows * _tc_pitch(kc1)), ("g", rows * _tc_pitch(kout)),
            ("ctx", HEAD_TC_PIX * _tc_pitch(kce)), ("zc", HEAD_TC_PIX * _tc_pitch(kc1)),
            ("G", HEAD_TC_PIX * _tc_pitch(kc1)), ("gsum", HEAD_TC_PIX * kout),
            ("gsq", HEAD_TC_PIX * kout))
    smem = tuple((n, _r128(4 * c)) for n, c in smem)
    tiles_bytes = sum(m for _, m in smem)
    ring = 3 if tiles_bytes + _r128(4 * HEAD_TC_WARPS * 3 * HEAD_TC_RING_STEP) <= SMEM_LIMIT \
        else 2
    smem += (("ring", _r128(4 * HEAD_TC_WARPS * ring * HEAD_TC_RING_STEP)),)
    tiles = b * -(-hw // HEAD_TC_PIX)
    return HeadTcPlan(form, tiles, max(1, min(tiles, sms)), smem, sum(m for _, m in smem), ring,
                      2 * kce * kc1 + kc1 * kout + kc1 + kout)


def _pad2(w, k, n):
    out = torch.zeros((k, n), dtype=torch.float32, device=w.device)
    out[:w.shape[0], :w.shape[1]] = w
    return out


def pack_head_tf32(w1, w2, b1, b2, ce, form):
    """The head's parameters as the tensor-core body reads them, at the
    widths of ``form`` (zero past the head's): ``(wp, b1, b2)``, ``wp`` the
    packed B operands (``pack_b_tf32``) of W1e, W1c, W2, W2^T, W1e^T and
    W1c^T, one after the other; ``b1`` and ``b2`` f32."""
    kce, kc1, kout = form
    w1 = w1.float()
    w1e, w1c = _pad2(w1[:ce], kce, kc1), _pad2(w1[ce:], kce, kc1)
    w2p = _pad2(w2, kc1, kout)
    mats = (w1e, w1c, w2p, w2p.t(), w1e.t(), w1c.t())
    wp = torch.cat([pack_b_tf32(m).reshape(-1) for m in mats])
    b1p = torch.zeros(kc1, dtype=torch.float32, device=w1.device)
    b1p[:b1.shape[0]] = b1
    b2p = torch.zeros(kout, dtype=torch.float32, device=w1.device)
    b2p[:b2.shape[0]] = b2
    return wp, b1p, b2p


def _packed_head_tf32(ws, bs, ce, form):
    """``pack_head_tf32``, made once per parameter value."""
    return _packed.get((*ws, *bs), ("tf32", ce, form),
                       lambda w1, w2, b1, b2: pack_head_tf32(w1, w2, b1, b2, ce, form))


def _head_bwd_tc_walk(e, ctx, g, gsum, gsq, ws, bs, acts, cmajor=False, sms=H100_SMS):
    """A plain walk of K5-bwd's tensor-core body on the CPU, f32: the plan's
    form (widths zero-padded, Cout to 8 or 128), its persistent blocks'
    tiles of 16 pixels and chunks of 4 samples (64 rows, sample-major, rows
    past S or HW zero and their gz zero), every product in split TF32 k8
    step by k8 step (``mm_k8``) in the kernel's order, dW1e and dW2 carried
    through each block's walk, dW1c added to the block's partial tile by
    tile, the bias sums chunk by chunk, the partials summed in block
    order.  Returns what ``_head_bwd_plain`` returns for f32 ``e``."""
    b, s, hw, ce = e.shape
    cc, (c1, cout) = ctx.shape[-1], ws[1].shape
    plan = head_bwd_tc_plan(b, hw, ce, cc, c1, cout, sms)
    kce, kc1, kout = plan.form
    a1, a2 = acts
    wp = [_pad2(ws[0][:ce], kce, kc1), _pad2(ws[0][ce:], kce, kc1), _pad2(ws[1], kc1, kout)]
    w1e, w1c, w2 = wp
    b1 = torch.zeros(kc1)
    b1[:c1] = bs[0]
    b2 = torch.zeros(kout)
    b2[:cout] = bs[1]
    ef = torch.zeros((b, s, hw, kce))
    ef[..., :ce] = e.float()
    cf = torch.zeros((b, hw, kce))
    cf[..., :cc] = ctx.float()

    def per_pixel(t):
        out = torch.zeros((b, hw, kout))
        if t is not None:
            out[..., :cout] = t.float()
        return out

    gf = torch.zeros((b, s, hw, kout))
    if g is not None:
        gf[..., :cout] = (g.transpose(2, 3) if cmajor else g).float()
    gs, gq = per_pixel(gsum), per_pixel(gsq)
    de = torch.zeros((b, s, hw, kce))
    dctx = torch.zeros((b, hw, kce))
    per_image = -(-hw // HEAD_TC_PIX)
    rows = HEAD_TC_PIX * HEAD_TC_SAMPLES
    parts = []
    for blk in range(plan.blocks):
        dw1e, dw1c = torch.zeros((kce, kc1)), torch.zeros((kce, kc1))
        dw2, db1, db2 = torch.zeros((kc1, kout)), torch.zeros(kc1), torch.zeros(kout)
        for t in range(blk, plan.tiles, plan.blocks):
            bi, p0 = divmod(t, per_image)
            p0 *= HEAD_TC_PIX
            pix = torch.arange(p0, p0 + HEAD_TC_PIX)
            pok = pix < hw
            pc = pix.clamp(max=hw - 1)
            cx = torch.where(pok[:, None], cf[bi, pc], 0.0)
            zc = mm_k8(torch.zeros((HEAD_TC_PIX, kc1)), cx, w1c)
            gs_t = torch.where(pok[:, None], gs[bi, pc], 0.0)
            gq_t = torch.where(pok[:, None], gq[bi, pc], 0.0)
            gt = torch.zeros((HEAD_TC_PIX, kc1))
            for s0 in range(0, s, HEAD_TC_SAMPLES):
                smp = torch.arange(s0, s0 + HEAD_TC_SAMPLES)
                ok = ((smp < s)[:, None] & pok[None]).reshape(rows)   # row 16 j + p
                sc = smp.clamp(max=s - 1)
                ec = torch.where(ok[:, None], ef[bi][sc][:, pc].reshape(rows, kce), 0.0)
                gc = torch.where(ok[:, None], gf[bi][sc][:, pc].reshape(rows, kout), 0.0)
                z = mm_k8(torch.zeros((rows, kc1)), ec, w1e)
                h1 = _act(a1, (z + zc.repeat(HEAD_TC_SAMPLES, 1)) + b1)
                h2 = _act(a2, mm_k8(torch.zeros((rows, kout)), h1, w2) + b2)
                gg = ((gc + gs_t.repeat(HEAD_TC_SAMPLES, 1))
                      + 2.0 * h2 * gq_t.repeat(HEAD_TC_SAMPLES, 1))
                gz = _act_grad(a2, h2, gg)
                gz = torch.where(ok[:, None] & (torch.arange(kout) < cout)[None], gz, 0.0)
                db2 = db2 + gz.sum(0)
                dw2 = mm_k8(dw2, h1.t(), gz)
                g1 = _act_grad(a1, h1, mm_k8(torch.zeros((rows, kc1)), gz, w2.t()))
                db1 = db1 + g1.sum(0)
                for j in range(HEAD_TC_SAMPLES):
                    gt = gt + g1[j * HEAD_TC_PIX:(j + 1) * HEAD_TC_PIX]
                dw1e = mm_k8(dw1e, ec.t(), g1)
                dec = mm_k8(torch.zeros((rows, kce)), g1, w1e.t()).reshape(
                    HEAD_TC_SAMPLES, HEAD_TC_PIX, kce)
                for j in range(HEAD_TC_SAMPLES):
                    if s0 + j < s:
                        de[bi, s0 + j, pix[pok]] = dec[j][pok]
            dctx[bi, pix[pok]] = mm_k8(torch.zeros((HEAD_TC_PIX, kce)), gt, w1c.t())[pok]
            dw1c = mm_k8(dw1c, cx.t(), gt)
        parts.append(torch.cat([dw1e.reshape(-1), dw1c.reshape(-1), dw2.reshape(-1), db1, db2]))
    out = torch.zeros_like(parts[0])
    for part in parts:
        out = out + part
    dw1e, dw1c, dw2, db1, db2 = torch.split(out, [kce * kc1, kce * kc1, kc1 * kout, kc1, kout])
    dw1 = torch.cat([dw1e.view(kce, kc1)[:ce, :c1], dw1c.view(kce, kc1)[:cc, :c1]])
    return (de[..., :ce], dctx[..., :cc], [dw1, dw2.view(kc1, kout)[:c1, :cout]],
            [db1[:c1], db2[:cout]])


def _head_bwd_tc_kernel(e, ctx, g, gsum, gsq, ws, bs, codes, cmajor, dev):
    """K5-bwd's tensor-core f32 body (``head_bwd_tc_plan``): the head zero-
    padded to the plan's form (e and ctx copied only where narrower), the
    cotangents read as f32 in their layout, None as zero; the weights from
    ``pack_head_tf32``, packed once per parameter value."""
    b, s, hw, ce = e.shape
    cc, (c1, cout) = ctx.shape[-1], ws[1].shape
    g_shape = (b, s, cout, hw) if cmajor else (b, s, hw, cout)
    if (tuple(ctx.shape) != (b, hw, cc) or tuple(ws[0].shape) != (ce + cc, c1)
            or (g is not None and tuple(g.shape) != g_shape)
            or any(m is not None and tuple(m.shape) != (b, hw, cout) for m in (gsum, gsq))):
        raise ValueError("pathnet_head_bwd: shapes of e, ctx, the weights and the "
                         "cotangents disagree")
    idx = dev.index or 0
    plan = head_bwd_tc_plan(b, hw, ce, cc, c1, cout, sms=_build.sm_count(idx))
    kce, kc1, kout = plan.form
    wp, b1, b2 = _packed_head_tf32(ws, bs, ce, plan.form)
    e = _aligned(_pad_last(e.contiguous(), kce))
    ctx = _aligned(_pad_last(ctx.float().contiguous(), kce))
    g, gsum, gsq = (None if t is None else t.float().contiguous() for t in (g, gsum, gsq))
    de = torch.empty_like(e)
    dctx = torch.empty((b, hw, kce), dtype=torch.float32, device=dev)
    parts = torch.empty(plan.blocks * plan.parts, dtype=torch.float32, device=dev)
    out = torch.empty(plan.parts, dtype=torch.float32, device=dev)
    P, INT = _build.PTR, _build.INT
    ptr = (lambda t: None if t is None else t.data_ptr())
    fn = _build.kernel("wcmc_pathnet_head_bwd_tf32", *([P] * 12), *([INT] * 12), P)
    _build.check(fn(e.data_ptr(), ctx.data_ptr(), ptr(g), ptr(gsum), ptr(gsq), wp.data_ptr(),
                    b1.data_ptr(), b2.data_ptr(), de.data_ptr(), dctx.data_ptr(),
                    parts.data_ptr(), out.data_ptr(), b, s, hw, kce, kc1, kout, cout, *codes,
                    int(cmajor), plan.blocks, idx, _build.stream_of(dev)), "pathnet_head_bwd")
    _build.launches["pathnet_head_bwd"] += 1
    dw1e, dw1c, dw2, db1, db2 = torch.split(out, [kce * kc1, kce * kc1, kc1 * kout, kc1, kout])
    dw1 = torch.cat([dw1e.view(kce, kc1)[:ce, :c1], dw1c.view(kce, kc1)[:cc, :c1]])
    return (de[..., :ce], dctx[..., :cc], [dw1, dw2.view(kc1, kout)[:c1, :cout]],
            [db1[:c1], db2[:cout]])


# ---------------------------------------------------------------------------
# K4-bwd's tensor-core f32 body (csrc/pathnet_embed_bwd_tf32.cu): forms, plan,
# weight pack, walk and wrapper
# ---------------------------------------------------------------------------

# (C0 padded, hidden width) of the body's instantiations: KPCN's dual
# PathNet (36 -> 128^3), the 64-wide PathNet (36 -> 64^3), Multisteps (95 ->
# 128^3)
EMBED_TC_FORMS = ((40, 128), (40, 64), (96, 128))
EMBED_TC_PIX, EMBED_TC_SAMPLES = 16, 4   # a tile's pixels; a chunk's samples (64 rows)


class EmbedBwdTcPlan(NamedTuple):
    """How K4-bwd's tensor-core f32 body runs a chain: the instantiation
    ``form`` (C0 padded, hidden width) its widths are zero-padded to;
    ``blocks`` persistent blocks (``per_sm`` an SM) over ``tiles`` tiles of
    16 pixels, each tile its samples in chunks of 4; ``smem`` the block's
    shared memory as (buffer, bytes) pairs in the kernel's carve order, each
    a multiple of 128 bytes, ``total`` their sum (what
    ``wcmc_pathnet_embed_bwd_tf32_smem`` returns); ``parts`` the floats of a
    block's partial (dW0 | dW1 | dW2 | db0 | db1 | db2 at the padded
    widths)."""
    form: tuple
    tiles: int
    per_sm: int
    blocks: int
    smem: tuple
    total: int
    parts: int


def embed_tc_form(c0, c1, c2, c3):
    """The cheapest instantiation of ``EMBED_TC_FORMS`` that holds the chain
    C0 -> C1 -> C2 -> C3 (by multiply-adds a row at the padded widths), None
    if none does; ValueError for a width below 1."""
    if min(c0, c1, c2, c3) < 1:
        raise ValueError(f"pathnet_embed_bwd: widths {(c0, c1, c2, c3)}")
    fits = [f for f in EMBED_TC_FORMS if c0 <= f[0] and max(c1, c2, c3) <= f[1]]
    return min(fits, key=lambda f: f[0] * f[1] + 2 * f[1] * f[1]) if fits else None


def _et_pitch(c):
    """A row pitch of 8 floats past a multiple of 32 (the kernel's et_pitch)."""
    return c + (40 - c % 32) % 32


@functools.lru_cache(maxsize=None)
def embed_bwd_tc_plan(b, hw, c0, c1, c2, c3, sms=H100_SMS) -> EmbedBwdTcPlan:
    """K4-bwd's tensor-core body for (b, ., hw) rows of a chain C0 -> C1 ->
    C2 -> C3: the form, the grid, and the carve: x twice (the chunk and the
    next), h1 / g1, h2 / g2 and ge / g3 at 64 rows, the tile's gmean at 16
    pixels, dW0^T (hidden width x C0 padded), f32, rows at a pitch of 8
    floats past a multiple of 32.  Two blocks an SM for the 64-wide form.
    ValueError for a chain no form holds."""
    form = embed_tc_form(c0, c1, c2, c3)
    if form is None:
        raise ValueError(f"pathnet_embed_bwd tf32 body takes chains up to one of "
                         f"{EMBED_TC_FORMS} (C0, widest layer), got {(c0, c1, c2, c3)}")
    kc0, kc = form
    rows = EMBED_TC_PIX * EMBED_TC_SAMPLES
    smem = (("x0", rows * _et_pitch(kc0)), ("x1", rows * _et_pitch(kc0)),
            ("h1", rows * _et_pitch(kc)), ("h2", rows * _et_pitch(kc)),
            ("g3", rows * _et_pitch(kc)), ("gmean", EMBED_TC_PIX * _et_pitch(kc)),
            ("dw0t", kc * _et_pitch(kc0)))
    smem = tuple((n, _r128(4 * c)) for n, c in smem)
    total = sum(m for _, m in smem)
    if total > SMEM_LIMIT:
        raise ValueError(f"pathnet_embed_bwd tf32 body needs {total} bytes of shared memory")
    per_sm = min(2 if kc == 64 else 1, SM_SMEM // (total + 1024))
    tiles = b * -(-hw // EMBED_TC_PIX)
    return EmbedBwdTcPlan(form, tiles, per_sm, max(1, min(tiles, per_sm * sms)), smem, total,
                          kc0 * kc + 2 * kc * kc + 3 * kc)


def pack_embed_tf32(w0, w1, w2, b0, b1, b2, form):
    """The embedding's parameters as the tensor-core body reads them, at the
    widths of ``form`` (zero past the chain's): ``(wp, bias)``, ``wp`` the
    packed B operands (``pack_b_tf32``) of W0, W1, W2, W2^T, W1^T and W0^T,
    one after the other; ``bias`` b0 | b1 | b2, f32, each padded to the
    hidden width."""
    kc0, kc = form
    m0, m1, m2 = _pad2(w0.float(), kc0, kc), _pad2(w1.float(), kc, kc), _pad2(w2.float(), kc, kc)
    wp = torch.cat([pack_b_tf32(m).reshape(-1) for m in (m0, m1, m2, m2.t(), m1.t(), m0.t())])
    bias = torch.zeros(3 * kc, dtype=torch.float32, device=w0.device)
    for i, v in enumerate((b0, b1, b2)):
        bias[i * kc:i * kc + v.shape[0]] = v
    return wp, bias


def _packed_embed_tf32(ws, bs, form):
    """``pack_embed_tf32``, made once per parameter value."""
    return _packed.get((*ws, *bs), ("tf32_embed", form),
                       lambda *p: pack_embed_tf32(*p, form))


def _embed_bwd_tc_walk(x, ge, gmean, ws, bs, acts, compute_dx=False, sms=H100_SMS):
    """A plain walk of K4-bwd's tensor-core body on the CPU, f32: the plan's
    form (C0 and the layers zero-padded), every product in split TF32 k8 step
    by k8 step (``mm_k8``) in the kernel's order; the per-row chain (the
    recompute, g3 = a2'(h3, ge + gmean / S), g2, g1, d(x)) is the same
    arithmetic for every row, so it runs on all rows at once; the weight
    gradients walk each persistent block's tiles of 16 pixels and chunks of 4
    samples (64 rows, sample-major, rows past S or HW zero), dW1, dW2 and
    dW0^T carried through the block's walk, the bias sums chunk by chunk, the
    partials summed in block order.  Returns what ``_embed_bwd_plain``
    returns for f32 ``x``."""
    b, s, hw, c0 = x.shape
    dims = [c0] + [w.shape[1] for w in ws]
    plan = embed_bwd_tc_plan(b, hw, *dims, sms)
    kc0, kc = plan.form
    a0, a1, a2 = acts
    m0, m1, m2 = _pad2(ws[0], kc0, kc), _pad2(ws[1], kc, kc), _pad2(ws[2], kc, kc)
    bias = []
    for v in bs:
        p = torch.zeros(kc)
        p[:v.shape[0]] = v
        bias.append(p)
    xf = torch.zeros((b, s, hw, kc0))
    xf[..., :c0] = x.float()
    c3 = dims[-1]
    g = torch.zeros((b, s, hw, kc))
    if ge is not None:
        g[..., :c3] = ge.float()
    if gmean is not None:
        g[..., :c3] = g[..., :c3] + gmean.float()[:, None] / s

    def mm(a, w):
        return mm_k8(torch.zeros((*a.shape[:-1], w.shape[1])), a, w)

    h1 = _act(a0, mm(xf, m0) + bias[0])
    h2 = _act(a1, mm(h1, m1) + bias[1])
    if a2 != "linear":
        g = _act_grad(a2, _act(a2, mm(h2, m2) + bias[2]), g)
    g2 = _act_grad(a1, h2, mm(g, m2.t()))
    g1 = _act_grad(a0, h1, mm(g2, m1.t()))
    dx = mm(g1, m0.t())[..., :c0] if compute_dx else None
    per_image = -(-hw // EMBED_TC_PIX)
    rows = EMBED_TC_PIX * EMBED_TC_SAMPLES
    parts = []
    for blk in range(plan.blocks):
        dw0t, dw1, dw2 = torch.zeros((kc, kc0)), torch.zeros((kc, kc)), torch.zeros((kc, kc))
        db = [torch.zeros(kc) for _ in range(3)]
        for t in range(blk, plan.tiles, plan.blocks):
            bi, p0 = divmod(t, per_image)
            p0 *= EMBED_TC_PIX
            pix = torch.arange(p0, p0 + EMBED_TC_PIX)
            pok = pix < hw
            pc = pix.clamp(max=hw - 1)
            for s0 in range(0, s, EMBED_TC_SAMPLES):
                smp = torch.arange(s0, s0 + EMBED_TC_SAMPLES)
                ok = ((smp < s)[:, None] & pok[None]).reshape(rows)   # row 16 j + p
                sc = smp.clamp(max=s - 1)

                def chunk(v):
                    return torch.where(ok[:, None], v[bi][sc][:, pc].reshape(rows, -1), 0.0)

                xc, h1c, h2c, g3c, g2c, g1c = map(chunk, (xf, h1, h2, g, g2, g1))
                db[2] = db[2] + g3c.sum(0)
                dw2 = mm_k8(dw2, h2c.t(), g3c)
                db[1] = db[1] + g2c.sum(0)
                dw1 = mm_k8(dw1, h1c.t(), g2c)
                db[0] = db[0] + g1c.sum(0)
                dw0t = mm_k8(dw0t, g1c.t(), xc)
        parts.append(torch.cat([dw0t.t().reshape(-1), dw1.reshape(-1), dw2.reshape(-1), *db]))
    out = torch.zeros_like(parts[0])
    for part in parts:
        out = out + part
    dw0, dw1, dw2, db0, db1, db2 = torch.split(out, [kc0 * kc, kc * kc, kc * kc, kc, kc, kc])
    c1, c2 = dims[1:3]
    return (dx, [dw0.view(kc0, kc)[:c0, :c1], dw1.view(kc, kc)[:c1, :c2],
                 dw2.view(kc, kc)[:c2, :c3]], [db0[:c1], db1[:c2], db2[:c3]])


def _embed_bwd_tc_kernel(x, ge, gmean, ws, bs, codes, compute_dx, dev):
    """K4-bwd's tensor-core f32 body (``embed_bwd_tc_plan``): x read as it
    comes (16 bytes a copy where C0 is a multiple of 4 and x 16-byte
    aligned), the cotangents as f32 zero-padded to the hidden width where
    narrower, None as zero; the weights from ``pack_embed_tf32``, packed
    once per parameter value."""
    b, s, hw, c0 = x.shape
    dims = _f32_dims("pathnet_embed_bwd", c0, ws)
    c1, c2, c3 = dims[1:]
    if ((ge is not None and tuple(ge.shape) != (b, s, hw, c3))
            or (gmean is not None and tuple(gmean.shape) != (b, hw, c3))):
        raise ValueError("pathnet_embed_bwd: cotangent shapes do not match the embedding")
    idx = dev.index or 0
    plan = embed_bwd_tc_plan(b, hw, *dims, sms=_build.sm_count(idx))
    kc0, kc = plan.form
    wp, bias = _packed_embed_tf32(ws, bs, plan.form)
    x = x.contiguous()
    ge, gmean = (None if t is None else _aligned(_pad_last(t.float().contiguous(), kc))
                 for t in (ge, gmean))
    dx = torch.empty_like(x) if compute_dx else None
    parts = torch.empty(plan.blocks * plan.parts, dtype=torch.float32, device=dev)
    out = torch.empty(plan.parts, dtype=torch.float32, device=dev)
    P, INT = _build.PTR, _build.INT
    ptr = (lambda t: None if t is None else t.data_ptr())
    fn = _build.kernel("wcmc_pathnet_embed_bwd_tf32", *([P] * 8), *([INT] * 11), P)
    _build.check(fn(x.data_ptr(), ptr(ge), ptr(gmean), wp.data_ptr(), bias.data_ptr(), ptr(dx),
                    parts.data_ptr(), out.data_ptr(), b, s, hw, c0, kc0, kc, *codes, plan.blocks,
                    idx, _build.stream_of(dev)), "pathnet_embed_bwd")
    _build.launches["pathnet_embed_bwd"] += 1
    dw0, dw1, dw2, db0, db1, db2 = torch.split(out, [kc0 * kc, kc * kc, kc * kc, kc, kc, kc])
    return dx, [dw0.view(kc0, kc)[:c0, :c1], dw1.view(kc, kc)[:c1, :c2],
                dw2.view(kc, kc)[:c2, :c3]], [db0[:c1], db1[:c2], db2[:c3]]


# ---------------------------------------------------------------------------
# K4-fwd's tensor-core f32 body (csrc/pathnet_embed_tf32.cu): plan, walk and
# wrapper; its forms and weight pack are K4-bwd's (EMBED_TC_FORMS,
# pack_embed_tf32), so a train step's backward finds its forward's pack
# ---------------------------------------------------------------------------

class EmbedFwdTcPlan(NamedTuple):
    """How K4-fwd's tensor-core f32 body runs a chain: the form of
    ``EMBED_TC_FORMS`` its widths are zero-padded to; ``blocks`` persistent
    blocks (``per_sm`` an SM) over ``tiles`` tiles of 16 pixels, each tile
    its samples in chunks of 4; ``smem`` the block's shared memory as
    (buffer, bytes) pairs in the kernel's carve order, each a multiple of
    128 bytes, ``total`` their sum (what ``wcmc_pathnet_embed_tf32_smem``
    returns)."""
    form: tuple
    tiles: int
    per_sm: int
    blocks: int
    smem: tuple
    total: int


@functools.lru_cache(maxsize=None)
def embed_fwd_tc_plan(b, hw, c0, c1, c2, c3, sms=H100_SMS) -> EmbedFwdTcPlan:
    """K4-fwd's tensor-core body for (b, ., hw) rows of a chain C0 -> C1 ->
    C2 -> C3: the form, the grid, and the carve: x twice (the chunk and the
    next), h1 and h2 at 64 rows, f32, rows at a pitch of 8 floats past a
    multiple of 32.  Two blocks an SM for the forms of C0 40 (the kernel's
    launch bounds), one for Multisteps'.  ValueError for a chain no form
    holds."""
    form = embed_tc_form(c0, c1, c2, c3)
    if form is None:
        raise ValueError(f"pathnet_embed tf32 body takes chains up to one of {EMBED_TC_FORMS} "
                         f"(C0, widest layer), got {(c0, c1, c2, c3)}")
    kc0, kc = form
    rows = EMBED_TC_PIX * EMBED_TC_SAMPLES
    smem = (("x0", rows * _et_pitch(kc0)), ("x1", rows * _et_pitch(kc0)),
            ("h1", rows * _et_pitch(kc)), ("h2", rows * _et_pitch(kc)))
    smem = tuple((n, _r128(4 * c)) for n, c in smem)
    total = sum(m for _, m in smem)
    per_sm = min(2 if kc0 == 40 else 1, SM_SMEM // (total + 1024))
    tiles = b * -(-hw // EMBED_TC_PIX)
    return EmbedFwdTcPlan(form, tiles, per_sm, max(1, min(tiles, per_sm * sms)), smem, total)


def _embed_fwd_tc_walk(x, ws, bs, acts):
    """A plain walk of K4-fwd's tensor-core body on the CPU, f32: the plan's
    form (C0 and the layers zero-padded), every product in split TF32 k8
    step by k8 step (``mm_k8``) in the kernel's order, then the bias and the
    activation; the mean the unrounded f32 e of the samples summed in sample
    order from zero and divided once by S.  Every row's arithmetic is the
    same whatever its tile, so the walk takes all rows at once.  Returns
    what ``_embed_plain`` returns for f32 ``x``."""
    b, s, hw, c0 = x.shape
    dims = [c0] + [w.shape[1] for w in ws]
    kc0, kc = embed_fwd_tc_plan(b, hw, *dims).form
    mats = (_pad2(ws[0], kc0, kc), _pad2(ws[1], kc, kc), _pad2(ws[2], kc, kc))
    h = torch.zeros((b, s, hw, kc0))
    h[..., :c0] = x.float()
    for m, v, a in zip(mats, bs, acts):
        bias = torch.zeros(kc)
        bias[:v.shape[0]] = v
        h = _act(a, mm_k8(torch.zeros((b, s, hw, kc)), h, m) + bias)
    e = h[..., :dims[-1]]
    total = torch.zeros((b, hw, dims[-1]))
    for j in range(s):
        total = total + e[:, j]
    return e, total / s


def _embed_fwd_tc_kernel(x, ws, bs, codes, dev):
    """K4-fwd's tensor-core f32 body (``embed_fwd_tc_plan``): x read as it
    comes (16 bytes a copy where C0 is a multiple of 4 and x 16-byte
    aligned, else 4), e and the mean written at the chain's width; the
    weights from ``pack_embed_tf32``, packed once per parameter value (the
    entry K4-bwd reads)."""
    b, s, hw, c0 = x.shape
    dims = _f32_dims("pathnet_embed", c0, ws)
    idx = dev.index or 0
    plan = embed_fwd_tc_plan(b, hw, *dims, sms=_build.sm_count(idx))
    kc0, kc = plan.form
    wp, bias = _packed_embed_tf32(ws, bs, plan.form)
    x = x.contiguous()
    e = torch.empty((b, s, hw, dims[-1]), dtype=torch.float32, device=dev)
    mean = torch.empty((b, hw, dims[-1]), dtype=torch.float32, device=dev)
    P, INT = _build.PTR, _build.INT
    fn = _build.kernel("wcmc_pathnet_embed_tf32", *([P] * 5), *([INT] * 12), P)
    _build.check(fn(x.data_ptr(), wp.data_ptr(), bias.data_ptr(), e.data_ptr(), mean.data_ptr(),
                    b, s, hw, c0, dims[-1], kc0, kc, *codes, plan.blocks, idx,
                    _build.stream_of(dev)), "pathnet_embed")
    _build.launches["pathnet_embed"] += 1
    return e, mean


# ---------------------------------------------------------------------------
# K5-fwd's tensor-core f32 body (csrc/pathnet_head_tf32.cu): plan, walk and
# wrapper; its forms and weight pack are K5-bwd's (HEAD_TC_FORMS,
# pack_head_tf32), so a train step's backward finds its forward's pack
# ---------------------------------------------------------------------------

class HeadFwdTcPlan(NamedTuple):
    """How K5-fwd's tensor-core f32 body runs a head: the form of
    ``HEAD_TC_FORMS`` its widths are zero-padded to; ``blocks`` persistent
    blocks (``per_sm`` an SM) over ``tiles`` tiles of 16 pixels, each tile
    its samples in chunks of 4; ``smem`` the block's shared memory as
    (buffer, bytes) pairs in the kernel's carve order, each a multiple of
    128 bytes, ``total`` their sum (what ``wcmc_pathnet_head_tf32_smem``
    returns)."""
    form: tuple
    tiles: int
    per_sm: int
    blocks: int
    smem: tuple
    total: int


HEAD_FWD_TC_WARPS = 8   # a narrow head's output product is split over them by k8 steps


@functools.lru_cache(maxsize=None)
def head_fwd_tc_plan(b, hw, ce, cc, c1, cout, sms=H100_SMS) -> HeadFwdTcPlan:
    """K5-fwd's tensor-core body for (b, ., hw) rows of a head [Ce | Cc] ->
    C1 -> Cout: the form, the grid, and the carve: e twice (the chunk and
    the next) and h1 at 64 rows, the output at 64 rows (for a narrow head,
    Cout padded to 8 or 16, the 8 warps' partials of it), the context and
    ctx . W1c at 16 pixels, f32, rows at a pitch of the width + 8 floats (8
    for a width of 8).  Two blocks an SM where a 64-wide form's carve lets
    them.  ValueError for a head no form holds."""
    form = head_tc_form(ce, cc, c1, cout)
    if form is None:
        raise ValueError(f"pathnet_head tf32 body takes heads up to one of {HEAD_TC_FORMS} "
                         f"(Ce = Cc, C1, Cout), got {(ce, cc, c1, cout)}")
    kce, kc1, kout = form
    rows = HEAD_TC_PIX * HEAD_TC_SAMPLES
    out = HEAD_FWD_TC_WARPS * rows * kout if kout <= 16 else rows * _tc_pitch(kout)
    smem = (("e0", rows * _tc_pitch(kce)), ("e1", rows * _tc_pitch(kce)),
            ("h", rows * _tc_pitch(kc1)), ("out", out), ("ctx", HEAD_TC_PIX * _tc_pitch(kce)),
            ("zc", HEAD_TC_PIX * _tc_pitch(kc1)))
    smem = tuple((n, _r128(4 * c)) for n, c in smem)
    total = sum(m for _, m in smem)
    per_sm = min(2 if kce == 64 else 1, SM_SMEM // (total + 1024))
    tiles = b * -(-hw // HEAD_TC_PIX)
    return HeadFwdTcPlan(form, tiles, per_sm, max(1, min(tiles, per_sm * sms)), smem, total)


def _head_fwd_tc_walk(e, ctx, ws, bs, acts, moments=False, cmajor=False,
                      out_dtype=torch.float32):
    """A plain walk of K5-fwd's tensor-core body on the CPU, f32: the plan's
    form (widths zero-padded), every product in split TF32 k8 step by k8
    step (``mm_k8``) in the kernel's order, ctx . W1c once per pixel added to
    each sample's rows before b1; a narrow head's output product (Cout
    padded to 8 or 16) as the kernel splits it, each warp's C1 / 64 k8
    steps into its partial from zero and the 8 partials summed in warp
    order; the moments of the unrounded f32 output summed in sample order.
    Every row's arithmetic is the same whatever its tile, so the walk takes
    all rows at once.  Returns what ``_head_plain`` returns for f32 ``e``."""
    b, s, hw, ce = e.shape
    cc, (c1, cout) = ctx.shape[-1], ws[1].shape
    kce, kc1, kout = head_fwd_tc_plan(b, hw, ce, cc, c1, cout).form
    a1, a2 = acts
    w1e, w1c = _pad2(ws[0][:ce], kce, kc1), _pad2(ws[0][ce:], kce, kc1)
    w2 = _pad2(ws[1], kc1, kout)
    b1 = torch.zeros(kc1)
    b1[:c1] = bs[0]
    b2 = torch.zeros(kout)
    b2[:cout] = bs[1]
    ef = torch.zeros((b, s, hw, kce))
    ef[..., :ce] = e.float()
    cf = torch.zeros((b, hw, kce))
    cf[..., :cc] = ctx.float()
    zc = mm_k8(torch.zeros((b, hw, kc1)), cf, w1c)
    h1 = _act(a1, (mm_k8(torch.zeros((b, s, hw, kc1)), ef, w1e) + zc[:, None]) + b1)
    if kout <= 16:
        z = None
        k = kc1 // HEAD_FWD_TC_WARPS
        for w in range(HEAD_FWD_TC_WARPS):
            part = mm_k8(torch.zeros((b, s, hw, kout)), h1[..., w * k:(w + 1) * k],
                        w2[w * k:(w + 1) * k])
            z = part if z is None else z + part
    else:
        z = mm_k8(torch.zeros((b, s, hw, kout)), h1, w2)
    out = _act(a2, z + b2)[..., :cout]
    res = out.to(out_dtype)
    res = res.transpose(2, 3) if cmajor else res
    if not moments:
        return res
    ssum, ssq = torch.zeros((b, hw, cout)), torch.zeros((b, hw, cout))
    for j in range(s):
        ssum = ssum + out[:, j]
        ssq = ssq + out[:, j] * out[:, j]
    return res, ssum, ssq


def _head_fwd_tc_kernel(e, ctx, ws, bs, codes, moments, cmajor, out_dtype, dev):
    """K5-fwd's tensor-core f32 body (``head_fwd_tc_plan``): the head zero-
    padded to the plan's form (e and ctx copied only where narrower), the
    output written as ``out_dtype`` (f32 or bf16) in either layout, the
    moments of the unrounded f32 output; the weights from
    ``pack_head_tf32``, packed once per parameter value (the entry K5-bwd
    reads)."""
    b, s, hw, ce = e.shape
    cc, (c1, cout) = ctx.shape[-1], ws[1].shape
    idx = dev.index or 0
    plan = head_fwd_tc_plan(b, hw, ce, cc, c1, cout, sms=_build.sm_count(idx))
    kce, kc1, kout = plan.form
    wp, b1, b2 = _packed_head_tf32(ws, bs, ce, plan.form)
    e = _aligned(_pad_last(e.contiguous(), kce))
    ctx = _aligned(_pad_last(ctx.float().contiguous(), kce))
    shape = (b, s, cout, hw) if cmajor else (b, s, hw, cout)
    out = torch.empty(shape, dtype=out_dtype, device=dev)
    ssum = ssq = None
    if moments:
        ssum = torch.empty((b, hw, cout), dtype=torch.float32, device=dev)
        ssq = torch.empty_like(ssum)
    P, INT = _build.PTR, _build.INT
    ptr = (lambda t: None if t is None else t.data_ptr())
    fn = _build.kernel("wcmc_pathnet_head_tf32", *([P] * 8), *([INT] * 13), P)
    _build.check(fn(e.data_ptr(), ctx.data_ptr(), wp.data_ptr(), b1.data_ptr(), b2.data_ptr(),
                    out.data_ptr(), ptr(ssum), ptr(ssq), b, s, hw, kce, kc1, kout, cout, *codes,
                    int(out_dtype == torch.bfloat16), int(cmajor), plan.blocks, idx,
                    _build.stream_of(dev)), "pathnet_head")
    _build.launches["pathnet_head"] += 1
    return (out, ssum, ssq) if moments else out


def pathnet_embed_bwd(x, ge, gmean, ws, bs, acts=EMBED_ACTS, compute_dx=False):
    """Gradients of :func:`pathnet_embed` for the cotangents ``ge`` of
    the embedding and ``gmean`` of its sample mean (either may be
    None): ``(dx or None, dWs, dbs)``, dx in x.dtype, dW and db in f32.
    K4-bwd for CUDA tensors (bf16: PathNet's relu-relu-linear chain
    without d(x) or Multisteps' leaky x 3; f32: any chain, d(x) or not),
    the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return _embed_bwd_plain(x, ge, gmean, ws, bs, acts, compute_dx)
    return _embed_bwd_kernel(x, ge, gmean, ws, bs, acts, compute_dx)


def pathnet_head_bwd(e, ctx, g, gsum, gsq, ws, bs, acts=HEAD_ACTS, cmajor=False):
    """Gradients of :func:`pathnet_head` for the cotangents of its output
    ``g`` (channel-major with ``cmajor``) and of its moments ``gsum`` and
    ``gsq`` (any may be None): ``(de in e.dtype, dctx f32, dWs, dbs)``.
    K5-bwd for CUDA tensors (bf16: PathNet's relu-relu head with Cout <=
    16 and an f32 ``g``, or Multisteps' leaky-leaky update chain with
    Cout <= 128 and a bf16 ``g``; f32 ``e``: any head, the cotangents read
    as f32), the plain version for CPU tensors."""
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
