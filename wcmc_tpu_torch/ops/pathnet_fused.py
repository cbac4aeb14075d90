"""PathNet's per-sample MLPs: the embedding with its fused sample mean,
and the head over [e | broadcast_S(ctx)] with its fused sample moments,
each an autograd Function whose backward is a kernel too.

Counterpart of ``wcmc_tpu/ops/pathnet_fused.py`` (reference dataflow:
``e = MLP_embed(paths)``, ``ctx = UNet(mean_S(e))``,
``out = MLP_head(concat(e, broadcast_S(ctx)))``).

* ``pathnet_embed``: forward CUDA kernel K4-fwd (``csrc/pathnet_embed.cu``),
  plain version ``_embed_plain``; backward K4-bwd
  (``csrc/pathnet_embed_bwd.cu``), plain version ``_embed_bwd_plain``;
* ``pathnet_head``: forward K5-fwd (``csrc/pathnet_head.cu``), plain
  ``_head_plain``; backward K5-bwd (``csrc/pathnet_head_bwd.cu``), plain
  ``_head_bwd_plain``.

CPU tensors run the plain versions; CUDA tensors launch the kernels,
which compute in bfloat16 with f32 accumulation and raise for other
dtypes.  The plain versions round where the reference's Pallas kernels
round: forward, after every embedding layer, after every hidden head
layer, and NOT after the last head layer, whose f32 value is the output
and feeds the moments (the reference's XLA head path rounds it too; in
float32 the two agree); backward, the hiddens are recomputed in the
compute dtype, each layer's cotangent is rounded to it before its
products, and dW, db (from the unrounded cotangent) and d(ctx) stay f32.
A cotangent that autograd passes as ``None`` is a zero.
"""

from __future__ import annotations

import torch

from wcmc_tpu_torch.ops import _build
from wcmc_tpu_torch.ops.mlp_fused import (
    _act, _act_grad, _mlp_bwd_rows, _mlp_plain, matmul_f32,
)

EMBED_ACTS = ("relu", "relu", "linear")
HEAD_ACTS = ("relu", "relu")


def _embed_plain(x, ws, bs, acts):
    _build.plain_calls["pathnet_embed"] += 1
    b, s, hw, c0 = x.shape
    e = _mlp_plain(x.reshape(-1, c0), ws, bs, acts).reshape(b, s, hw, ws[-1].shape[1])
    return e, e.float().mean(dim=1)


def _head_plain(e, ctx, ws, bs, acts, moments=False, cmajor=False):
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
    res = out.transpose(2, 3) if cmajor else out
    if moments:
        return res, out.sum(dim=1), (out * out).sum(dim=1)
    return res


def _require_cuda(name, *tensors):
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: inputs must all be on one CUDA device, got "
                         + ", ".join(str(t.device) for t in tensors))
    return dev


def _check_embed_card(x, ws, acts):
    """What K4-fwd and K4-bwd compute: bf16 rows, relu-relu-linear,
    widths multiples of 16; returns the layer widths."""
    if tuple(acts) != EMBED_ACTS:
        raise ValueError(f"pathnet_embed kernel computes {EMBED_ACTS}, got {tuple(acts)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"pathnet_embed kernel computes in bfloat16, got {x.dtype}")
    dims = [x.shape[-1]] + [w.shape[1] for w in ws]
    for w, ci, co in zip(ws, dims[:-1], dims[1:]):
        if tuple(w.shape) != (ci, co) or co % 16:
            raise ValueError(f"pathnet_embed: weight {tuple(w.shape)} is not "
                             f"({ci}, {co}) with {co} a multiple of 16")
    return dims


def _check_head_card(e, acts):
    if tuple(acts) != HEAD_ACTS:
        raise ValueError(f"pathnet_head kernel computes {HEAD_ACTS}, got {tuple(acts)}")
    if e.dtype != torch.bfloat16:
        raise TypeError(f"pathnet_head kernel computes in bfloat16, got {e.dtype}")


def _embed_fwd(x, ws, bs, acts):
    if x.device.type == "cpu":
        return _embed_plain(x, ws, bs, acts)
    dev = _require_cuda("pathnet_embed", x, *ws, *bs)
    dims = _check_embed_card(x, ws, acts)
    b, s, hw, _ = x.shape
    x = x.contiguous()
    wb = [w.to(torch.bfloat16).contiguous() for w in ws]
    bf = [bb.float().contiguous() for bb in bs]
    e = torch.empty((b, s, hw, dims[-1]), dtype=torch.bfloat16, device=dev)
    mean = torch.empty((b, hw, dims[-1]), dtype=torch.float32, device=dev)
    P, INT = _build.PTR, _build.INT
    fn = _build.kernel("wcmc_pathnet_embed", *([P] * 9), *([INT] * 9), P)
    idx = dev.index or 0
    _build.check(fn(x.data_ptr(), wb[0].data_ptr(), bf[0].data_ptr(),
                    wb[1].data_ptr(), bf[1].data_ptr(), wb[2].data_ptr(),
                    bf[2].data_ptr(), e.data_ptr(), mean.data_ptr(),
                    b, s, hw, *dims, _build.sm_count(idx), idx,
                    _build.stream_of(dev)), "pathnet_embed")
    _build.launches["pathnet_embed"] += 1
    return e, mean


def _head_fwd(e, ctx, ws, bs, acts, moments, cmajor):
    if e.device.type == "cpu":
        return _head_plain(e, ctx, ws, bs, acts, moments, cmajor)
    dev = _require_cuda("pathnet_head", e, ctx, *ws, *bs)
    _check_head_card(e, acts)
    b, s, hw, ce = e.shape
    cc = ctx.shape[-1]
    c1, cout = ws[0].shape[1], ws[1].shape[1]
    if (tuple(ctx.shape) != (b, hw, cc) or tuple(ws[0].shape) != (ce + cc, c1)
            or tuple(ws[1].shape) != (c1, cout)):
        raise ValueError("pathnet_head: shapes of e, ctx and the weights disagree")
    if ce % 16 or cc % 16 or c1 % 16 or cout > 16:
        raise ValueError("pathnet_head kernel needs Ce, Cc, C1 multiples of 16 "
                         f"and Cout <= 16, got {ce}, {cc}, {c1}, {cout}")
    e = e.contiguous()
    ctx = ctx.to(torch.bfloat16).contiguous()
    w1, w2 = (w.to(torch.bfloat16).contiguous() for w in ws)
    b1, b2 = (bb.float().contiguous() for bb in bs)
    shape = (b, s, cout, hw) if cmajor else (b, s, hw, cout)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    ssum = ssq = None
    if moments:
        ssum = torch.empty((b, hw, cout), dtype=torch.float32, device=dev)
        ssq = torch.empty_like(ssum)
    P, INT = _build.PTR, _build.INT
    fn = _build.kernel("wcmc_pathnet_head", *([P] * 9), *([INT] * 10), P)
    idx = dev.index or 0
    _build.check(fn(e.data_ptr(), ctx.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                    w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
                    ssum.data_ptr() if moments else None,
                    ssq.data_ptr() if moments else None,
                    b, s, hw, ce, cc, c1, cout, int(cmajor), _build.sm_count(idx),
                    idx, _build.stream_of(dev)), "pathnet_head")
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


def _embed_bwd_kernel(x, ge, gmean, ws, bs, acts):
    dev = _require_cuda("pathnet_embed_bwd", x, *ws, *bs)
    b, s, hw, c0 = x.shape
    c1, c2, c3 = _check_embed_card(x, ws, acts)[1:]
    if ((ge is not None and tuple(ge.shape) != (b, s, hw, c3))
            or (gmean is not None and tuple(gmean.shape) != (b, hw, c3))):
        raise ValueError("pathnet_embed_bwd: cotangent shapes do not match the embedding")
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
    n_parts = k0 * c1 + c1 * c2 + c2 * c3 + c1 + c2 + c3
    idx = dev.index or 0
    n_blocks = _build.sm_count(idx)
    parts = torch.empty(n_blocks * n_parts, dtype=torch.float32, device=dev)
    out = torch.empty(n_parts, dtype=torch.float32, device=dev)
    P, INT = _build.PTR, _build.INT
    fn = _build.kernel("wcmc_pathnet_embed_bwd", *([P] * 10), *([INT] * 9), P)
    _build.check(fn(x.data_ptr(), ge.data_ptr(), gmean.data_ptr(),
                    w0.data_ptr(), b0.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                    w2.data_ptr(), parts.data_ptr(), out.data_ptr(),
                    b, s, hw, c0, c1, c2, c3, n_blocks, idx,
                    _build.stream_of(dev)), "pathnet_embed_bwd")
    _build.launches["pathnet_embed_bwd"] += 1
    sizes = [k0 * c1, c1 * c2, c2 * c3, c1, c2, c3]
    dw0, dw1, dw2, db0, db1, db2 = torch.split(out, sizes)
    dws = [dw0.view(k0, c1)[:c0], dw1.view(c1, c2), dw2.view(c2, c3)]
    return None, dws, [db0, db1, db2]


HEAD_PAD = 16   # K5-bwd's output width (Cout <= 16, zero-padded)


def _head_bwd_kernel(e, ctx, g, gsum, gsq, ws, bs, cmajor):
    dev = _require_cuda("pathnet_head_bwd", e, ctx, *ws, *bs)
    b, s, hw, ce = e.shape
    cc = ctx.shape[-1]
    c1, cout = ws[0].shape[1], ws[1].shape[1]
    if ce % 16 or cc % 16 or c1 % 16 or cout > HEAD_PAD:
        raise ValueError("pathnet_head_bwd kernel needs Ce, Cc, C1 multiples of 16 "
                         f"and Cout <= {HEAD_PAD}, got {ce}, {cc}, {c1}, {cout}")
    g_shape = (b, s, cout, hw) if cmajor else (b, s, hw, cout)
    if (tuple(ctx.shape) != (b, hw, cc) or tuple(ws[0].shape) != (ce + cc, c1)
            or tuple(ws[1].shape) != (c1, cout)
            or (g is not None and tuple(g.shape) != g_shape)
            or any(m is not None and tuple(m.shape) != (b, hw, cout) for m in (gsum, gsq))):
        raise ValueError("pathnet_head_bwd: shapes of e, ctx, the weights and the "
                         "cotangents disagree")
    f32, bf = torch.float32, torch.bfloat16
    if g is None:
        g = torch.zeros((b, s, cout, hw), dtype=f32, device=dev)
    else:   # the kernel reads the cotangent channel-major
        g = (g if cmajor else g.transpose(2, 3)).float().contiguous()
    zeros = torch.zeros((b, hw, cout), dtype=f32, device=dev)
    gsum = zeros if gsum is None else gsum.float().contiguous()
    gsq = zeros if gsq is None else gsq.float().contiguous()
    w1 = ws[0].to(bf).contiguous()
    w2 = torch.zeros((c1, HEAD_PAD), dtype=bf, device=dev)
    w2[:, :cout] = ws[1]
    b2 = torch.zeros(HEAD_PAD, dtype=f32, device=dev)
    b2[:cout] = bs[1]
    b1 = bs[0].float().contiguous()
    e = e.contiguous()
    ctx = ctx.to(bf).contiguous()
    de = torch.empty_like(e)
    dctx = torch.empty((b, hw, cc), dtype=f32, device=dev)
    n_parts = ce * c1 + cc * c1 + c1 * HEAD_PAD + c1 + HEAD_PAD
    idx = dev.index or 0
    n_blocks = _build.sm_count(idx)
    parts = torch.empty(n_blocks * n_parts, dtype=f32, device=dev)
    out = torch.empty(n_parts, dtype=f32, device=dev)
    P, INT = _build.PTR, _build.INT
    fn = _build.kernel("wcmc_pathnet_head_bwd", *([P] * 13), *([INT] * 9), P)
    _build.check(fn(e.data_ptr(), ctx.data_ptr(), g.data_ptr(), gsum.data_ptr(),
                    gsq.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                    b2.data_ptr(), de.data_ptr(), dctx.data_ptr(), parts.data_ptr(),
                    out.data_ptr(), b, s, hw, ce, cc, c1, cout, n_blocks, idx,
                    _build.stream_of(dev)), "pathnet_head_bwd")
    _build.launches["pathnet_head_bwd"] += 1
    dw1, dw2, db1, db2 = torch.split(out, [(ce + cc) * c1, c1 * HEAD_PAD, c1, HEAD_PAD])
    dws = [dw1.view(ce + cc, c1), dw2.view(c1, HEAD_PAD)[:, :cout]]
    return de, dctx, dws, [db1, db2[:cout]]


def pathnet_embed_bwd(x, ge, gmean, ws, bs, acts=EMBED_ACTS, compute_dx=False):
    """Gradients of :func:`pathnet_embed` for the cotangents ``ge`` of
    the embedding and ``gmean`` of its sample mean (either may be
    None): ``(dx or None, dWs, dbs)``, dW and db in f32.  K4-bwd for
    CUDA tensors (bf16, ``compute_dx=False`` only), the plain version
    for CPU tensors."""
    if x.device.type == "cpu":
        return _embed_bwd_plain(x, ge, gmean, ws, bs, acts, compute_dx)
    if compute_dx:
        raise NotImplementedError("pathnet_embed_bwd kernel does not compute d(x) yet")
    return _embed_bwd_kernel(x, ge, gmean, ws, bs, acts)


def pathnet_head_bwd(e, ctx, g, gsum, gsq, ws, bs, acts=HEAD_ACTS, cmajor=False):
    """Gradients of :func:`pathnet_head` for the cotangents of its output
    ``g`` (channel-major with ``cmajor``) and of its moments ``gsum`` and
    ``gsq`` (any may be None): ``(de in e.dtype, dctx f32, dWs, dbs)``.
    K5-bwd for CUDA tensors (bf16), the plain version for CPU tensors."""
    if e.device.type == "cpu":
        return _head_bwd_plain(e, ctx, g, gsum, gsq, ws, bs, acts, cmajor)
    _check_head_card(e, acts)
    return _head_bwd_kernel(e, ctx, g, gsum, gsq, ws, bs, cmajor)


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
    def forward(ctx, e, c, acts, moments, cmajor, n, *params):
        ctx.acts, ctx.moments, ctx.cmajor, ctx.n = acts, moments, cmajor, n
        ctx.save_for_backward(e, c, *params)
        return _head_fwd(e, c, list(params[:n]), list(params[n:]), acts, moments, cmajor)

    @staticmethod
    def backward(ctx, g, *moment_grads):
        e, c, *params = ctx.saved_tensors
        n = ctx.n
        ws, bs = params[:n], params[n:]
        gsum, gsq = moment_grads if ctx.moments else (None, None)
        de, dctx, dws, dbs = pathnet_head_bwd(e, c, g, gsum, gsq, ws, bs, ctx.acts, ctx.cmajor)
        return (de, dctx.to(c.dtype), None, None, None, None,
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


def pathnet_head(e, ctx, ws, bs, acts=HEAD_ACTS, moments=False, cmajor=False):
    """Head chain over [e | broadcast_S(ctx)] without materializing the
    concat. e (B, S, HW, Ce) in compute dtype; ctx (B, HW, Cc), cast to
    the compute dtype before its product (a no-op for the UNet's output);
    ws[0] has shape (Ce + Cc, C1).  Returns (B, S, HW, Cout) f32 — or
    (B, S, Cout, HW) with ``cmajor`` — and with ``moments`` also the f32
    sum_S(out) and sum_S(out^2), each (B, HW, Cout).  Differentiable in
    e, ctx, the weights and the biases."""
    if len(ws) != len(bs) or len(ws) != len(acts):
        raise ValueError("pathnet_head: ws, bs and acts differ in length")
    return _Head.apply(e, ctx, tuple(acts), moments, cmajor, len(ws), *ws, *bs)
