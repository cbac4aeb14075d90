"""PathNet's per-sample MLPs: the embedding with its fused sample mean,
and the head over [e | broadcast_S(ctx)] with its fused sample moments.

Counterpart of the forward of ``wcmc_tpu/ops/pathnet_fused.py``
(reference dataflow: ``e = MLP_embed(paths)``, ``ctx = UNet(mean_S(e))``,
``out = MLP_head(concat(e, broadcast_S(ctx)))``).

* ``pathnet_embed``: CUDA kernel K4-fwd (``csrc/pathnet_embed.cu``),
  plain version ``_embed_plain``;
* ``pathnet_head``: CUDA kernel K5-fwd (``csrc/pathnet_head.cu``),
  plain version ``_head_plain``.

CPU tensors run the plain versions; CUDA tensors launch the kernels,
which compute in bfloat16 with f32 accumulation (the serving path's
compute dtype) and raise for other dtypes.  The plain versions round
where the reference's Pallas kernels round: after every embedding layer,
after every hidden head layer, and NOT after the last head layer, whose
f32 value is the output and feeds the moments.  (The reference's XLA
head path rounds the last layer too; in float32 the two agree.)
The backward passes come with the training port.
"""

from __future__ import annotations

import torch

from wcmc_tpu_torch.ops import _build
from wcmc_tpu_torch.ops.mlp_fused import _act, _mlp_plain, matmul_f32

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


def pathnet_embed(x, ws, bs, acts=EMBED_ACTS):
    """(B, S, HW, C0) rows -> (e (B, S, HW, Cout) in x.dtype,
    mean_S(e) (B, HW, Cout) f32)."""
    if len(ws) != len(bs) or len(ws) != len(acts):
        raise ValueError("pathnet_embed: ws, bs and acts differ in length")
    if x.device.type == "cpu":
        return _embed_plain(x, ws, bs, acts)
    dev = _require_cuda("pathnet_embed", x, *ws, *bs)
    if tuple(acts) != EMBED_ACTS:
        raise ValueError(f"pathnet_embed kernel computes {EMBED_ACTS}, got {tuple(acts)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"pathnet_embed kernel computes in bfloat16, got {x.dtype}")
    b, s, hw, c0 = x.shape
    dims = [c0] + [w.shape[1] for w in ws]
    for w, ci, co in zip(ws, dims[:-1], dims[1:]):
        if tuple(w.shape) != (ci, co) or co % 16:
            raise ValueError(f"pathnet_embed: weight {tuple(w.shape)} is not "
                             f"({ci}, {co}) with {co} a multiple of 16")
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


def pathnet_head(e, ctx, ws, bs, acts=HEAD_ACTS, moments=False, cmajor=False):
    """Head chain over [e | broadcast_S(ctx)] without materializing the
    concat. e (B, S, HW, Ce) in compute dtype; ctx (B, HW, Cc), cast to
    the compute dtype before its product (a no-op for the UNet's output
    on the serving path); ws[0] has shape (Ce + Cc, C1).  Returns (B, S, HW, Cout) f32 — or
    (B, S, Cout, HW) with ``cmajor`` — and with ``moments`` also the f32
    sum_S(out) and sum_S(out^2), each (B, HW, Cout)."""
    if len(ws) != len(bs) or len(ws) != len(acts):
        raise ValueError("pathnet_head: ws, bs and acts differ in length")
    if e.device.type == "cpu":
        return _head_plain(e, ctx, ws, bs, acts, moments, cmajor)
    dev = _require_cuda("pathnet_head", e, ctx, *ws, *bs)
    if tuple(acts) != HEAD_ACTS:
        raise ValueError(f"pathnet_head kernel computes {HEAD_ACTS}, got {tuple(acts)}")
    if e.dtype != torch.bfloat16:
        raise TypeError(f"pathnet_head kernel computes in bfloat16, got {e.dtype}")
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
