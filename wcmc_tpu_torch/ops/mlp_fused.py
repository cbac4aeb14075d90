"""Fused per-pixel MLP (a chain of 1x1 convolutions over rows), and the
row-wise MLP helpers the PathNet plain versions share.

Counterpart of ``wcmc_tpu/ops/mlp_fused.py``: the activation table, its
gradient through the post-activation value (``_act_grad``), the plain
chain (``_mlp_xla`` there, :func:`_mlp_plain` here), and ``fused_mlp``,
an autograd Function:

* forward: the CUDA kernel K10-fwd (``csrc/mlp_fused.cu``) for CUDA
  tensors, the plain version ``_mlp_fwd_plain`` for CPU tensors;
* backward: K10-bwd (``csrc/mlp_fused_bwd.cu``), plain version
  ``_mlp_bwd_plain``.

The kernels compute in bfloat16 with f32 accumulation and raise for
other dtypes, for more than ``MLP_MAX_LAYERS`` layers and for widths over
``MLP_MAX_WIDTH``.  The plain versions round where the reference's
Pallas kernels round: forward, after every layer; backward, the hiddens
are recomputed in the compute dtype, the output cotangent is rounded to
it, each layer's cotangent is rounded to it before its products, dW and
db (from the unrounded cotangent) stay f32, and d(x) is rounded once.
"""

from __future__ import annotations

import torch

from wcmc_tpu_torch.ops import _build

ACTS = ("linear", "relu", "leaky_relu")   # the kernels' activation codes 0, 1, 2
MLP_MAX_LAYERS = 4
MLP_MAX_WIDTH = 64


def _act(name: str, z):
    if name == "relu":
        return torch.clamp(z, min=0.0)
    if name == "leaky_relu":
        return torch.where(z >= 0, z, 0.01 * z)
    if name == "linear":
        return z
    raise ValueError(f"unsupported activation {name!r}")


def _act_grad(name: str, h, g):
    """Activation gradient through the POST-activation value ``h``, as
    the reference's backward kernels take it: for relu and leaky_relu
    the sign of ``h`` says what the sign of the pre-activation says."""
    hf = h.float()
    if name == "relu":
        return torch.where(hf > 0, g, torch.zeros((), dtype=g.dtype, device=g.device))
    if name == "leaky_relu":
        return torch.where(hf >= 0, g, 0.01 * g)
    if name == "linear":
        return g
    raise ValueError(f"unsupported activation {name!r}")


def matmul_f32(h, w):
    """``h @ w`` of values in ``h``'s dtype, accumulated in float32 —
    the reference's ``jnp.dot(h, w.astype(h.dtype),
    preferred_element_type=float32)``.  bf16 values convert to f32
    exactly, so this is a bf16 product with f32 accumulation."""
    return h.float() @ w.to(h.dtype).float()


def _mlp_plain(x, ws, bs, acts):
    """Plain chain: every layer accumulates in f32, adds its f32 bias,
    applies its activation and rounds to ``x``'s dtype."""
    h = x
    for w, b, a in zip(ws, bs, acts):
        h = _act(a, matmul_f32(h, w) + b.float()).to(x.dtype)
    return h


def _mlp_bwd_rows(x, g, ws, bs, acts, compute_dx):
    """The chain's backward over rows ``x`` (N, C0) for the f32 output
    cotangent ``g`` (N, C_L), rounded as the Pallas backward kernels
    round: ``(dx in x.dtype or None, dWs, dbs)``, dW and db f32."""
    dt = x.dtype
    hs = [x]
    for w, b, a in zip(ws, bs, acts):
        hs.append(_act(a, matmul_f32(hs[-1], w) + b.float()).to(dt))
    n = len(ws)
    dws, dbs = [None] * n, [None] * n
    for i in reversed(range(n)):
        gz = _act_grad(acts[i], hs[i + 1], g)
        gz_c = gz.to(dt)
        dws[i] = hs[i].float().t() @ gz_c.float()
        dbs[i] = gz.sum(dim=0)
        if i > 0 or compute_dx:
            g = gz_c.float() @ ws[i].to(dt).float().t()
    return (g.to(dt) if compute_dx else None), dws, dbs


def _mlp_fwd_plain(x, ws, bs, acts):
    """Plain version of K10-fwd."""
    _build.plain_calls["mlp_fused"] += 1
    return _mlp_plain(x, ws, bs, acts)


def _mlp_bwd_plain(x, g, ws, bs, acts, compute_dx=True):
    """Plain version of K10-bwd: the cotangent arrives rounded to the
    compute dtype, as the reference's ``_mlp_bwd_pallas`` takes it."""
    _build.plain_calls["mlp_fused_bwd"] += 1
    return _mlp_bwd_rows(x, g.to(x.dtype).float(), ws, bs, acts, compute_dx)


def _check_card(name, x, ws, bs, acts):
    """What K10 computes: bf16 rows on one CUDA device, 1 to
    MLP_MAX_LAYERS layers of the three activations, C0 <= MLP_MAX_WIDTH
    and every layer width a multiple of 16 up to MLP_MAX_WIDTH.  Returns
    the widths and the activation codes."""
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in (*ws, *bs)):
        raise ValueError(f"{name}: inputs must all be on one CUDA device, got "
                         + ", ".join(str(t.device) for t in (x, *ws, *bs)))
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} kernel computes in bfloat16, got {x.dtype}")
    if not 1 <= len(ws) <= MLP_MAX_LAYERS:
        raise ValueError(f"{name} kernel takes 1 to {MLP_MAX_LAYERS} layers, got {len(ws)}")
    if any(a not in ACTS for a in acts):
        raise ValueError(f"{name} kernel computes the activations {ACTS}, got {tuple(acts)}")
    dims = [x.shape[-1]] + [w.shape[1] for w in ws]
    if not 1 <= dims[0] <= MLP_MAX_WIDTH:
        raise ValueError(f"{name} kernel takes 1 to {MLP_MAX_WIDTH} input channels, "
                         f"got {dims[0]}")
    for w, b, ci, co in zip(ws, bs, dims[:-1], dims[1:]):
        if tuple(w.shape) != (ci, co) or tuple(b.shape) != (co,):
            raise ValueError(f"{name}: weight {tuple(w.shape)} / bias {tuple(b.shape)} "
                             f"is not ({ci}, {co}) / ({co},)")
        if co % 16 or co > MLP_MAX_WIDTH:
            raise ValueError(f"{name} kernel takes layer widths that are multiples of 16 "
                             f"up to {MLP_MAX_WIDTH}, got {co}")
    return dims, [ACTS.index(a) for a in acts]


def _padded_params(x, ws, bs, codes):
    """bf16 weights with W0's rows zero-padded to a multiple of 16, f32
    biases, and the kernels' layer arguments: the 4 weight and 4 bias
    pointers (null beyond the last layer), the widths and the codes."""
    dev = x.device
    c0, c1 = x.shape[-1], ws[0].shape[1]
    k0 = -(-c0 // 16) * 16
    w0 = torch.zeros((k0, c1), dtype=torch.bfloat16, device=dev)
    w0[:c0] = ws[0]
    wb = [w0] + [w.to(torch.bfloat16).contiguous() for w in ws[1:]]
    bf = [b.float().contiguous() for b in bs]
    pad = MLP_MAX_LAYERS - len(ws)
    ptrs = ([w.data_ptr() for w in wb] + [None] * pad
            + [b.data_ptr() for b in bf] + [None] * pad)
    widths = [w.shape[1] for w in ws] + [0] * pad
    return k0, wb, bf, ptrs, widths, list(codes) + [0] * pad


def _mlp_fwd_kernel(x, ws, bs, acts):
    dims, codes = _check_card("mlp_fused", x, ws, bs, acts)
    dev = x.device
    x = x.contiguous()
    n = x.shape[0]
    out = torch.empty((n, dims[-1]), dtype=torch.bfloat16, device=dev)
    if n == 0:
        return out
    _, wb, bf, ptrs, widths, codes = _padded_params(x, ws, bs, codes)
    P, INT, L = _build.PTR, _build.INT, MLP_MAX_LAYERS
    fn = _build.kernel("wcmc_mlp_fused", P, *([P] * (2 * L)), P, _build.LONG, INT, INT,
                       *([INT] * (2 * L)), INT, INT, P)
    idx = dev.index or 0
    _build.check(fn(x.data_ptr(), *ptrs, out.data_ptr(), n, dims[0], len(ws), *widths,
                    *codes, 4 * _build.sm_count(idx), idx, _build.stream_of(dev)),
                 "mlp_fused")
    _build.launches["mlp_fused"] += 1
    return out


def _mlp_bwd_kernel(x, g, ws, bs, acts, compute_dx):
    dims, codes = _check_card("mlp_fused_bwd", x, ws, bs, acts)
    dev = x.device
    n = x.shape[0]
    if tuple(g.shape) != (n, dims[-1]) or g.device != dev:
        raise ValueError(f"mlp_fused_bwd: cotangent {tuple(g.shape)} on {g.device} does "
                         f"not match the output ({n}, {dims[-1]}) on {dev}")
    x = x.contiguous()
    g = g.to(torch.bfloat16).contiguous()
    k0, wb, bf, ptrs, widths, codes = _padded_params(x, ws, bs, codes)
    kdims = [k0] + dims[1:]
    sizes = ([ci * co for ci, co in zip(kdims[:-1], kdims[1:])] + dims[1:])
    n_parts = sum(sizes)
    idx = dev.index or 0
    n_blocks = 4 * _build.sm_count(idx)
    parts = torch.empty(n_blocks * n_parts, dtype=torch.float32, device=dev)
    out = torch.empty(n_parts, dtype=torch.float32, device=dev)
    dx = torch.empty((n, dims[0]), dtype=torch.bfloat16, device=dev) if compute_dx else None
    P, INT, L = _build.PTR, _build.INT, MLP_MAX_LAYERS
    fn = _build.kernel("wcmc_mlp_fused_bwd", P, P, *([P] * (2 * L)), P, P, P, _build.LONG,
                       INT, INT, *([INT] * (2 * L)), INT, INT, P)
    _build.check(fn(x.data_ptr(), g.data_ptr(), *ptrs, dx.data_ptr() if compute_dx else None,
                    parts.data_ptr(), out.data_ptr(), n, dims[0], len(ws), *widths, *codes,
                    n_blocks, idx, _build.stream_of(dev)), "mlp_fused_bwd")
    _build.launches["mlp_fused_bwd"] += 1
    chunks = torch.split(out, sizes)
    nl = len(ws)
    dws = [c.view(ci, co) for c, ci, co in zip(chunks[:nl], kdims[:-1], kdims[1:])]
    dws[0] = dws[0][:dims[0]]
    return dx, dws, list(chunks[nl:])


def mlp_fused_bwd(x, g, ws, bs, acts, compute_dx=True):
    """Gradients of :func:`fused_mlp` for the output cotangent ``g``:
    ``(dx in x.dtype or None, dWs, dbs)``, dW and db f32.  K10-bwd for
    CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return _mlp_bwd_plain(x, g, ws, bs, acts, compute_dx)
    return _mlp_bwd_kernel(x, g, ws, bs, acts, compute_dx)


class _FusedMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, acts, compute_dx, n, *params):
        ctx.acts, ctx.compute_dx, ctx.n = acts, compute_dx, n
        ctx.save_for_backward(x, *params)
        ws, bs = list(params[:n]), list(params[n:])
        if x.device.type == "cpu":
            return _mlp_fwd_plain(x, ws, bs, acts)
        return _mlp_fwd_kernel(x, ws, bs, acts)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        n = ctx.n
        ws, bs = params[:n], params[n:]
        dx, dws, dbs = mlp_fused_bwd(x, g, ws, bs, ctx.acts,
                                     ctx.compute_dx and ctx.needs_input_grad[0])
        if dx is None and ctx.needs_input_grad[0]:
            dx = torch.zeros_like(x)   # compute_dx=False: x is taken as data
        return (dx, None, None, None, *[d.to(w.dtype) for d, w in zip(dws, ws)],
                *[d.to(b.dtype) for d, b in zip(dbs, bs)])


def fused_mlp(x, ws, bs, acts, compute_dx: bool = True):
    """``y = act_L(... act_1(x W_1 + b_1) ... W_L + b_L)`` over the rows
    of ``x`` (N, C0), in ``x``'s dtype; ``ws[i]`` is (C_{i-1}, C_i) and
    ``bs[i]`` (C_i,), f32 parameters.  Differentiable in the weights and
    biases, and in ``x`` unless ``compute_dx`` is False (then ``x`` is
    taken as data and its gradient is zero, as in the reference)."""
    if len(ws) != len(bs) or len(ws) != len(acts):
        raise ValueError("fused_mlp: ws, bs and acts differ in length")
    return _FusedMLP.apply(x, tuple(acts), compute_dx, len(ws), *ws, *bs)
