"""Per-pixel kernel application: the softmax gather (the KPCN and LBMC
hot op), the plain weighted gather and the splat (the SBMC hot op), and
their gradients.

Counterpart of ``wcmc_tpu/ops/kernel_apply.py``:

* ``kernel_gather_softmax(buf, logits, K)``:
  ``out[p, c] = sum_d softmax_d(logits[p]) * buf[p + d, c]``, an
  autograd Function.  Forward: the CUDA kernel K1
  (``csrc/gather_softmax.cu``) for CUDA tensors, ``gather_softmax_plain``
  for CPU tensors.  Backward: d(logits) with K2 (``outer_softmax``,
  ``csrc/outer_softmax.cu``) and, only when the buffer requires grad,
  d(buf) with K3 (``scatter_softmax``, ``csrc/scatter_softmax.cu``); on
  CPU tensors their plain versions ``outer_softmax_plain`` and
  ``scatter_softmax_plain`` (an f32 softmax, then the shift-sums
  ``_outer_plain`` / ``_scatter_plain``, as the reference's
  ``_gather_sm_bwd`` composes them);
* ``kernel_scatter(x, w, K)``: the splat
  ``out[q, c] = sum_d w[q - d, d] * x[q - d, c]`` onto the
  ``(h + K - 1) x (w + K - 1)`` canvas, an autograd Function.  Forward:
  the CUDA kernel K7 (``scatter``, ``csrc/scatter.cu``).  Backward, as the
  reference's ``_scatter_bwd`` composes it: ``dw = outer(x, g)`` with K8
  (``outer``, ``csrc/outer.cu``) and, only when ``x`` requires grad,
  ``dx = gather(g, w)`` with K9 (``gather``, ``csrc/gather.cu``);
* ``kernel_gather(buf, w, K)``: the plain weighted gather
  ``out[p, c] = sum_d w[p, d] * buf[p + d, c]``, an autograd Function.
  Forward: K9.  Backward, as the reference's ``_gather_bwd`` composes it:
  ``dw = outer(g, buf)`` with K8 and, only when the buffer requires grad,
  ``dbuf = scatter(g, w)`` with K7.  ``kernel_apply(..., softmax=False)``
  runs it;
* ``kernel_apply`` / ``kernel_apply_reference``: the public API.

Every kernel runs for CUDA tensors and its plain version
(``*_plain``) for CPU tensors; gradients come back in the inputs'
dtypes.

Geometry (channels-last): ``buf (B, H, W, C)``, logits or weights
``(B, h, w, K*K)`` with ``h = H - K + 1``; gather output ``(B, h, w, C)``,
splat output ``(B, H, W, C)``.  The logits and the weights may be a
strided view (the crop of a convolution output) as long as the K*K taps
of a pixel are contiguous.
"""

from __future__ import annotations

import torch

from wcmc_tpu_torch.ops import _build


def _gather_plain(buf, w, ksize):
    """``out[p, c] = sum_d w[p, d] * buf[p + d, c]`` as a shift-sum over
    the K*K taps (the reference's ``_gather_xla``)."""
    b, H, W, c = buf.shape
    h, w_ = H - ksize + 1, W - ksize + 1
    out = torch.zeros((b, h, w_, c), dtype=torch.promote_types(buf.dtype, w.dtype),
                      device=buf.device)
    for dy in range(ksize):
        for dx in range(ksize):
            d = dy * ksize + dx
            out += w[..., d:d + 1] * buf[:, dy:dy + h, dx:dx + w_, :]
    return out


def gather_softmax_plain(buf, logits, ksize):
    """Plain PyTorch version of K1: f32 softmax over the taps, then the
    shift-sum gather.  Returns ``buf``'s dtype."""
    _build.plain_calls["gather_softmax"] += 1
    p = torch.softmax(logits.float(), dim=-1)
    return _gather_plain(buf.float(), p, ksize).to(buf.dtype)


def _scatter_plain(x, w, ksize):
    """``out[q, c] = sum_d w[q - d, d] * x[q - d, c]`` as a shift-sum
    (the reference's ``_scatter_xla``)."""
    b, h, w_, c = x.shape
    out = torch.zeros((b, h + ksize - 1, w_ + ksize - 1, c),
                      dtype=torch.promote_types(x.dtype, w.dtype), device=x.device)
    for dy in range(ksize):
        for dx in range(ksize):
            d = dy * ksize + dx
            out[:, dy:dy + h, dx:dx + w_, :] += w[..., d:d + 1] * x
    return out


def _outer_plain(g, buf, ksize):
    """``dw[p, d] = sum_c g[p, c] * buf[p + d, c]`` (the reference's
    ``_outer_xla``)."""
    b, h, w_, c = g.shape
    return torch.stack([(g * buf[:, dy:dy + h, dx:dx + w_, :]).sum(dim=-1)
                        for dy in range(ksize) for dx in range(ksize)], dim=-1)


def gather_plain(buf, w, ksize):
    """Plain version of K9, the weighted gather: f32 math, returned in
    ``promote_types(buf.dtype, w.dtype)``."""
    _build.plain_calls["gather"] += 1
    return _gather_plain(buf.float(), w.float(), ksize).to(
        torch.promote_types(buf.dtype, w.dtype))


def scatter_plain(x, w, ksize):
    """Plain version of K7, the splat."""
    _build.plain_calls["scatter"] += 1
    return _scatter_plain(x, w, ksize)


def outer_plain(g, buf, ksize):
    """Plain version of K8, the tap-wise outer product."""
    _build.plain_calls["outer"] += 1
    return _outer_plain(g, buf, ksize)


def outer_softmax_plain(g, buf, logits, ksize):
    """Plain PyTorch version of K2: d(logits) of the softmax gather,
    ``P_d (dp_d - sum_e P_e dp_e)`` with ``dp = _outer_plain(g, buf)``,
    all in f32, rounded once to the logits' dtype."""
    _build.plain_calls["outer_softmax"] += 1
    p = torch.softmax(logits.float(), dim=-1)
    dp = _outer_plain(g.float(), buf.float(), ksize)
    return (p * (dp - (p * dp).sum(dim=-1, keepdim=True))).to(logits.dtype)


def scatter_softmax_plain(g, logits, ksize):
    """Plain PyTorch version of K3: d(buf) of the softmax gather,
    ``_scatter_plain(g, softmax(logits))`` in f32."""
    _build.plain_calls["scatter_softmax"] += 1
    return _scatter_plain(g.float(), torch.softmax(logits.float(), dim=-1), ksize)


def _check_geometry(buf, logits, ksize):
    if buf.dim() != 4 or logits.dim() != 4:
        raise ValueError("buf and logits must be (B, H, W, C) and (B, h, w, K*K)")
    b, H, W, _ = buf.shape
    want = (b, H - ksize + 1, W - ksize + 1, ksize * ksize)
    if ksize < 1 or ksize % 2 == 0 or want[1] < 1 or want[2] < 1:
        raise ValueError(f"gather: buffer {H}x{W} and odd ksize {ksize} give no output")
    if tuple(logits.shape) != want:
        raise ValueError(f"logits shape {tuple(logits.shape)} != {want}")


def _check_splat_geometry(x, w, ksize):
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError("splat: x and w must be (B, h, w, C) and (B, h, w, K*K)")
    if ksize < 1 or ksize % 2 == 0:
        raise ValueError(f"splat: ksize {ksize} is not odd")
    want = tuple(x.shape[:3]) + (ksize * ksize,)
    if tuple(w.shape) != want:
        raise ValueError(f"splat weights shape {tuple(w.shape)} != {want}")


def _check_card(name, logits, *tensors):
    """Device, dtype and stride contract of K1, K2 and K3 on the card."""
    if any(t.device.type != "cuda" or t.device != logits.device for t in tensors):
        raise ValueError(f"{name}: inputs on " + ", ".join(
            str(t.device) for t in (logits, *tensors)) + "; all must be on one CUDA device")
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: logits dtype {logits.dtype} is not float32 or bfloat16")
    if logits.stride(-1) != 1:
        raise ValueError(f"{name}: the K*K taps of a pixel must be contiguous "
                         "(logits.stride(-1) == 1)")


def _gather_softmax_fwd(buf, logits, ksize):
    if buf.device.type == "cpu" and logits.device.type == "cpu":
        return gather_softmax_plain(buf, logits, ksize)
    _check_card("gather_softmax", logits, buf)
    b, H, W, c = buf.shape
    src = buf.float().contiguous()
    out = torch.empty((b, H - ksize + 1, W - ksize + 1, c), dtype=torch.float32,
                      device=buf.device)
    fn = _build.kernel(
        "wcmc_gather_softmax", _build.PTR, _build.PTR, _build.INT, _build.PTR,
        _build.INT, _build.INT, _build.INT, _build.INT, _build.INT,
        _build.LONG, _build.LONG, _build.LONG, _build.INT, _build.PTR)
    sb, sy, sx, _ = logits.stride()
    _build.check(fn(src.data_ptr(), logits.data_ptr(),
                    int(logits.dtype == torch.bfloat16), out.data_ptr(),
                    b, H, W, c, ksize, sb, sy, sx, buf.device.index or 0,
                    _build.stream_of(buf.device)), "gather_softmax")
    _build.launches["gather_softmax"] += 1
    return out.to(buf.dtype)


def outer_softmax(g, buf, logits, ksize: int):
    """d(logits) of the softmax gather for the output cotangent ``g``
    (B, h, w, C): kernel K2 for CUDA tensors, ``outer_softmax_plain``
    for CPU tensors.  Returned contiguous in the logits' dtype."""
    _check_geometry(buf, logits, ksize)
    if tuple(g.shape) != tuple(logits.shape[:3]) + (buf.shape[-1],):
        raise ValueError(f"outer_softmax: cotangent shape {tuple(g.shape)} does not match "
                         f"logits {tuple(logits.shape)} and buffer {tuple(buf.shape)}")
    if g.device.type == "cpu" and logits.device.type == "cpu":
        return outer_softmax_plain(g, buf, logits, ksize)
    _check_card("outer_softmax", logits, g, buf)
    if ksize * ksize > 448:
        raise ValueError(f"outer_softmax kernel takes K*K <= 448, got K={ksize}")
    b, H, W, c = buf.shape
    gf = g.float().contiguous()
    src = buf.float().contiguous()
    out = torch.empty(tuple(logits.shape), dtype=logits.dtype, device=logits.device)
    fn = _build.kernel(
        "wcmc_outer_softmax", _build.PTR, _build.PTR, _build.PTR, _build.INT, _build.PTR,
        _build.INT, _build.INT, _build.INT, _build.INT, _build.INT,
        _build.LONG, _build.LONG, _build.LONG, _build.INT, _build.PTR)
    sb, sy, sx, _ = logits.stride()
    _build.check(fn(gf.data_ptr(), src.data_ptr(), logits.data_ptr(),
                    int(logits.dtype == torch.bfloat16), out.data_ptr(),
                    b, H, W, c, ksize, sb, sy, sx, logits.device.index or 0,
                    _build.stream_of(logits.device)), "outer_softmax")
    _build.launches["outer_softmax"] += 1
    return out


def scatter_softmax(g, logits, ksize: int):
    """d(buf) of the softmax gather for the output cotangent ``g``
    (B, h, w, C), as f32 (B, h + K - 1, w + K - 1, C): kernel K3 for
    CUDA tensors (two launches, softmax statistics then the gather,
    counted as one), ``scatter_softmax_plain`` for CPU tensors."""
    b, h, w, c = g.shape
    if tuple(logits.shape) != (b, h, w, ksize * ksize):
        raise ValueError(f"logits shape {tuple(logits.shape)} != {(b, h, w, ksize * ksize)}")
    if g.device.type == "cpu" and logits.device.type == "cpu":
        return scatter_softmax_plain(g, logits, ksize)
    _check_card("scatter_softmax", logits, g)
    gf = g.float().contiguous()
    stats = torch.empty((b, h, w, 2), dtype=torch.float32, device=g.device)
    out = torch.empty((b, h + ksize - 1, w + ksize - 1, c), dtype=torch.float32,
                      device=g.device)
    fn = _build.kernel(
        "wcmc_scatter_softmax", _build.PTR, _build.PTR, _build.INT, _build.PTR, _build.PTR,
        _build.INT, _build.INT, _build.INT, _build.INT, _build.INT,
        _build.LONG, _build.LONG, _build.LONG, _build.INT, _build.PTR)
    sb, sy, sx, _ = logits.stride()
    _build.check(fn(gf.data_ptr(), logits.data_ptr(), int(logits.dtype == torch.bfloat16),
                    stats.data_ptr(), out.data_ptr(), b, h, w, c, ksize, sb, sy, sx,
                    g.device.index or 0, _build.stream_of(g.device)), "scatter_softmax")
    _build.launches["scatter_softmax"] += 1
    return out


def scatter(x, w, ksize: int):
    """The splat of f32 values ``x`` (B, h, w, C) with f32 weights ``w``
    (B, h, w, K*K), as f32 (B, h + K - 1, w + K - 1, C): kernel K7 for
    CUDA tensors, ``scatter_plain`` for CPU tensors."""
    _check_splat_geometry(x, w, ksize)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return scatter_plain(x, w, ksize)
    _check_card("scatter", w, x)
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"scatter kernel takes float32 values and weights, got {x.dtype} "
                        f"and {w.dtype}")
    b, h, w_, c = x.shape
    src = x.contiguous()
    out = torch.empty((b, h + ksize - 1, w_ + ksize - 1, c), dtype=torch.float32,
                      device=x.device)
    fn = _build.kernel(
        "wcmc_scatter", _build.PTR, _build.PTR, _build.PTR, _build.INT, _build.INT,
        _build.INT, _build.INT, _build.INT, _build.LONG, _build.LONG, _build.LONG,
        _build.INT, _build.PTR)
    sb, sy, sx, _ = w.stride()
    _build.check(fn(src.data_ptr(), w.data_ptr(), out.data_ptr(), b, h, w_, c, ksize,
                    sb, sy, sx, x.device.index or 0, _build.stream_of(x.device)), "scatter")
    _build.launches["scatter"] += 1
    return out


def gather(buf, w, ksize: int):
    """The weighted gather of ``buf`` (B, H, W, C) with f32 or bf16
    weights ``w`` (B, h, w, K*K), in ``promote_types(buf.dtype,
    w.dtype)``: kernel K9 for CUDA tensors (f32 math), ``gather_plain``
    for CPU tensors."""
    _check_geometry(buf, w, ksize)
    if buf.device.type == "cpu" and w.device.type == "cpu":
        return gather_plain(buf, w, ksize)
    _check_card("gather", w, buf)
    b, H, W, c = buf.shape
    src = buf.float().contiguous()
    out = torch.empty((b, H - ksize + 1, W - ksize + 1, c), dtype=torch.float32,
                      device=buf.device)
    fn = _build.kernel(
        "wcmc_gather", _build.PTR, _build.PTR, _build.INT, _build.PTR,
        _build.INT, _build.INT, _build.INT, _build.INT, _build.INT,
        _build.LONG, _build.LONG, _build.LONG, _build.INT, _build.PTR)
    sb, sy, sx, _ = w.stride()
    _build.check(fn(src.data_ptr(), w.data_ptr(), int(w.dtype == torch.bfloat16),
                    out.data_ptr(), b, H, W, c, ksize, sb, sy, sx, buf.device.index or 0,
                    _build.stream_of(buf.device)), "gather")
    _build.launches["gather"] += 1
    return out.to(torch.promote_types(buf.dtype, w.dtype))


def outer(g, buf, ksize: int):
    """``dw[p, d] = sum_c g[p, c] * buf[p + d, c]`` for ``g`` (B, h, w, C)
    and ``buf`` (B, h + K - 1, w + K - 1, C), as f32 (B, h, w, K*K):
    kernel K8 for CUDA tensors, ``outer_plain`` for CPU tensors."""
    b, h, w, c = g.shape
    if buf.dim() != 4 or tuple(buf.shape) != (b, h + ksize - 1, w + ksize - 1, c):
        raise ValueError(f"outer: buffer shape {tuple(buf.shape)} does not match "
                         f"{tuple(g.shape)} and ksize {ksize}")
    if g.device.type == "cpu" and buf.device.type == "cpu":
        return outer_plain(g.float(), buf.float(), ksize)
    _check_card("outer", g, buf)
    if ksize * ksize > 448:
        raise ValueError(f"outer kernel takes K*K <= 448, got K={ksize}")
    gf = g.float().contiguous()
    src = buf.float().contiguous()
    out = torch.empty((b, h, w, ksize * ksize), dtype=torch.float32, device=g.device)
    fn = _build.kernel(
        "wcmc_outer", _build.PTR, _build.PTR, _build.PTR, _build.INT, _build.INT, _build.INT,
        _build.INT, _build.INT, _build.INT, _build.PTR)
    _build.check(fn(gf.data_ptr(), src.data_ptr(), out.data_ptr(), b, h + ksize - 1,
                    w + ksize - 1, c, ksize, g.device.index or 0, _build.stream_of(g.device)),
                 "outer")
    _build.launches["outer"] += 1
    return out


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, ksize):
        ctx.ksize = ksize
        ctx.save_for_backward(x, w)
        return scatter(x, w, ksize)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = gather(g, w, ctx.ksize).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = outer(x, g, ctx.ksize).to(w.dtype)
        return dx, dw, None


def kernel_scatter(x, w, ksize: int):
    """The splat ``out[q, c] = sum_d w[q - d, d] * x[q - d, c]`` onto the
    ``(h + K - 1) x (w + K - 1)`` canvas, differentiable in ``x`` and
    ``w``: K7 forward, K8 (d w) and K9 (d x) backward on the card, the
    plain versions on the CPU."""
    return _Scatter.apply(x, w, ksize)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, buf, w, ksize):
        ctx.ksize = ksize
        ctx.save_for_backward(buf, w)
        return gather(buf, w, ksize)

    @staticmethod
    def backward(ctx, g):
        buf, w = ctx.saved_tensors
        dbuf = dw = None
        if ctx.needs_input_grad[1]:
            dw = outer(g, buf, ctx.ksize).to(w.dtype)
        if ctx.needs_input_grad[0]:
            # K7 splats f32 values with f32 weights
            dbuf = scatter(g.float(), w.float(), ctx.ksize).to(buf.dtype)
        return dbuf, dw, None


def kernel_gather(buf, w, ksize: int):
    """The weighted gather ``out[p, c] = sum_d w[p, d] * buf[p + d, c]``,
    differentiable in ``buf`` and ``w``: K9 forward, K8 (d w) and K7
    (d buf) backward on the card, the plain versions on the CPU."""
    _check_geometry(buf, w, ksize)
    return _Gather.apply(buf, w, ksize)


class _GatherSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, buf, logits, ksize):
        ctx.ksize = ksize
        ctx.save_for_backward(buf, logits)
        return _gather_softmax_fwd(buf, logits, ksize)

    @staticmethod
    def backward(ctx, g):
        buf, logits = ctx.saved_tensors
        dbuf = dlogits = None
        if ctx.needs_input_grad[1]:
            dlogits = outer_softmax(g, buf, logits, ctx.ksize)
        if ctx.needs_input_grad[0]:
            dbuf = scatter_softmax(g, logits, ctx.ksize).to(buf.dtype)
        return dbuf, dlogits, None


def kernel_gather_softmax(buf, logits, ksize: int):
    """Softmax-normalized per-pixel gather; ``logits`` f32 or bf16,
    differentiable in both arguments.

    CPU tensors run the plain versions.  CUDA tensors launch K1 forward
    and K2 (and K3 for a buffer that requires grad) backward: the
    softmax is computed in f32 inside the kernels, so the probability
    tensor never exists in device memory."""
    _check_geometry(buf, logits, ksize)
    return _GatherSoftmax.apply(buf, logits, ksize)


def kernel_apply(buf, kernels, ksize: int, softmax: bool = True):
    """KPCN-style weighted-neighborhood reconstruction.

    Args:
      buf:     (B, H, W, C) radiance buffer.
      kernels: (B, h, w, K*K) per-pixel kernel logits (weights without
        ``softmax``), h = H - K + 1.
      softmax: normalize each pixel's K*K window with a softmax
        (:func:`kernel_gather_softmax`); without it the weighted gather
        :func:`kernel_gather` runs.
    Returns:
      (B, h, w, C) reconstruction.
    """
    if softmax:
        return kernel_gather_softmax(buf, kernels, ksize)
    return kernel_gather(buf, kernels, ksize)


def kernel_apply_reference(buf, kernels, ksize: int, softmax: bool = True):
    """Plain version of :func:`kernel_apply` on any device: the softmax
    runs in ``kernels``' dtype, as in the reference."""
    if softmax:
        kernels = torch.softmax(kernels, dim=-1)
    return _gather_plain(buf, kernels, ksize)
