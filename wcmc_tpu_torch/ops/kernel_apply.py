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
  the CUDA kernel K7 (``scatter``, ``csrc/scatter.cu``: the banded body
  that ``splat_plan`` lays out, or the gather body for strided weights).
  Backward, as the reference's ``_scatter_bwd`` composes it:
  ``dw = outer(x, g)`` with K8 (``outer``, ``csrc/outer.cu``: the tiled
  body of ``outer_plan``) and, only when ``x`` requires grad,
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

import functools
from typing import NamedTuple

import torch

from wcmc_tpu_torch.ops import _build
from wcmc_tpu_torch.ops.conv5 import SMEM_LIMIT
from wcmc_tpu_torch.ops.mlp_fused import _r128

SPLAT_RUN = 32      # source pixels a run of K7's banded body and of K8's tiled body
SPLAT_STAGES = 3    # runs in K7's landing ring: the two a step reads, one landing
SPLAT_ROWS = 32     # source rows a band of K7's banded body


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


class SplatPlan(NamedTuple):
    """How K7 splats (h, w) sources of C channels with K x K taps: on the
    banded body (``banded``), in bands of ``rows`` source rows and tiles of
    ``cols`` source columns (``bands`` x ``tiles`` blocks an image), its
    runs of ``run`` pixels landing in a ring of ``stages``; ``smem`` the
    block's shared memory as (buffer, bytes) pairs in the order the kernel
    carves them, each a multiple of 128 bytes, ``total`` their sum (what
    ``wcmc_scatter_banded_smem`` returns), ``scratch`` the f32 band
    partials of an image.  On the gather body ``banded`` is False and the
    rest 0."""
    banded: bool
    rows: int
    cols: int
    bands: int
    tiles: int
    run: int
    stages: int
    smem: tuple
    total: int
    scratch: int


@functools.lru_cache(maxsize=None)
def splat_plan(h, w, c, k, contiguous=True) -> SplatPlan:
    """K7's plan.  The banded body takes contiguous weights and K <= 33 (a
    step's sources are its run and the one before); its block carves the
    weight ring (3 runs of 32 x K*K f32), the value ring, K canvas rows of
    ``cols + K - 1`` cells of C f32 padded to 4 or 8, and the mbarriers.
    ``cols`` is the widest multiple of 32, up to the whole row, whose carve
    fits in a block's shared memory.  Everything else runs the gather body.
    ValueError for what neither body computes."""
    if not 1 <= c <= 8:
        raise ValueError(f"scatter kernel takes 1 to 8 channels, got {c}")
    if k < 1 or k % 2 == 0 or h < 1 or w < 1:
        raise ValueError(f"scatter: no splat of {h}x{w} sources with ksize {k}")
    if contiguous and k - 1 <= SPLAT_RUN:
        cs = 4 if c <= 4 else 8
        r = min(SPLAT_ROWS, h)
        for cols in range(-(-w // SPLAT_RUN) * SPLAT_RUN, 0, -SPLAT_RUN):
            smem = (("weights", _r128(4 * SPLAT_STAGES * SPLAT_RUN * k * k)),
                    ("values", _r128(4 * SPLAT_STAGES * SPLAT_RUN * c)),
                    ("canvas", _r128(4 * k * (cols + k - 1) * cs)),
                    ("bars", _r128(8 * SPLAT_STAGES)))
            total = sum(m for _, m in smem)
            if total <= SMEM_LIMIT:
                bands, tiles = -(-h // r), -(-w // cols)
                return SplatPlan(True, r, cols, bands, tiles, SPLAT_RUN, SPLAT_STAGES, smem,
                                 total, bands * tiles * (r + k - 1) * (cols + k - 1) * c)
    return SplatPlan(False, 0, 0, 0, 0, 0, 0, (), 0, 0)


def scatter_route(x, w, ksize):
    """The body a K7 launch on these tensors runs, and how the banded
    body's spans land: ("banded", "bulk") where every run starts on 16
    bytes (w a multiple of 4, both tensors 16-byte aligned), ("banded",
    "4-byte") otherwise, ("gather", None) where ``splat_plan`` gives the
    gather body.  The kernel makes the same choice from the same facts."""
    b, h, w_, c = x.shape
    if not splat_plan(h, w_, c, ksize, w.is_contiguous()).banded:
        return "gather", None
    bulk = w_ % 4 == 0 and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    return "banded", "bulk" if bulk else "4-byte"


def _scatter_banded_walk(x, w, ksize):
    """A plain walk of K7's banded order on the CPU, in f32: each band of
    ``plan.rows`` source rows and tile of ``plan.cols`` source columns
    takes its rows in order, and each row its steps r = 0 .. nr (the tail
    step r = nr reads only the last run); at step r the 32 lanes own canvas
    columns 32 r + lane of the tile, sum the taps dx = 0 .. K - 1 for every
    dy into registers, and add each dy's sum into a ring of K canvas rows;
    a canvas row leaves the ring for the band's partial once its source row
    is done, the last K - 1 after the band.  The partials are then summed
    cell by cell in band order, then tile order.  Returns what
    ``scatter_plain`` returns (the kernel rounds each multiply-add once,
    this walk twice)."""
    b, h, w_, c = x.shape
    k = ksize
    plan = splat_plan(h, w_, c, k)
    t, wt = plan.run, plan.cols
    xf, wf = x.float(), w.float()
    lanes = torch.arange(t)
    out = torch.zeros((b, h + k - 1, w_ + k - 1, c))
    for i in range(plan.bands):
        y0 = i * plan.rows
        rows = min(plan.rows, h - y0)
        for j in range(plan.tiles):
            x0 = j * wt
            cols = min(wt, w_ - x0)
            wcj, nr = cols + k - 1, -(-cols // t)
            ring = torch.zeros((b, k, wt + k - 1, c))
            part = torch.zeros((b, rows + k - 1, wcj, c))
            for yl in range(rows):
                wrow = wf[:, y0 + yl, x0:x0 + cols].reshape(b, cols, k, k)   # [b, p, dy, dx]
                xrow = xf[:, y0 + yl, x0:x0 + cols]
                for r in range(nr + 1):
                    col = r * t + lanes
                    acc = torch.zeros((b, t, k, c))
                    for dx in range(k):
                        p = col - dx
                        ok = ((p >= 0) & (p < cols))[:, None]
                        pc = p.clamp(0, cols - 1)
                        wv, xv = wrow[:, pc, :, dx] * ok, xrow[:, pc] * ok
                        acc = acc + wv[..., None] * xv[:, :, None]
                    keep = col < wcj
                    slots = (yl + torch.arange(k)) % k
                    ring[:, slots[:, None], col[keep][None, :]] += acc[:, keep].transpose(1, 2)
                part[:, yl] = ring[:, yl % k, :wcj]
                ring[:, yl % k] = 0
            for row in range(rows, rows + k - 1):
                part[:, row] = ring[:, row % k, :wcj]
            out[:, y0:y0 + rows + k - 1, x0:x0 + wcj] += part
    return out


class OuterPlan(NamedTuple):
    """K8's tiled body for C channels and K x K taps: runs of ``run``
    pixels of one row, units of ``rows`` runs down a column, canvas-
    cotangent window rows of ``pitch`` f32, and the block's shared memory
    ``smem`` as (buffer, bytes) pairs in the order the kernel carves them
    (the window ring of K + 1 row slots each kept twice, two value runs,
    two staging tiles of a run's dw span, the mbarriers), ``total`` their
    sum (what ``wcmc_outer_tiled_smem`` returns)."""
    run: int
    rows: int
    pitch: int
    smem: tuple
    total: int


@functools.lru_cache(maxsize=None)
def outer_plan(c, k) -> OuterPlan:
    """K8's plan; ValueError for what the kernel does not take (C above 8,
    K*K above 448)."""
    if not 1 <= c <= 8:
        raise ValueError(f"outer kernel takes 1 to 8 channels, got {c}")
    if k < 1 or k * k > 448:
        raise ValueError(f"outer kernel takes K*K <= 448, got K={k}")
    t = SPLAT_RUN
    pitch = -(-(t + k - 1) * c // 4) * 4
    smem = (("window", _r128(4 * 2 * (k + 1) * pitch)), ("values", _r128(4 * 2 * t * c)),
            ("tiles", _r128(4 * 2 * t * k * k)), ("bars", _r128(8 * 2)))
    total = sum(m for _, m in smem)
    if total > SMEM_LIMIT:
        raise ValueError(f"outer kernel needs {total} bytes of shared memory at C={c}, K={k}")
    return OuterPlan(t, SPLAT_RUN, pitch, smem, total)


def _outer_tiled_walk(g, buf, ksize):
    """A plain walk of K8's tiled order on the CPU: units of ``rows`` runs
    down a column of runs of 32 pixels, each run from the window of K
    canvas rows x (32 + K - 1) columns that slides down the unit a row at a
    time (a ring of K + 1 row slots) and its values, every tap's output the
    sum over the channels as ``outer_plain`` takes it.  Returns what
    ``outer_plain`` returns, bit for bit."""
    b, h, w_, c = g.shape
    k = ksize
    plan = outer_plan(c, k)
    dw = torch.empty((b, h, w_, k * k), dtype=torch.promote_types(g.dtype, buf.dtype))
    for x0 in range(0, w_, plan.run):
        n = min(plan.run, w_ - x0)
        for y0 in range(0, h, plan.rows):
            ring = {row: buf[:, row, x0:x0 + n + k - 1] for row in range(y0, y0 + k)}
            for y in range(y0, min(h, y0 + plan.rows)):
                ring = {row: v for row, v in ring.items() if row >= y}
                ring[y + k - 1] = buf[:, y + k - 1, x0:x0 + n + k - 1]
                assert len(ring) == k
                gv = g[:, y, x0:x0 + n]
                dw[:, y, x0:x0 + n] = torch.stack(
                    [(gv * ring[y + dy][:, dx:dx + n]).sum(dim=-1)
                     for dy in range(k) for dx in range(k)], dim=-1)
    return dw


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


def scatter(x, w, ksize: int, body=None):
    """The splat of f32 values ``x`` (B, h, w, C) with f32 weights ``w``
    (B, h, w, K*K), as f32 (B, h + K - 1, w + K - 1, C): kernel K7 for
    CUDA tensors, ``scatter_plain`` for CPU tensors.  On the card the body
    is ``splat_plan``'s (the banded one for contiguous weights); ``body``
    "gather" runs the gather body (the card tests' reference).  A launch
    runs that body or raises."""
    _check_splat_geometry(x, w, ksize)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return scatter_plain(x, w, ksize)
    _check_card("scatter", w, x)
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"scatter kernel takes float32 values and weights, got {x.dtype} "
                        f"and {w.dtype}")
    b, h, w_, c = x.shape
    plan = splat_plan(h, w_, c, ksize, w.is_contiguous())
    body = body or ("banded" if plan.banded else "gather")
    if body not in ("banded", "gather") or (body == "banded" and not plan.banded):
        raise ValueError(f"scatter: no {body} body for weights {tuple(w.shape)} with strides "
                         f"{w.stride()} at C={c}")
    src = x.contiguous()
    out = torch.empty((b, h + ksize - 1, w_ + ksize - 1, c), dtype=torch.float32,
                      device=x.device)
    dev = x.device.index or 0
    if body == "banded":
        part = torch.empty(b * plan.scratch, dtype=torch.float32, device=x.device)
        fn = _build.kernel(
            "wcmc_scatter_banded", _build.PTR, _build.PTR, _build.PTR, _build.PTR, _build.INT,
            _build.INT, _build.INT, _build.INT, _build.INT, _build.INT, _build.INT, _build.INT,
            _build.PTR)
        _build.check(fn(src.data_ptr(), w.data_ptr(), part.data_ptr(), out.data_ptr(), b, h, w_,
                        c, ksize, plan.rows, plan.cols, dev, _build.stream_of(x.device)),
                     "scatter")
    else:
        fn = _build.kernel(
            "wcmc_scatter", _build.PTR, _build.PTR, _build.PTR, _build.INT, _build.INT,
            _build.INT, _build.INT, _build.INT, _build.LONG, _build.LONG, _build.LONG,
            _build.INT, _build.PTR)
        sb, sy, sx, _ = w.stride()
        _build.check(fn(src.data_ptr(), w.data_ptr(), out.data_ptr(), b, h, w_, c, ksize,
                        sb, sy, sx, dev, _build.stream_of(x.device)), "scatter")
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


def outer(g, buf, ksize: int, body=None):
    """``dw[p, d] = sum_c g[p, c] * buf[p + d, c]`` for ``g`` (B, h, w, C)
    and ``buf`` (B, h + K - 1, w + K - 1, C), as f32 (B, h, w, K*K):
    kernel K8 for CUDA tensors (its tiled body; ``body`` "warp" runs the
    first port's one-warp-per-pixel body, the card tests' reference, with
    the same bits), ``outer_plain`` for CPU tensors."""
    b, h, w, c = g.shape
    if buf.dim() != 4 or tuple(buf.shape) != (b, h + ksize - 1, w + ksize - 1, c):
        raise ValueError(f"outer: buffer shape {tuple(buf.shape)} does not match "
                         f"{tuple(g.shape)} and ksize {ksize}")
    if g.device.type == "cpu" and buf.device.type == "cpu":
        return outer_plain(g.float(), buf.float(), ksize)
    _check_card("outer", g, buf)
    outer_plan(c, ksize)
    if body not in (None, "tiled", "warp"):
        raise ValueError(f"outer: no {body} body")
    gf = g.float().contiguous()
    src = buf.float().contiguous()
    out = torch.empty((b, h, w, ksize * ksize), dtype=torch.float32, device=g.device)
    dev = g.device.index or 0
    if body == "warp":
        fn = _build.kernel(
            "wcmc_outer", _build.PTR, _build.PTR, _build.PTR, _build.INT, _build.INT,
            _build.INT, _build.INT, _build.INT, _build.INT, _build.PTR)
        err = fn(gf.data_ptr(), src.data_ptr(), out.data_ptr(), b, h + ksize - 1, w + ksize - 1,
                 c, ksize, dev, _build.stream_of(g.device))
    else:
        fn = _build.kernel(
            "wcmc_outer_tiled", _build.PTR, _build.PTR, _build.PTR, _build.INT, _build.INT,
            _build.INT, _build.INT, _build.INT, _build.INT, _build.INT, _build.PTR)
        err = fn(gf.data_ptr(), src.data_ptr(), out.data_ptr(), b, h + ksize - 1, w + ksize - 1,
                 c, ksize, _build.sm_count(dev), dev, _build.stream_of(g.device))
    _build.check(err, "outer")
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
