"""The fused 2-D convolution of the opt-in fused KPCN inference.

Counterpart of ``wcmc_tpu/ops/conv5.py``: a VALID K x K convolution over
channels-last ``x (B, H, W, Cin)`` in the compute dtype, with weights
``w (K, K, Cin, Cout)`` (flax's HWIO layout) and a bias ``(Cout,)``, both
f32 parameters; the f32 bias and the activation (none / ``linear``,
``relu``, ``leaky_relu`` with slope 0.01) are applied to the f32 sum,
which is rounded once to ``x``'s dtype.  The unfused chain rounds the
convolution before its bias; this does not, as the reference's
``_conv_xla`` does not.

* ``conv2d_plain``: the plain version (the reference's ``_conv_xla``),
  for CPU tensors, the tests and ``chip_smoke.py``'s comparison;
* ``conv2d``: an autograd Function.  Forward: the CUDA kernel K6
  (``csrc/conv5.cu``) for CUDA tensors, the plain version for CPU
  tensors; the kernel tiles rows and columns, so it takes every H and W
  (the reference falls back to XLA where its VMEM bands do not fit).
  Backward, as the reference's ``_conv2d_bwd``: the activation's mask on
  the saved output, then library convolutions for d(x) and d(w);
* ``conv2d_padded``: the same, returning a view of a buffer whose pixel
  pitch is Cout rounded up to 8 channels (pad channels zero), the form
  in which the fused chain hands a hidden layer to the next;
* ``kernel_plan``, ``pack_weights`` / ``unpack_weights``: how K6 tiles a
  layer and the order in which it streams the weights.  The wrapper packs
  a weight once per parameter value (a small cache), and gives K6 its
  input as it is where each pixel starts on 16 bytes, else one copy at a
  pitch of Cin rounded up to 8.

The kernel computes bfloat16 (``csrc/conv5.cu``, on ``wgmma``) or float32
(``csrc/conv5_tf32.cu``: the same implicit GEMM on ``wgmma`` in split TF32,
each f32 product as lo . hi + hi . lo + hi . hi of its tf32 halves;
``conv_tc_plan`` its tiling, ``pack_weights_tf32`` its weight order,
``_conv_tc_walk`` its arithmetic on the CPU), raises ``TypeError`` for
another dtype and ``ValueError`` for a shape it does not take.  The first
f32 body (``csrc/conv5_f32.cu``: a direct SIMT convolution, full f32 fused
multiply-adds; ``conv_f32_plan``, ``pack_weights_f32``, ``_conv_f32_walk``)
stays as the card tests' reference: ``_conv_kernel(..., body="simt")``
runs it, and no entry point does.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from wcmc_tpu_torch.ops import _build
from wcmc_tpu_torch.ops._pack import PackCache
from wcmc_tpu_torch.ops._tf32 import mm_tf32x3, split_tf32
from wcmc_tpu_torch.ops.mlp_fused import _act

# activation codes of the kernel (mlp_act of csrc/mlp.cuh)
ACT_CODES = {None: 0, "linear": 0, "relu": 1, "leaky_relu": 2}
MAX_BATCH = 65535    # the kernel's grid takes the batch as its z extent
# csrc/conv5.cu's tiling: output columns per block, weight-ring buffers,
# most input channels staged at once, and the shared memory a block may
# opt into on an H100 (227 KB); the C entry point checks the device's own
TILE_W, STAGES, MAX_CHUNK = 16, 3, 128
SMEM_LIMIT = 232448
PACK_CACHE_SIZE = 64  # packed weight tensors kept (the fused KPCN has 18)
# wcmc_conv5's C arguments: x, packed weights, bias, y; b, h, w, cin; x's
# strides; cout, ypitch, k, n, cin_pad, chunk, act, device; the stream
_ARGTYPES = ((_build.PTR,) * 4 + (_build.INT,) * 4 + (_build.LONG,) * 3 + (_build.INT,) * 8
             + (_build.PTR,))


class Plan(NamedTuple):
    """How K6 runs one layer: ``n`` output channels per pass (104 or
    224), ``rows`` output rows per block (4 per warpgroup), ``npass``
    passes, ``cin_pad`` packed weight rows per tap (whole chunks) and
    ``chunk`` input channels staged at once (16 to 128)."""
    n: int
    rows: int
    npass: int
    cin_pad: int
    chunk: int


def _round_up(v, m):
    return -(-v // m) * m


def _smem(ksize, chunk, n, rows, npass):
    """csrc/conv5.cu's conv_smem: the input tile at a pitch of chunk + 8,
    the weight ring, the bias of every pass, the ring's barriers and
    release counts, each rounded up to 128 bytes."""
    def r(v):
        return _round_up(v, 128)
    pix = (rows + ksize - 1) * (TILE_W + ksize - 1)
    return (r(2 * pix * (chunk + 8)) + STAGES * r(2 * chunk * n) + r(4 * npass * n)
            + r(8 * STAGES) + r(4 * STAGES))


@functools.lru_cache(maxsize=None)
def kernel_plan(cin: int, cout: int, ksize: int) -> Plan:
    """K6's plan for a layer: Cout <= 104 in one pass of 104 channels
    over 16-row blocks, wider Cout in passes of 224 over 8-row blocks
    (the accumulators of a pass take n / 2 registers a thread); Cin
    (rounded up to 16) in the fewest equal chunks whose tile and weight
    ring fit, the last padded with zero weights."""
    n, rows = (104, 16) if cout <= 104 else (224, 8)
    npass = -(-cout // n)
    need = _round_up(cin, 16)
    nchunks = 1
    while True:
        chunk = _round_up(-(-need // nchunks), 16)
        if chunk == 16 or (chunk <= MAX_CHUNK
                           and _smem(ksize, chunk, n, rows, npass) <= SMEM_LIMIT):
            return Plan(n, rows, npass, nchunks * chunk, chunk)
        nchunks += 1


def pack_weights(w, n: int, cin_pad: int, dtype=torch.bfloat16):
    """``w (K, K, Cin, Cout)`` in the order K6 streams it: ``(npass, K *
    K, cin_pad / 16, n / 8, 2, 8, 8)`` = [pass][tap][k16 step][n8 group]
    [k half][8 output channels][8 input channels], zero past Cin and
    Cout.  Each innermost 8 x 8 block is one K-major core matrix of 128
    bytes, and each (pass, tap) a contiguous run of k16 steps."""
    k, _, cin, cout = w.shape
    npass = -(-cout // n)
    wp = torch.zeros((k, k, cin_pad, npass * n), dtype=dtype, device=w.device)
    wp[:, :, :cin, :cout] = w
    wp = wp.view(k * k, cin_pad // 16, 2, 8, npass, n // 8, 8)   # tap, ks, kh, c, p, j, r
    return wp.permute(4, 0, 1, 5, 2, 6, 3).contiguous()


def unpack_weights(packed, ksize: int, cin: int, cout: int):
    """The inverse of :func:`pack_weights`: ``(K, K, Cin, Cout)``."""
    npass, _, ks, n8 = packed.shape[:4]
    w = packed.permute(1, 2, 4, 6, 0, 3, 5).reshape(ksize, ksize, ks * 16, npass * n8 * 8)
    return w[:, :, :cin, :cout]


_packed = PackCache(PACK_CACHE_SIZE)


def _packed_weights(w, n, cin_pad):
    """``pack_weights(w, n, cin_pad)``, made once per parameter value
    (:class:`~wcmc_tpu_torch.ops._pack.PackCache`)."""
    return _packed.get((w,), (n, cin_pad), lambda t: pack_weights(t, n, cin_pad))


def _check_args(x, w, bias, ksize, act):
    if act not in ACT_CODES:
        raise ValueError(f"conv2d computes the activations {tuple(ACT_CODES)}, got {act!r}")
    xs, ws = x.shape, w.shape
    if len(xs) != 4:
        raise ValueError(f"conv2d takes x (B, H, W, Cin), got {tuple(xs)}")
    if len(ws) != 4 or ws[:3] != (ksize, ksize, xs[3]) or bias.shape != ws[3:]:
        raise ValueError(f"conv2d: weight {tuple(ws)} / bias {tuple(bias.shape)} is not "
                         f"({ksize}, {ksize}, {xs[3]}, Cout) / (Cout,)")
    if xs[1] < ksize or xs[2] < ksize:
        raise ValueError(f"conv2d: input {tuple(xs)} is smaller than the {ksize}x{ksize} "
                         "window")


def conv2d_plain(x, w, bias, ksize: int, act=None):
    """Plain version of K6: the convolution of ``x``'s values with the
    weights rounded to ``x``'s dtype, summed in f32, plus the f32 bias,
    the activation, then one rounding to ``x``'s dtype; NHWC in and out."""
    _check_args(x, w, bias, ksize, act)
    _build.plain_calls["conv5"] += 1
    z = F.conv2d(x.float().permute(0, 3, 1, 2), w.to(x.dtype).float().permute(3, 2, 0, 1))
    z = z + bias.float()[:, None, None]
    return _act(act or "linear", z).to(x.dtype).permute(0, 2, 3, 1).contiguous()


def padded_pitch(cout: int) -> int:
    """The pixel pitch of the fused chain's hidden activations: Cout
    rounded up to 8 channels (104 for the KPCN's 100), so K6 copies the
    next layer's input tile 16 bytes at a time."""
    return _round_up(cout, 8)


def _pitched(x, pitch, fill=None):
    """``x (B, H, W, C)`` copied once into a ``(B, H, W, pitch)`` buffer,
    returned as the view of its first C channels; the pad channels are
    ``fill`` or, without it, left as they are (K6 never reads them)."""
    c = x.shape[-1]
    make = torch.empty if fill is None else functools.partial(torch.full, fill_value=fill)
    buf = make((*x.shape[:3], pitch), dtype=x.dtype, device=x.device)
    buf[..., :c] = x
    return buf[..., :c]


def _copyable(x):
    """Whether K6 copies ``x``'s pixels 16 bytes at a time as it is:
    channels contiguous, every other stride a multiple of 8 channels and
    the data 16-byte aligned."""
    sb, sh, sw, sc = x.stride()
    return sc == 1 and not (sb % 8 or sh % 8 or sw % 8) and x.data_ptr() % 16 == 0


def _require_cuda(x, w, bias):
    """The one CUDA device of the inputs; ValueError otherwise."""
    dev = x.device
    if dev.type != "cuda" or w.device != dev or bias.device != dev:
        raise ValueError("conv5: inputs must all be on one CUDA device, got "
                         f"{x.device}, {w.device}, {bias.device}")
    return dev


def _conv_kernel(x, w, bias, ksize, act, padded=False, body="tc"):
    """K6 on the card.  f32 input runs the tensor-core body (``body="tc"``)
    or, with ``body="simt"``, the first f32 body (the card tests' and
    ``chip_smoke.py``'s reference); bf16 input the ``wgmma`` body."""
    _check_args(x, w, bias, ksize, act)
    if body not in ("tc", "simt"):
        raise ValueError(f"conv5: no f32 body {body!r}; 'tc' or 'simt'")
    dev = _require_cuda(x, w, bias)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"conv5 kernel computes in bfloat16 or float32, got {x.dtype}")
    b, h, wd, cin = x.shape
    cout = w.shape[-1]
    if b > MAX_BATCH:
        raise ValueError(f"conv5 kernel takes at most {MAX_BATCH} images, got {b}")
    pitch = padded_pitch(cout) if padded else cout
    y = torch.empty((b, h - ksize + 1, wd - ksize + 1, pitch), dtype=x.dtype, device=dev)
    if pitch != cout:
        y = y[..., :cout]
    if b == 0:
        return y
    if x.dtype == torch.float32 and body == "tc":
        plan = conv_tc_plan(cin, cout, ksize)
        wp = _packed.get((w,), ("tf32", plan.n, plan.chunk, plan.cin_pad),
                         lambda t: pack_weights_tf32(t, plan.n, plan.chunk, plan.cin_pad))
        fn = _build.kernel("wcmc_conv5_tf32", *_ARGTYPES)
        tiling = (plan.n, plan.cin_pad, plan.chunk)
    elif x.dtype == torch.float32:
        plan = conv_f32_plan(cin, cout, ksize)
        wp = _packed.get((w,), ("f32", plan.cin_pad),
                         lambda t: pack_weights_f32(t, plan.cin_pad))
        fn = _build.kernel("wcmc_conv5_f32", *_F32_ARGTYPES)
        tiling = (plan.cin_pad,)
    else:
        plan = kernel_plan(cin, cout, ksize)
        wp = _packed_weights(w, plan.n, plan.cin_pad)
        fn = _build.kernel("wcmc_conv5", *_ARGTYPES)
        tiling = (plan.n, plan.cin_pad, plan.chunk)
    bf = bias if bias.dtype == torch.float32 and bias.is_contiguous() else \
        bias.float().contiguous()
    stream = _build.stream_of(dev)
    if not _copyable(x):
        # one copy (Cin 39, 34 -> a pitch of 40), launched last before K6
        x = _pitched(x, padded_pitch(cin))
    sb, sh, sw, _ = x.stride()
    _build.check(fn(x.data_ptr(), wp.data_ptr(), bf.data_ptr(), y.data_ptr(), b, h, wd, cin,
                    sb, sh, sw, cout, pitch, ksize, *tiling, ACT_CODES[act], dev.index or 0,
                    stream), "conv5")
    _build.launches["conv5"] += 1
    return y


# ---------------------------------------------------------------------------
# K6's f32 body (csrc/conv5_f32.cu): plan, weight order, walk and wrapper
# ---------------------------------------------------------------------------

F32_ROWS, F32_COLS = 8, 16   # output rows and columns of a block
F32_CHUNK = 8                # input channels staged at once
F32_OUT = 64                 # output channels of a block
F32_BLOCKS = 3               # blocks an SM the f32 body is compiled for
# wcmc_conv5_f32's C arguments: x, packed weights, bias, y; b, h, w, cin;
# x's strides; cout, ypitch, k, cin_pad, act, device; the stream
_F32_ARGTYPES = ((_build.PTR,) * 4 + (_build.INT,) * 4 + (_build.LONG,) * 3 + (_build.INT,) * 6
                 + (_build.PTR,))


class ConvF32Plan(NamedTuple):
    """How K6's f32 body runs a layer: blocks of ``rows`` x ``cols`` output
    pixels x ``nc`` output channels, ``n_out`` such channel chunks; Cin in
    chunks of ``chunk`` (``cin_pad`` = whole chunks); ``smem`` the block's
    shared memory as (buffer, bytes) pairs in the order the kernel carves
    them (the input tile with its halo at a pitch of ``chunk`` + 1 floats,
    then every tap's weights of one chunk), each a multiple of 128 bytes,
    ``total`` their sum (what ``wcmc_conv5_f32_smem`` returns);
    ``per_sm`` blocks resident an SM."""
    rows: int
    cols: int
    chunk: int
    nc: int
    cin_pad: int
    n_out: int
    smem: tuple
    total: int
    per_sm: int

    def grid(self, b, ho, wo):
        """The launch's grid: (row and column tiles, channel chunks, images)."""
        return (-(-ho // self.rows) * -(-wo // self.cols), self.n_out, b)


@functools.lru_cache(maxsize=None)
def conv_f32_plan(cin: int, cout: int, ksize: int) -> ConvF32Plan:
    """K6's f32 body for a layer: 8 x 16 output pixels x 64 output channels
    a block, Cin in chunks of 8.  ValueError where the block's shared
    memory would pass what a block may use (K above 10)."""
    from wcmc_tpu_torch.ops.kernel_apply import SM_SMEM   # kernel_apply imports this module

    if cin < 1 or cout < 1 or ksize < 1:
        raise ValueError(f"conv5 f32 body: no layer {cin} -> {cout} at {ksize}x{ksize}")
    tile = (F32_ROWS + ksize - 1) * (F32_COLS + ksize - 1)
    smem = (("x", _round_up(4 * tile * (F32_CHUNK + 1), 128)),
            ("w", _round_up(4 * ksize * ksize * F32_CHUNK * F32_OUT, 128)))
    total = sum(m for _, m in smem)
    if total > SMEM_LIMIT:
        raise ValueError(f"conv5 f32 body needs {total} bytes of shared memory for a "
                         f"{ksize}x{ksize} window, over the {SMEM_LIMIT} a block may use")
    return ConvF32Plan(F32_ROWS, F32_COLS, F32_CHUNK, F32_OUT, _round_up(cin, F32_CHUNK),
                       -(-cout // F32_OUT), smem, total,
                       min(F32_BLOCKS, SM_SMEM // (total + 1024)))


def pack_weights_f32(w, cin_pad: int):
    """``w (K, K, Cin, Cout)`` in the order K6's f32 body stages it:
    ``(n_out, cin_pad / 8, K * K, 8, 64)`` = [channel chunk of 64][input
    chunk of 8][tap][input channel][output channel], f32, zero past Cin and
    Cout: one (channel chunk, input chunk) is one contiguous run."""
    k, _, cin, cout = w.shape
    n_out = -(-cout // F32_OUT)
    wp = torch.zeros((k, k, cin_pad, n_out * F32_OUT), dtype=torch.float32, device=w.device)
    wp[:, :, :cin, :cout] = w
    wp = wp.view(k * k, cin_pad // F32_CHUNK, F32_CHUNK, n_out, F32_OUT)
    return wp.permute(3, 1, 0, 2, 4).contiguous()


def _conv_f32_walk(x, w, bias, ksize, act=None):
    """A plain walk of K6's f32 body on the CPU: ``conv_f32_plan``'s grid,
    each block's output pixels and channels one fused multiply-add chain
    from zero in (input chunk, tap, channel) order over the packed weights,
    then the bias and the activation.  Returns what ``conv2d_plain``
    returns for f32 input."""
    from wcmc_tpu_torch.ops.mlp_fused import _fma

    _check_args(x, w, bias, ksize, act)
    b, h, wd, cin = x.shape
    cout = w.shape[-1]
    ho, wo = h - ksize + 1, wd - ksize + 1
    plan = conv_f32_plan(cin, cout, ksize)
    wp = pack_weights_f32(w.float(), plan.cin_pad)
    xf = torch.zeros((b, h, wd, plan.cin_pad))
    xf[..., :cin] = x.float()
    y = torch.empty((b, ho, wo, cout))
    n_tiles, n_out, _ = plan.grid(b, ho, wo)
    tiles_w = -(-wo // plan.cols)
    for img in range(b):
        for j in range(n_out):
            n0, n1 = j * plan.nc, min((j + 1) * plan.nc, cout)
            for t in range(n_tiles):
                y0, x0 = t // tiles_w * plan.rows, t % tiles_w * plan.cols
                y1, x1 = min(y0 + plan.rows, ho), min(x0 + plan.cols, wo)
                acc = torch.zeros((y1 - y0, x1 - x0, plan.nc))
                for ch in range(plan.cin_pad // plan.chunk):
                    for tap in range(ksize * ksize):
                        dy, dx = divmod(tap, ksize)
                        for c in range(plan.chunk):
                            xv = xf[img, y0 + dy:y1 + dy, x0 + dx:x1 + dx, ch * plan.chunk + c]
                            acc = _fma(xv[..., None], wp[j, ch, tap, c], acc)
                y[img, y0:y1, x0:x1, n0:n1] = _act(act or "linear",
                                                   acc[..., :n1 - n0] + bias.float()[n0:n1])
    return y


# ---------------------------------------------------------------------------
# K6's tensor-core f32 body (csrc/conv5_tf32.cu): plan, weight order, walk
# ---------------------------------------------------------------------------

# csrc/conv5_tf32.cu's weight ring, widest chunk and output rows a block (3 warpgroups)
TC_STAGES, TC_MAX_CHUNK, TC_ROWS = 4, 256, 12


class ConvTcPlan(NamedTuple):
    """How K6's tensor-core f32 body runs a layer: ``n`` output channels a
    pass (104 or 112), ``rows`` output rows a block (4 a warpgroup),
    ``npass`` passes, ``cin_pad`` packed weight rows a tap (whole chunks),
    ``chunk`` input channels staged at once (a multiple of 8, staged at a
    pitch of ``xpitch`` floats); ``smem`` the block's shared memory as
    (buffer, bytes) pairs in the kernel's carve order, each a multiple of
    128 bytes, ``total`` their sum (what ``wcmc_conv5_tf32_smem``
    returns)."""
    n: int
    rows: int
    npass: int
    cin_pad: int
    chunk: int
    xpitch: int
    smem: tuple
    total: int


def _tc_xpitch(chunk):
    """A staged pixel's floats: the chunk rounded up to 8 mod 16."""
    return chunk if chunk % 16 == 8 else chunk + 8


def _tc_smem(ksize, chunk, n, rows, npass):
    def r(v):
        return _round_up(v, 128)
    pix = (rows + ksize - 1) * (TILE_W + ksize - 1)
    return (("x", r(4 * pix * _tc_xpitch(chunk))), ("w", TC_STAGES * r(64 * n)),
            ("bias", r(4 * npass * n)), ("full", r(8 * TC_STAGES)),
            ("released", r(4 * TC_STAGES)), ("slabs", r(8 * TC_MAX_CHUNK // 8)))


@functools.lru_cache(maxsize=None)
def conv_tc_plan(cin: int, cout: int, ksize: int) -> ConvTcPlan:
    """K6's tensor-core f32 body for a layer: 12-row blocks (3 warpgroups,
    each thread holding a pass's running sums and a step's partials: 170
    registers a thread), Cout <= 104 in one pass of 104 channels, wider Cout
    in passes of 112 (441 in 4); Cin (rounded up to 8) in the fewest equal
    chunks of whole slabs of 8 whose input tile and weight ring fit (the
    KPCN's 40 and 104 in one).  ValueError where no chunk of 8 fits."""
    if cin < 1 or cout < 1 or ksize < 1:
        raise ValueError(f"conv5 tf32 body: no layer {cin} -> {cout} at {ksize}x{ksize}")
    n, rows = (104 if cout <= 104 else 112), TC_ROWS
    npass = -(-cout // n)
    need = _round_up(cin, 8)
    for nchunks in range(1, need // 8 + 1):
        chunk = _round_up(-(-need // nchunks), 8)
        smem = _tc_smem(ksize, chunk, n, rows, npass)
        total = sum(m for _, m in smem)
        if chunk <= TC_MAX_CHUNK and total <= SMEM_LIMIT:
            return ConvTcPlan(n, rows, npass, nchunks * chunk, chunk, _tc_xpitch(chunk), smem,
                              total)
    raise ValueError(f"conv5 tf32 body: a {ksize}x{ksize} window's input tile does not fit "
                     f"a block's {SMEM_LIMIT} bytes of shared memory")


def _k_order():
    """The input channel of each k of a k8 step, as the kernel's A fragment
    holds them: k t <- channel 2t, k t + 4 <- channel 2t + 1."""
    return [2 * k for k in range(4)] + [2 * k + 1 for k in range(4)]


def pack_weights_tf32(w, n: int, chunk: int, cin_pad: int):
    """``w (K, K, Cin, Cout)`` in the order K6's tensor-core body streams it,
    split into tf32 hi and lo: ``(npass, nchunks, chunk / 8, K * K, 2, n /
    8, 2, 8, 4)`` = [pass][chunk][k8 slab][tap][hi, lo][n8 group][k half]
    [8 output channels][4 k], f32 bit patterns with the low 13 bits zero,
    zero past Cin and Cout.  Within a k8 slab, k runs over the channels in
    ``_k_order()``; each innermost 8 x 4 block is one K-major core matrix
    of 128 bytes, and each step (pass, chunk, slab, tap) one contiguous
    block of 64 n bytes."""
    k, _, cin, cout = w.shape
    npass = -(-cout // n)
    wp = torch.zeros((k, k, cin_pad, npass * n), dtype=torch.float32, device=w.device)
    wp[:, :, :cin, :cout] = w
    nch = cin_pad // chunk
    # tap, chunk, slab, k (channel order), pass, n8, r
    wp = wp.view(k * k, nch, chunk // 8, 8, npass, n // 8, 8)
    wp = wp[:, :, :, _k_order()]
    hi, lo = split_tf32(wp)
    wp = torch.stack([hi, lo])                         # hl, tap, ch, sl, k, p, j, r
    wp = wp.view(2, k * k, nch, chunk // 8, 2, 4, npass, n // 8, 8)
    # -> p, ch, sl, tap, hl, j, kh, r, k4
    return wp.permute(6, 2, 3, 1, 0, 7, 4, 8, 5).contiguous()


def _conv_tc_walk(x, w, bias, ksize, act=None):
    """A plain walk of K6's tensor-core body on the CPU: each output the
    split-TF32 sum of its products from zero, step by step in the kernel's
    (chunk, slab of 8 channels, tap) order, each step's three tf32 products
    (lo . hi, hi . lo, hi . hi) over its 8 channels added in turn to the f32
    accumulator; then the bias and the activation.  Returns what
    ``conv2d_plain`` returns for f32 input."""
    _check_args(x, w, bias, ksize, act)
    b, h, wd, cin = x.shape
    cout = w.shape[-1]
    ho, wo = h - ksize + 1, wd - ksize + 1
    plan = conv_tc_plan(cin, cout, ksize)
    xf = torch.zeros((b, h, wd, plan.cin_pad))
    xf[..., :cin] = x.float()
    wf = torch.zeros((ksize, ksize, plan.cin_pad, cout))
    wf[:, :, :cin] = w.float()
    acc = torch.zeros((b, ho, wo, cout))
    for c0 in range(0, plan.cin_pad, 8):      # chunk by chunk, slab by slab
        for tap in range(ksize * ksize):
            dy, dx = divmod(tap, ksize)
            xs = xf[:, dy:dy + ho, dx:dx + wo, c0:c0 + 8]
            acc = mm_tf32x3(acc, xs, wf[dy, dx, c0:c0 + 8])
    return _act(act or "linear", acc + bias.float())


def _act_grad_mask(act, y, g):
    """The activation's gradient through the saved output ``y``, as the
    reference's ``_act_grad_mask`` takes it."""
    if act in (None, "linear"):
        return g
    if act == "relu":
        return torch.where(y > 0, g, torch.zeros((), dtype=g.dtype, device=g.device))
    return torch.where(y > 0, g, 0.01 * g)


def _forward(x, w, bias, ksize, act, padded):
    """K6 for CUDA tensors, the plain version for CPU tensors; with
    ``padded``, the result at the padded pitch."""
    if x.device.type != "cpu":
        return _conv_kernel(x, w, bias, ksize, act, padded)
    y = conv2d_plain(x, w, bias, ksize, act)
    return _pitched(y, padded_pitch(y.shape[-1]), fill=0) if padded else y


class _Conv2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, ksize, act, padded):
        y = _forward(x, w, bias, ksize, act, padded)
        ctx.act = act
        ctx.save_for_backward(x, w, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        dt = x.dtype
        dz = _act_grad_mask(ctx.act, y.float(), g.float()).to(dt)
        # library convolutions of the values in x's dtype, summed in f32
        z32 = dz.float().permute(0, 3, 1, 2)
        w32 = w.to(dt).float().permute(3, 2, 0, 1)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            x_shape = (x.shape[0], x.shape[3], x.shape[1], x.shape[2])
            dx = torch.nn.grad.conv2d_input(x_shape, w32, z32).to(dt).permute(0, 2, 3, 1)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(x.float().permute(0, 3, 1, 2), w32.shape, z32)
            dw = dw.to(dt).to(w.dtype).permute(2, 3, 1, 0)
        if ctx.needs_input_grad[2]:
            db = dz.float().sum(dim=(0, 1, 2)).to(w.dtype)
        return dx, dw, db, None, None, None


def conv2d(x, w, bias, ksize: int, act=None):
    """VALID ``ksize`` x ``ksize`` convolution + bias + activation over
    channels-last ``x (B, H, W, Cin)`` in the compute dtype; ``w (K, K,
    Cin, Cout)`` and ``bias (Cout,)`` f32 parameters.  Returns ``(B, H - K
    + 1, W - K + 1, Cout)`` in ``x``'s dtype.  K6 for CUDA tensors, the
    plain version for CPU tensors; differentiable in all three inputs."""
    return _apply(x, w, bias, ksize, act, False)


def conv2d_padded(x, w, bias, ksize: int, act=None):
    """:func:`conv2d` as the fused chain's hidden layers run it: the
    result is the ``(B, H - K + 1, W - K + 1, Cout)`` view of a buffer
    whose pixel pitch is :func:`padded_pitch` (Cout rounded up to 8), its
    pad channels zero, which the next layer's K6 copies as it is."""
    return _apply(x, w, bias, ksize, act, True)


def _apply(x, w, bias, ksize, act, padded):
    """The autograd Function where a gradient may be asked for, else its
    forward alone (inference, where the Function's bookkeeping on the
    host is most of a small launch's cost)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad or bias.requires_grad):
        return _Conv2d.apply(x, w, bias, ksize, act, padded)
    return _forward(x, w, bias, ksize, act, padded)
