"""Fused per-pixel MLP (a chain of 1x1 convolutions over rows), and the
row-wise MLP helpers the PathNet plain versions share.

Counterpart of ``wcmc_tpu/ops/mlp_fused.py``: the activation table, its
gradient through the post-activation value (``_act_grad``), the plain
chain (``_mlp_xla`` there, :func:`_mlp_plain` here), and ``fused_mlp``,
an autograd Function:

* forward: the CUDA kernel K10-fwd (``csrc/mlp_fused.cu``) for CUDA
  tensors, the plain version ``_mlp_fwd_plain`` for CPU tensors;
  :func:`mlp_fwd_plan` picks its body (the tiled one for LayerNet's chain,
  the wmma body for every other form) and states its shared memory and
  grid, and ``_mlp_fwd_walk`` is the tiled body's order on the CPU;
* backward: K10-bwd (``csrc/mlp_fused_bwd.cu``), plain version
  ``_mlp_bwd_plain``; :func:`mlp_bwd_plan` picks its body (the tiled one
  for LayerNet's chain, three layers 32 wide at C0 <= 32, the wmma body
  for every other form) and states its shared memory and grid, and
  ``_mlp_bwd_walk`` is the tiled body's order on the CPU.

The kernels compute in bfloat16 with f32 accumulation (the bodies above)
or in float32 (``csrc/mlp_f32.cu``: one SIMT body each way, every form the
bf16 bodies take, full f32 fused multiply-adds with nothing rounded
between layers; :func:`mlp_f32_plan` states its shared memory and grid,
``_mlp_f32_walk`` and ``_mlp_bwd_f32_walk`` are its order on the CPU; the
backward of LayerNet's chain runs on the tensor cores in split TF32
instead, ``csrc/mlp_bwd_tf32.cu``: :func:`mlp_bwd_tc_plan`,
``pack_mlp_tf32``, ``_mlp_bwd_tc_walk``), and
raise TypeError for other dtypes and ValueError for more than
``MLP_MAX_LAYERS`` layers or widths over ``MLP_MAX_WIDTH``.  The plain
versions round where the reference's Pallas kernels round: forward, after
every layer; backward, the hiddens are recomputed in the compute dtype,
the output cotangent is rounded to it, each layer's cotangent is rounded
to it before its products, dW and db (from the unrounded cotangent) stay
f32, and d(x) is rounded once (at f32 nothing rounds).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from wcmc_tpu_torch.ops import _build
from wcmc_tpu_torch.ops._pack import PackCache
from wcmc_tpu_torch.ops._tf32 import mm_k8, pack_b_tf32

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


def _into(acc, a, w):
    """``acc + a @ w``, summed k16 step by k16 step (of ``a``'s columns) as
    the kernels' products add into their accumulators."""
    for k in range(0, a.shape[1], 16):
        acc = acc + a[:, k:k + 16] @ w[k:k + 16]
    return acc


def _prod(a, w):
    """``a @ w`` in k16 steps (:func:`_into` from zero)."""
    return _into(torch.zeros((a.shape[0], w.shape[1])), a, w)


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


def _check_form(name, c0, widths, acts):
    """What K10 computes: 1 to MLP_MAX_LAYERS layers of the three
    activations, C0 from 1 to MLP_MAX_WIDTH and every layer width a multiple
    of 16 up to MLP_MAX_WIDTH.  Returns the activation codes."""
    if not 1 <= len(widths) <= MLP_MAX_LAYERS:
        raise ValueError(f"{name} kernel takes 1 to {MLP_MAX_LAYERS} layers, got {len(widths)}")
    if len(acts) != len(widths) or any(a not in ACTS for a in acts):
        raise ValueError(f"{name} kernel computes the activations {ACTS}, got {tuple(acts)}")
    if not 1 <= c0 <= MLP_MAX_WIDTH:
        raise ValueError(f"{name} kernel takes 1 to {MLP_MAX_WIDTH} input channels, got {c0}")
    for co in widths:
        if co % 16 or not 16 <= co <= MLP_MAX_WIDTH:
            raise ValueError(f"{name} kernel takes layer widths that are multiples of 16 "
                             f"up to {MLP_MAX_WIDTH}, got {co}")
    return [ACTS.index(a) for a in acts]


def _require_cuda(name, *tensors):
    """The one CUDA device of ``tensors``; ValueError otherwise."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: inputs must all be on one CUDA device, got "
                         + ", ".join(str(t.device) for t in tensors))
    return dev


def _check_card(name, x, ws, bs, acts):
    """What K10 computes (:func:`_check_form`), as bf16 or f32 rows on one
    CUDA device.  Returns the widths and the activation codes."""
    _require_cuda(name, x, *ws, *bs)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name} kernel computes in bfloat16 or float32, got {x.dtype}")
    dims = [x.shape[-1]] + [w.shape[1] for w in ws]
    codes = _check_form(name, dims[0], dims[1:], acts)
    for w, b, ci, co in zip(ws, bs, dims[:-1], dims[1:]):
        if tuple(w.shape) != (ci, co) or tuple(b.shape) != (co,):
            raise ValueError(f"{name}: weight {tuple(w.shape)} / bias {tuple(b.shape)} "
                             f"is not ({ci}, {co}) / ({co},)")
    return dims, codes


# ---------------------------------------------------------------------------
# K10's plans (csrc/mlp_fused.cu, csrc/mlp_fused_bwd.cu), kept here so the CPU
# tests reach them
# ---------------------------------------------------------------------------

MLP_BWD_TILED = (32, 32, 32)   # the tiled body's layer widths; C0 up to 32, padded to 32
MLP_BWD_SLAB = 64              # rows of a slab, walked by one warp of the tiled body
MLP_BWD_WARPS = 8              # warps of a tiled block, each walking its own slabs
MLP_BWD_STAGES = 3             # slabs in flight a warp
MLP_BWD_TILE = 128             # rows of the wmma body's tile
MLP_FWD_STAGES = 4             # slabs in a warp's ring of K10-fwd's tiled body


def _r128(n):
    """``n`` bytes rounded up to the 128-byte pieces the kernels carve."""
    return -(-n // 128) * 128


class MlpBwdPlan(NamedTuple):
    """How K10-bwd runs a form: on the tiled body (``body`` "tiled") or the
    wmma one ("wmma"), C0 padded to ``k0``; a block's ``walkers`` each take
    ``rows`` rows at a time (the tiled body's warps their own slabs, with
    ``stages`` slabs in flight; the wmma body's block its tiles) and keep
    ``parts`` f32 partial sums of dW and db; ``smem`` the block's shared
    memory as (buffer, bytes) pairs in the order the kernel carves them,
    each a multiple of 128 bytes, ``total`` their sum (what
    ``wcmc_mlp_fused_bwd_smem`` returns)."""
    body: str
    k0: int
    rows: int
    walkers: int
    stages: int
    parts: int
    smem: tuple
    total: int

    def grid(self, n, sms):
        """The blocks of a launch over ``n`` rows on a card of ``sms`` SMs:
        persistent, at most one a SM (tiled; its shared memory allows no
        second) or four (wmma; the kernel launches as many of those as are
        resident), and no more than the rows need, at least one."""
        cap = sms if self.body == "tiled" else 4 * sms
        need = -(-n // (self.rows * self.walkers))
        return max(1, min(cap, need))


@functools.lru_cache(maxsize=None)
def mlp_bwd_plan(c0, widths, acts) -> MlpBwdPlan:
    """K10-bwd's plan for the chain C0 -> ``widths`` with activations
    ``acts``.  The tiled body takes three layers of ``MLP_BWD_TILED`` at C0
    up to 32 (any activations, d(x) on or off): the three weight tiles and
    the biases, then each warp's ring of x and g tiles (64 x 32 bf16 a
    tile, two a stage).  Every other form runs the wmma body: each layer's
    padded weight rows, bias, f32 dW and db partials, a 128-row tile per
    hidden (x included), the bias-sum slots and the warps' staging.
    ValueError for what neither body computes."""
    from wcmc_tpu_torch.ops.conv5 import SMEM_LIMIT   # conv5 imports this module

    widths, acts = tuple(widths), tuple(acts)
    _check_form("mlp_fused_bwd", c0, widths, acts)
    if widths == MLP_BWD_TILED and c0 <= MLP_BWD_TILED[0]:
        w = MLP_BWD_TILED[0]
        tile = 2 * MLP_BWD_SLAB * w
        smem = (("weights", 3 * 2 * w * w), ("bias", _r128(3 * 4 * w)),
                ("rings", MLP_BWD_WARPS * MLP_BWD_STAGES * 2 * tile))
        return MlpBwdPlan("tiled", w, MLP_BWD_SLAB, MLP_BWD_WARPS, MLP_BWD_STAGES,
                          3 * w * w + 3 * w, smem, sum(m for _, m in smem))
    dims = [-(-c0 // 16) * 16, *widths]
    smem = []
    for i, (ci, co) in enumerate(zip(dims[:-1], dims[1:])):
        smem += [(f"w{i}", 2 * ci * (co + 8)), (f"b{i}", 4 * co), (f"dw{i}", 4 * ci * co),
                 (f"db{i}", 4 * co)]
    smem += [(f"h{i}", 2 * MLP_BWD_TILE * (c + 8)) for i, c in enumerate(dims)]
    smem += [("dbpart", 4 * max(MLP_BWD_TILE // 16 * max(dims), 256)), ("stage", 4 * 8 * 256)]
    smem = tuple((name, _r128(m)) for name, m in smem)
    total = sum(m for _, m in smem)
    if total > SMEM_LIMIT:
        raise ValueError(f"mlp_fused_bwd kernel needs {total} bytes of shared memory for "
                         f"{c0} -> {widths}, over the {SMEM_LIMIT} a block may use")
    parts = sum(ci * co + co for ci, co in zip(dims[:-1], dims[1:]))
    return MlpBwdPlan("wmma", dims[0], MLP_BWD_TILE, 1, 1, parts, smem, total)


class MlpFwdPlan(NamedTuple):
    """How K10-fwd runs a form: on the tiled body (``body`` "tiled") or the
    wmma one ("wmma"), C0 padded to ``k0``; a block's ``walkers`` each take
    ``rows`` rows at a time (the tiled body's warps their own slabs, with
    ``stages`` slabs in a ring; the wmma body's block its tiles); ``smem``
    the block's shared memory as (buffer, bytes) pairs in the order the
    kernel carves them, each a multiple of 128 bytes, ``total`` their sum
    (what ``wcmc_mlp_fused_smem`` returns)."""
    body: str
    k0: int
    rows: int
    walkers: int
    stages: int
    smem: tuple
    total: int

    def grid(self, n, sms):
        """The blocks of a launch over ``n`` rows on a card of ``sms`` SMs:
        persistent, at most one a SM (tiled; its shared memory allows no
        second) or four (wmma; the kernel launches as many of those as are
        resident), and no more than the rows need, at least one."""
        cap = sms if self.body == "tiled" else 4 * sms
        return max(1, min(cap, -(-n // (self.rows * self.walkers))))


@functools.lru_cache(maxsize=None)
def mlp_fwd_plan(c0, widths, acts) -> MlpFwdPlan:
    """K10-fwd's plan for the chain C0 -> ``widths`` with activations
    ``acts``.  The tiled body takes the forms K10-bwd's does (three layers of
    ``MLP_BWD_TILED`` at C0 up to 32, any activations): the three weight
    tiles, then each warp's ring of ``MLP_FWD_STAGES`` x tiles (64 x 32 bf16
    a tile; a slab's output overwrites its x rows).  Every other form runs the
    wmma body: each layer's padded weight rows and bias, the 128-row x tile,
    two hidden tiles and the warps' staging.  ValueError for what neither
    body computes."""
    from wcmc_tpu_torch.ops.conv5 import SMEM_LIMIT   # conv5 imports this module

    widths, acts = tuple(widths), tuple(acts)
    _check_form("mlp_fused", c0, widths, acts)
    if widths == MLP_BWD_TILED and c0 <= MLP_BWD_TILED[0]:
        w = MLP_BWD_TILED[0]
        smem = (("weights", 3 * 2 * w * w),
                ("rings", MLP_BWD_WARPS * MLP_FWD_STAGES * 2 * MLP_BWD_SLAB * w))
        return MlpFwdPlan("tiled", w, MLP_BWD_SLAB, MLP_BWD_WARPS, MLP_FWD_STAGES, smem,
                          sum(m for _, m in smem))
    dims = [-(-c0 // 16) * 16, *widths]
    smem = []
    for i, (ci, co) in enumerate(zip(dims[:-1], dims[1:])):
        smem += [(f"w{i}", 2 * ci * (co + 8)), (f"b{i}", 4 * co)]
    smem += [("x", 2 * MLP_BWD_TILE * (dims[0] + 8))]
    smem += [(f"h{i}", 2 * MLP_BWD_TILE * (max(dims) + 8)) for i in range(2)]
    smem += [("stage", 4 * 8 * 256)]
    smem = tuple((name, _r128(m)) for name, m in smem)
    total = sum(m for _, m in smem)
    if total > SMEM_LIMIT:
        raise ValueError(f"mlp_fused kernel needs {total} bytes of shared memory for "
                         f"{c0} -> {widths}, over the {SMEM_LIMIT} a block may use")
    return MlpFwdPlan("wmma", dims[0], MLP_BWD_TILE, 1, 1, smem, total)


def _mlp_fwd_walk(x, ws, bs, acts, n_blocks=3):
    """A plain walk of K10-fwd's tiled order on the CPU, for a card of
    ``n_blocks`` SMs: ``mlp_fwd_plan``'s grid, each block's warps walking
    slabs of 64 rows in turn (warp v of the launch takes slabs v, v +
    walkers, ...), each slab in sub-tiles of 16 rows, each layer summed k16
    step by k16 step from zero, then its bias, its activation and the
    rounding to ``x``'s dtype.  Returns what ``_mlp_fwd_plain`` returns."""
    dt = x.dtype
    n, c0 = x.shape
    plan = mlp_fwd_plan(c0, tuple(w.shape[1] for w in ws), tuple(acts))
    if plan.body != "tiled":
        raise ValueError(f"mlp_fused: {c0} -> {plan} does not run the tiled body")
    wt = [w.to(dt).float() for w in ws]
    bias = [b.float() for b in bs]
    out = torch.empty((n, ws[-1].shape[1]), dtype=dt)
    walkers = plan.grid(n, n_blocks) * plan.walkers
    for v in range(walkers):
        for j in range(v, -(-n // plan.rows), walkers):
            for r0 in range(j * plan.rows, min((j + 1) * plan.rows, n), 16):
                h = x[r0:r0 + 16].float()
                for w, b, a in zip(wt, bias, acts):
                    h = _act(a, _prod(h, w) + b).to(dt).float()
                out[r0:r0 + 16] = h.to(dt)
    return out


def _mlp_bwd_walk(x, g, ws, bs, acts, compute_dx=True, n_blocks=3):
    """A plain walk of K10-bwd's tiled order on the CPU, for a card of
    ``n_blocks`` SMs: ``mlp_bwd_plan``'s grid, each block's warps walking
    slabs of 64 rows in turn (warp v of the launch takes slabs v, v +
    walkers, ...), each slab in sub-tiles of 16 rows: the hiddens
    recomputed (each layer summed k16 step by k16 step from zero, then its
    bias, its activation and the rounding), the cotangent chain, dW_i +=
    h_i^T . bf16(gz_i) per sub-tile into the warp's partial and db_i from
    the unrounded gz row by row; a block's partial is its warps' summed in
    warp order, and the blocks' are summed in block order.  Returns what
    ``_mlp_bwd_plain`` returns."""
    dt = x.dtype
    n, c0 = x.shape
    plan = mlp_bwd_plan(c0, tuple(w.shape[1] for w in ws), tuple(acts))
    if plan.body != "tiled":
        raise ValueError(f"mlp_fused_bwd: {c0} -> {plan} does not run the tiled body")
    wt = [w.to(dt).float() for w in ws]
    bias = [b.float() for b in bs]
    gb = g.to(dt).float()
    dx = torch.empty((n, c0), dtype=dt) if compute_dx else None
    grid = plan.grid(n, n_blocks)
    walkers = grid * plan.walkers
    n_slabs = -(-n // plan.rows)
    total = None
    for blk in range(grid):
        block = None
        for warp in range(plan.walkers):
            dws = [torch.zeros(w.shape) for w in ws]
            dbs = [torch.zeros(w.shape[1]) for w in ws]
            for j in range(blk * plan.walkers + warp, n_slabs, walkers):
                for r0 in range(j * plan.rows, min((j + 1) * plan.rows, n), 16):
                    r1 = min(r0 + 16, n)
                    hs = [x[r0:r1].float()]
                    for w, b, a in zip(wt, bias, acts):
                        hs.append(_act(a, _prod(hs[-1], w) + b).to(dt).float())
                    v = gb[r0:r1]
                    for i in reversed(range(len(ws))):
                        gz = _act_grad(acts[i], hs[i + 1], v)
                        for row in gz:
                            dbs[i] = dbs[i] + row
                        gzb = gz.to(dt).float()
                        dws[i] = dws[i] + hs[i].t() @ gzb
                        if i > 0 or compute_dx:
                            v = _prod(gzb, wt[i].t())
                    if compute_dx:
                        dx[r0:r1] = v.to(dt)
            part = dws + dbs
            block = part if block is None else [a + p for a, p in zip(block, part)]
        total = block if total is None else [a + p for a, p in zip(total, block)]
    return dx, total[:len(ws)], total[len(ws):]


# ---------------------------------------------------------------------------
# K10's f32 bodies (csrc/mlp_f32.cu): plan, walks and wrappers
# ---------------------------------------------------------------------------

MLP_F32_ROWS = 32      # rows of a tile of the f32 bodies: a product's rows
MLP_F32_BLOCKS = 4     # blocks an SM the f32 bodies are compiled for


class MlpF32Plan(NamedTuple):
    """How K10's f32 body runs a form: tiles of ``rows`` rows walked by
    persistent blocks, at most ``per_sm`` resident an SM; ``smem`` the
    block's shared memory as (buffer, bytes) pairs in the order the kernel
    carves them, each a multiple of 128 bytes, ``total`` their sum (what
    ``wcmc_mlp_f32_smem`` returns).  The backward keeps one f32 partial of
    dW_0 | ... | dW_{L-1} | db_0 | ... | db_{L-1} a block, ``parts`` floats."""
    rows: int
    per_sm: int
    smem: tuple
    total: int
    parts: int

    def grid(self, n, sms):
        """The blocks of a launch over ``n`` rows on a card of ``sms`` SMs:
        ``per_sm`` a SM, no more than the tiles, at least one."""
        return max(1, min(self.per_sm * sms, -(-n // self.rows)))


@functools.lru_cache(maxsize=None)
def mlp_f32_plan(c0, widths, acts, bwd=False) -> MlpF32Plan:
    """K10's f32 body (forward, or with ``bwd`` the backward) for the chain
    C0 -> ``widths`` with activations ``acts``, every form
    :func:`_check_form` admits.  Forward: the weights and biases (staged
    once a launch), the x tile and two hidden tiles (one for two layers,
    none for one), each as wide as the widest hidden layer; backward: the
    weights, the biases, their transposes, the x tile, a tile for each
    hidden layer and the cotangent's; 32 f32 rows a tile.  ValueError for
    what K10 does not compute."""
    from wcmc_tpu_torch.ops.conv5 import SMEM_LIMIT   # conv5 imports this module
    from wcmc_tpu_torch.ops.kernel_apply import SM_SMEM

    widths, acts = tuple(widths), tuple(acts)
    _check_form("mlp_fused_bwd" if bwd else "mlp_fused", c0, widths, acts)
    dims, rows = (c0, *widths), MLP_F32_ROWS
    weights = sum(ci * co for ci, co in zip(dims[:-1], dims[1:]))
    smem = [("weights", 4 * weights), ("bias", 4 * sum(widths))]
    if bwd:
        smem += [("transposes", 4 * weights), ("x", 4 * rows * c0)]
        smem += [(f"h{i}", 4 * rows * dims[i]) for i in range(1, len(widths))]
        smem += [("g", 4 * rows * dims[-1])]
    else:
        hidden = max(dims[1:-1], default=0)
        smem += [("x", 4 * rows * c0)]
        smem += [(f"h{i}", 4 * rows * hidden) for i in range(min(len(widths) - 1, 2))]
    smem = tuple((name, _r128(m)) for name, m in smem)
    total = sum(m for _, m in smem)
    if total > SMEM_LIMIT:
        raise ValueError(f"mlp_fused f32 body needs {total} bytes of shared memory for "
                         f"{c0} -> {widths}, over the {SMEM_LIMIT} a block may use")
    return MlpF32Plan(rows, min(MLP_F32_BLOCKS, SM_SMEM // (total + 1024)), smem, total,
                      weights + sum(widths))


def _fma(a, b, c):
    """``a * b + c`` rounded once to f32, as a fused multiply-add rounds it
    (the product is exact in f64; the sum rounds to f64, then to f32, which
    a rare halfway case can round apart from the fused one)."""
    return (a.double() * b.double() + c.double()).float()


def _chain(a, w):
    """``a @ w`` as the f32 bodies' products sum it: per output one fused
    multiply-add chain over k in order, from zero."""
    acc = torch.zeros((a.shape[0], w.shape[1]))
    for k in range(w.shape[0]):
        acc = _fma(a[:, k:k + 1], w[k], acc)
    return acc


def _f32_tiles(n, grid, rows):
    """Each block's tiles in its walk, block by block, as row ranges."""
    tiles = -(-n // rows)
    return [[(t * rows, min((t + 1) * rows, n)) for t in range(blk, tiles, grid)]
            for blk in range(grid)]


def _mlp_f32_walk(x, ws, bs, acts, n_blocks=3):
    """A plain walk of K10-fwd's f32 body on the CPU, for a card of
    ``n_blocks`` SMs: ``mlp_f32_plan``'s grid, each block's 32-row tiles in
    turn, each layer a fused multiply-add chain over k from zero, then its
    bias and activation, nothing rounded.  Returns what ``_mlp_fwd_plain``
    returns for f32 rows."""
    n, c0 = x.shape
    plan = mlp_f32_plan(c0, tuple(w.shape[1] for w in ws), tuple(acts))
    out = torch.empty((n, ws[-1].shape[1]))
    for tiles in _f32_tiles(n, plan.grid(n, n_blocks), plan.rows):
        for r0, r1 in tiles:
            h = x[r0:r1].float()
            for w, b, a in zip(ws, bs, acts):
                h = _act(a, _chain(h, w.float()) + b.float())
            out[r0:r1] = h
    return out


def _mlp_bwd_f32_walk(x, g, ws, bs, acts, compute_dx=True, n_blocks=3):
    """A plain walk of K10-bwd's f32 body on the CPU, for a card of
    ``n_blocks`` SMs: each block's tiles in turn, the hiddens recomputed as
    the forward walk computes them, gz through each post-activation value;
    db_i += the tile's column sums (rows added in order from zero) and each
    dW_i element a fused multiply-add chain over the tile's rows from the
    block's partial; d(x) a chain over k from zero; then the blocks'
    partials summed in block order.  Returns what ``_mlp_bwd_plain``
    returns for f32 rows."""
    n, c0 = x.shape
    plan = mlp_f32_plan(c0, tuple(w.shape[1] for w in ws), tuple(acts), bwd=True)
    wf, bf = [w.float() for w in ws], [b.float() for b in bs]
    dx = torch.empty((n, c0)) if compute_dx else None
    total = None
    for tiles in _f32_tiles(n, plan.grid(n, n_blocks), plan.rows):
        part = [torch.zeros(w.shape) for w in ws] + [torch.zeros(w.shape[1]) for w in ws]
        for r0, r1 in tiles:
            hs = [x[r0:r1].float()]
            for w, b, a in zip(wf[:-1], bf[:-1], acts[:-1]):
                hs.append(_act(a, _chain(hs[-1], w) + b))
            cur = g[r0:r1].float()
            if acts[-1] != "linear":
                cur = _act_grad(acts[-1], _act(acts[-1], _chain(hs[-1], wf[-1]) + bf[-1]), cur)
            for i in reversed(range(len(ws))):
                s = torch.zeros(cur.shape[1])
                for row in cur:
                    s = s + row
                part[len(ws) + i] = part[len(ws) + i] + s
                for r in range(cur.shape[0]):
                    part[i] = _fma(hs[i][r][:, None], cur[r][None, :], part[i])
                if i > 0:
                    cur = _act_grad(acts[i - 1], hs[i], _chain(cur, wf[i].t()))
                elif compute_dx:
                    dx[r0:r1] = _chain(cur, wf[0].t())
        total = part if total is None else [t + p for t, p in zip(total, part)]
    return dx, total[:len(ws)], total[len(ws):]


def _f32_layer_args(ws, bs, dims, codes):
    """f32 weights and biases, and the f32 kernels' layer arguments: the 4
    weight and 4 bias pointers (null beyond the last layer), the widths and
    the codes."""
    wf = [w.float().contiguous() for w in ws]
    bf = [b.float().contiguous() for b in bs]
    pad = MLP_MAX_LAYERS - len(ws)
    ptrs = [w.data_ptr() for w in wf] + [None] * pad + [b.data_ptr() for b in bf] + [None] * pad
    return wf, bf, ptrs, list(dims[1:]) + [0] * pad, list(codes) + [0] * pad


def _mlp_fwd_f32_kernel(x, ws, bs, acts, dims, codes):
    """K10-fwd's f32 body (``mlp_f32_plan``) on f32 rows."""
    plan = mlp_f32_plan(dims[0], tuple(dims[1:]), tuple(acts))
    dev = x.device
    x = x.contiguous()
    n = x.shape[0]
    out = torch.empty((n, dims[-1]), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    wf, bf, ptrs, widths, codes = _f32_layer_args(ws, bs, dims, codes)
    P, INT, L = _build.PTR, _build.INT, MLP_MAX_LAYERS
    idx = dev.index or 0
    fn = _build.kernel("wcmc_mlp_fused_f32", P, *([P] * (2 * L)), P, _build.LONG, INT, INT,
                       *([INT] * (2 * L)), INT, INT, P)
    _build.check(fn(x.data_ptr(), *ptrs, out.data_ptr(), n, dims[0], len(wf), *widths, *codes,
                    plan.grid(n, _build.sm_count(idx)), idx, _build.stream_of(dev)),
                 "mlp_fused")
    _build.launches["mlp_fused"] += 1
    return out


def _mlp_bwd_f32_kernel(x, g, ws, bs, acts, dims, codes, compute_dx):
    """K10-bwd's f32 body (``mlp_f32_plan(..., bwd=True)``) on f32 rows, the
    cotangent read as f32: ``(dx f32 or None, dWs, dbs)``."""
    plan = mlp_f32_plan(dims[0], tuple(dims[1:]), tuple(acts), bwd=True)
    dev = x.device
    x, g = x.contiguous(), g.float().contiguous()
    n = x.shape[0]
    dx = torch.empty((n, dims[0]), dtype=torch.float32, device=dev) if compute_dx else None
    sizes = [ci * co for ci, co in zip(dims[:-1], dims[1:])] + list(dims[1:])
    if n == 0:
        out = torch.zeros(plan.parts, dtype=torch.float32, device=dev)
    else:
        wf, bf, ptrs, widths, codes = _f32_layer_args(ws, bs, dims, codes)
        idx = dev.index or 0
        n_blocks = plan.grid(n, _build.sm_count(idx))
        parts = torch.empty(n_blocks * plan.parts, dtype=torch.float32, device=dev)
        out = torch.empty(plan.parts, dtype=torch.float32, device=dev)
        P, INT, L = _build.PTR, _build.INT, MLP_MAX_LAYERS
        fn = _build.kernel("wcmc_mlp_fused_bwd_f32", P, P, *([P] * (2 * L)), P, P, P,
                           _build.LONG, INT, INT, *([INT] * (2 * L)), INT, INT, P)
        _build.check(fn(x.data_ptr(), g.data_ptr(), *ptrs,
                        dx.data_ptr() if compute_dx else None, parts.data_ptr(),
                        out.data_ptr(), n, dims[0], len(wf), *widths, *codes, n_blocks, idx,
                        _build.stream_of(dev)), "mlp_fused_bwd")
        _build.launches["mlp_fused_bwd"] += 1
    chunks = torch.split(out, sizes)
    nl = len(ws)
    dws = [c.view(ci, co) for c, ci, co in zip(chunks[:nl], dims[:-1], dims[1:])]
    return dx, dws, list(chunks[nl:])


# ---------------------------------------------------------------------------
# K10-bwd's tensor-core f32 body (csrc/mlp_bwd_tf32.cu): plan, weight pack,
# walk and wrapper
# ---------------------------------------------------------------------------

MLP_TC_ROWS = 16       # rows of a slab of the tensor-core f32 body: one m16 tile
MLP_TC_STAGES = 3      # slabs in flight a warp
MLP_TC_PITCH = 40      # floats a row of its tiles: 8 past a multiple of 32


class MlpBwdTcPlan(NamedTuple):
    """How K10-bwd's tensor-core f32 body runs LayerNet's chain: C0 padded
    to ``k0``; each of a block's ``walkers`` warps takes ``rows`` rows at a
    time, its own slabs, with ``stages`` slabs in flight, and keeps ``parts``
    f32 partial sums of dW and db; ``smem`` the block's shared memory as
    (buffer, bytes) pairs in the order the kernel carves them, each a
    multiple of 128 bytes, ``total`` their sum (what
    ``wcmc_mlp_fused_bwd_tf32_smem`` returns)."""
    k0: int
    rows: int
    walkers: int
    stages: int
    parts: int
    smem: tuple
    total: int

    def grid(self, n, sms):
        """The blocks of a launch over ``n`` rows on a card of ``sms`` SMs:
        persistent, one a SM (its shared memory allows no second), and no
        more than the rows need, at least one."""
        return max(1, min(sms, -(-n // (self.rows * self.walkers))))


def mlp_tc_form(c0, widths):
    """Whether K10-bwd's tensor-core f32 body holds the chain: LayerNet's,
    three layers of ``MLP_BWD_TILED`` at C0 up to 32."""
    return tuple(widths) == MLP_BWD_TILED and 1 <= c0 <= MLP_BWD_TILED[0]


@functools.lru_cache(maxsize=None)
def mlp_bwd_tc_plan(c0, widths, acts) -> MlpBwdTcPlan:
    """K10-bwd's tensor-core f32 body for the chain C0 -> ``widths`` with
    activations ``acts`` (any of ``ACTS``, d(x) on or off): the six packed
    weight matrices (W0, W1, W2 and their transposes, split TF32) and the
    biases, then each of the 8 warps' ring of ``MLP_TC_STAGES`` slabs (an x
    and a g tile of 16 rows a stage) and its h1 and h2 tiles, f32 at a pitch
    of 40 floats.  ValueError for another chain."""
    widths, acts = tuple(widths), tuple(acts)
    _check_form("mlp_fused_bwd", c0, widths, acts)
    if not mlp_tc_form(c0, widths):
        raise ValueError(f"mlp_fused_bwd tf32 body takes {MLP_BWD_TILED} at C0 up to "
                         f"{MLP_BWD_TILED[0]}, got {c0} -> {widths}")
    w = MLP_BWD_TILED[0]
    tile = 4 * MLP_TC_ROWS * MLP_TC_PITCH
    smem = (("weights", 6 * 2 * 4 * w * w), ("bias", _r128(3 * 4 * w)),
            ("rings", MLP_BWD_WARPS * MLP_TC_STAGES * 2 * tile),
            ("hidden", MLP_BWD_WARPS * 2 * tile))
    return MlpBwdTcPlan(w, MLP_TC_ROWS, MLP_BWD_WARPS, MLP_TC_STAGES, 3 * w * w + 3 * w, smem,
                        sum(m for _, m in smem))


def pack_mlp_tf32(w0, w1, w2, b0, b1, b2):
    """LayerNet's parameters as the tensor-core body reads them: ``(wp,
    bias)``, ``wp`` the packed B operands (``pack_b_tf32``) of W0 (its rows
    zero-padded to 32), W1, W2, W2^T, W1^T and W0^T, one after the other;
    ``bias`` b0 | b1 | b2, f32."""
    w = MLP_BWD_TILED[0]
    m0 = torch.zeros((w, w), dtype=torch.float32, device=w0.device)
    m0[:w0.shape[0]] = w0
    m1, m2 = w1.float(), w2.float()
    wp = torch.cat([pack_b_tf32(m).reshape(-1) for m in (m0, m1, m2, m2.t(), m1.t(), m0.t())])
    return wp, torch.cat([b0, b1, b2]).float()


_packed = PackCache(4)   # LayerNet's pack; a train step has one


def _mlp_bwd_tc_walk(x, g, ws, bs, acts, compute_dx=True, n_blocks=3):
    """A plain walk of K10-bwd's tensor-core body on the CPU, f32, for a
    card of ``n_blocks`` SMs: every product in split TF32 k8 step by k8 step
    (``mm_k8``) in the kernel's order, x zero-padded to 32 columns; the chain
    (the recompute, g3 = a2'(h3, g), g2, g1, d(x)) is the same arithmetic
    for every row, so it runs on all rows at once; the weight gradients walk
    each warp's slabs of 16 rows (warp v of the launch takes slabs v, v +
    walkers, ...), dW carried through the warp's walk, db summed by each of
    the 8 row lanes over its rows g and g + 8 of each slab and the lanes'
    sums added by the kernel's shuffle tree; a block's partial is its warps'
    summed in warp order, and the blocks' are summed in block order.
    Returns what ``_mlp_bwd_plain`` returns for f32 rows."""
    n, c0 = x.shape
    plan = mlp_bwd_tc_plan(c0, tuple(w.shape[1] for w in ws), tuple(acts))
    k = plan.k0
    m0 = torch.zeros((k, k))
    m0[:c0] = ws[0]
    mats = (m0, ws[1].float(), ws[2].float())
    bias = [v.float() for v in bs]

    def mm(a, w):
        return mm_k8(torch.zeros((a.shape[0], w.shape[1])), a, w)

    hs = [torch.zeros((n, k))]
    hs[0][:, :c0] = x.float()
    for m, v, a in zip(mats[:2], bias[:2], acts[:2]):
        hs.append(_act(a, mm(hs[-1], m) + v))
    gz = g.float()
    if acts[2] != "linear":
        gz = _act_grad(acts[2], _act(acts[2], mm(hs[2], mats[2]) + bias[2]), gz)
    gzs = [None, None, gz]
    gzs[1] = _act_grad(acts[1], hs[2], mm(gz, mats[2].t()))
    gzs[0] = _act_grad(acts[0], hs[1], mm(gzs[1], mats[1].t()))
    dx = mm(gzs[0], m0.t())[:, :c0] if compute_dx else None
    grid = plan.grid(n, n_blocks)
    walkers = grid * plan.walkers
    n_slabs = -(-n // plan.rows)
    zeros = [torch.zeros((k, k))] * 3 + [torch.zeros(k)] * 3
    total = zeros
    for blk in range(grid):
        block = zeros
        for warp in range(plan.walkers):
            dws = [torch.zeros((k, k)) for _ in range(3)]
            lanes = [torch.zeros((8, k)) for _ in range(3)]   # db by row lane g
            for j in range(blk * plan.walkers + warp, n_slabs, walkers):
                r0, r1 = j * plan.rows, min((j + 1) * plan.rows, n)
                rows = torch.zeros((plan.rows,), dtype=torch.bool)
                rows[:r1 - r0] = True
                for i in range(3):
                    h = torch.zeros((plan.rows, k))
                    h[:r1 - r0] = hs[i][r0:r1]
                    z = torch.zeros((plan.rows, k))
                    z[:r1 - r0] = gzs[i][r0:r1]
                    dws[i] = mm_k8(dws[i], h.t(), z)
                    lanes[i] = (lanes[i] + z[:8]) + z[8:]
            dbs = []
            for lane in lanes:   # the shuffle tree: lanes g ^ 1, then g ^ 2, then g ^ 4
                for step in (1, 2, 4):
                    lane = lane + lane[torch.arange(8) ^ step]
                dbs.append(lane[0])
            block = [a + p for a, p in zip(block, dws + dbs)]
        total = [a + p for a, p in zip(total, block)]
    return dx, [total[0][:c0], total[1], total[2]], total[3:]


def _mlp_bwd_tc_kernel(x, g, ws, bs, acts, dims, codes, compute_dx):
    """K10-bwd's tensor-core f32 body (``mlp_bwd_tc_plan``) on f32 rows, the
    cotangent read as f32; the weights from ``pack_mlp_tf32``, packed once
    per parameter value: ``(dx f32 or None, dWs, dbs)``."""
    plan = mlp_bwd_tc_plan(dims[0], tuple(dims[1:]), tuple(acts))
    dev = x.device
    x, g = x.contiguous(), g.float().contiguous()
    n, k = x.shape[0], plan.k0
    dx = torch.empty((n, dims[0]), dtype=torch.float32, device=dev) if compute_dx else None
    if n == 0:
        out = torch.zeros(plan.parts, dtype=torch.float32, device=dev)
    else:
        wp, bias = _packed.get((*ws, *bs), ("tf32_mlp",), pack_mlp_tf32)
        idx = dev.index or 0
        grid = plan.grid(n, _build.sm_count(idx))
        parts = torch.empty(grid * plan.parts, dtype=torch.float32, device=dev)
        out = torch.empty(plan.parts, dtype=torch.float32, device=dev)
        P, INT = _build.PTR, _build.INT
        fn = _build.kernel("wcmc_mlp_fused_bwd_tf32", *([P] * 7), _build.LONG, *([INT] * 6), P)
        _build.check(fn(x.data_ptr(), g.data_ptr(), wp.data_ptr(), bias.data_ptr(),
                        dx.data_ptr() if compute_dx else None, parts.data_ptr(), out.data_ptr(),
                        n, dims[0], *codes, grid, idx, _build.stream_of(dev)), "mlp_fused_bwd")
        _build.launches["mlp_fused_bwd"] += 1
    dw0, dw1, dw2, db0, db1, db2 = torch.split(out, [k * k] * 3 + [k] * 3)
    return dx, [dw0.view(k, k)[:dims[0]], dw1.view(k, k), dw2.view(k, k)], [db0, db1, db2]


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


def _mlp_fwd_kernel(x, ws, bs, acts, body=None):
    """K10-fwd on the body :func:`mlp_fwd_plan` names (``body="wmma"`` forces
    the wmma body, the card tests' and ``chip_smoke.py``'s reference); f32
    rows on the f32 body."""
    dims, codes = _check_card("mlp_fused", x, ws, bs, acts)
    if x.dtype == torch.float32:
        if body is not None:
            raise ValueError(f"mlp_fused: f32 rows have one body, not {body!r}")
        return _mlp_fwd_f32_kernel(x, ws, bs, acts, dims, codes)
    plan = mlp_fwd_plan(dims[0], tuple(dims[1:]), tuple(acts))
    body = body or plan.body
    if body not in ("tiled", "wmma") or (body == "tiled" and plan.body != "tiled"):
        raise ValueError(f"mlp_fused: no {body!r} body for {dims[0]} -> {tuple(dims[1:])}")
    dev = x.device
    x = x.contiguous()
    n = x.shape[0]
    out = torch.empty((n, dims[-1]), dtype=torch.bfloat16, device=dev)
    if n == 0:
        return out
    P, INT, L = _build.PTR, _build.INT, MLP_MAX_LAYERS
    idx = dev.index or 0
    if body == "tiled":
        # the f32 parameters as they are: the kernel rounds the weights as it stages them
        params = [t.float().contiguous() for t in (*ws, *bs)]
        fn = _build.kernel("wcmc_mlp_fused_tiled", *([P] * 8), _build.LONG, *([INT] * 6), P)
        err = fn(x.data_ptr(), *(t.data_ptr() for t in params), out.data_ptr(), n, dims[0],
                 *codes, plan.grid(n, _build.sm_count(idx)), idx, _build.stream_of(dev))
    else:
        _, wb, bf, ptrs, widths, codes = _padded_params(x, ws, bs, codes)
        fn = _build.kernel("wcmc_mlp_fused", P, *([P] * (2 * L)), P, _build.LONG, INT, INT,
                           *([INT] * (2 * L)), INT, INT, P)
        err = fn(x.data_ptr(), *ptrs, out.data_ptr(), n, dims[0], len(ws), *widths, *codes,
                 4 * _build.sm_count(idx), idx, _build.stream_of(dev))
    _build.check(err, "mlp_fused")
    _build.launches["mlp_fused"] += 1
    return out


def _mlp_bwd_kernel(x, g, ws, bs, acts, compute_dx, body=None):
    """K10-bwd on the card.  bf16 rows run the body :func:`mlp_bwd_plan`
    names (``body="wmma"`` forces the wmma body).  f32 rows run the
    tensor-core body (``body`` None or "tc") where it holds the chain
    (LayerNet's, :func:`mlp_tc_form`), else the SIMT body, which takes every
    form; ``body="simt"`` runs the SIMT body whatever the chain (the card
    tests' and ``chip_smoke.py``'s reference)."""
    dims, codes = _check_card("mlp_fused_bwd", x, ws, bs, acts)
    dev = x.device
    n = x.shape[0]
    if tuple(g.shape) != (n, dims[-1]) or g.device != dev:
        raise ValueError(f"mlp_fused_bwd: cotangent {tuple(g.shape)} on {g.device} does "
                         f"not match the output ({n}, {dims[-1]}) on {dev}")
    if x.dtype == torch.float32:
        if body not in (None, "tc", "simt"):
            raise ValueError(f"mlp_fused_bwd: no f32 body {body!r}; 'tc' or 'simt'")
        if body != "simt" and mlp_tc_form(dims[0], dims[1:]):
            return _mlp_bwd_tc_kernel(x, g, ws, bs, acts, dims, codes, compute_dx)
        return _mlp_bwd_f32_kernel(x, g, ws, bs, acts, dims, codes, compute_dx)
    plan = mlp_bwd_plan(dims[0], tuple(dims[1:]), tuple(acts))
    body = body or plan.body
    if body not in ("tiled", "wmma") or (body == "tiled" and plan.body != "tiled"):
        raise ValueError(f"mlp_fused_bwd: no {body!r} body for {dims[0]} -> {tuple(dims[1:])}")
    x = x.contiguous()
    g = g.to(torch.bfloat16).contiguous()
    k0 = plan.k0 if body == "tiled" else -(-dims[0] // 16) * 16
    kdims = [k0] + dims[1:]
    sizes = ([ci * co for ci, co in zip(kdims[:-1], kdims[1:])] + dims[1:])
    n_parts = sum(sizes)
    idx = dev.index or 0
    sms = _build.sm_count(idx)
    n_blocks = plan.grid(n, sms) if body == "tiled" else 4 * sms
    parts = torch.empty(n_blocks * n_parts, dtype=torch.float32, device=dev)
    out = torch.empty(n_parts, dtype=torch.float32, device=dev)
    dx = torch.empty((n, dims[0]), dtype=torch.bfloat16, device=dev) if compute_dx else None
    dx_ptr = dx.data_ptr() if compute_dx else None
    P, INT, LONG, L = _build.PTR, _build.INT, _build.LONG, MLP_MAX_LAYERS
    if body == "tiled":
        # the f32 parameters as they are: the kernel rounds the weights as it stages them
        params = [t.float().contiguous() for t in (*ws, *bs)]
        fn = _build.kernel("wcmc_mlp_fused_bwd_tiled", *([P] * 11), LONG, *([INT] * 6), P)
        err = fn(x.data_ptr(), g.data_ptr(), *(t.data_ptr() for t in params), dx_ptr,
                 parts.data_ptr(), out.data_ptr(), n, dims[0], *codes, n_blocks, idx,
                 _build.stream_of(dev))
    else:
        _, wb, bf, ptrs, widths, codes = _padded_params(x, ws, bs, codes)
        fn = _build.kernel("wcmc_mlp_fused_bwd", P, P, *([P] * (2 * L)), P, P, P, LONG,
                           INT, INT, *([INT] * (2 * L)), INT, INT, P)
        err = fn(x.data_ptr(), g.data_ptr(), *ptrs, dx_ptr, parts.data_ptr(), out.data_ptr(),
                 n, dims[0], len(ws), *widths, *codes, n_blocks, idx, _build.stream_of(dev))
    _build.check(err, "mlp_fused_bwd")
    _build.launches["mlp_fused_bwd"] += 1
    chunks = torch.split(out, sizes)
    nl = len(ws)
    dws = [c.view(ci, co) for c, ci, co in zip(chunks[:nl], kdims[:-1], kdims[1:])]
    dws[0] = dws[0][:dims[0]]
    return dx, dws, list(chunks[nl:])


def mlp_fused_bwd(x, g, ws, bs, acts, compute_dx=True, body=None):
    """Gradients of :func:`fused_mlp` for the output cotangent ``g``:
    ``(dx in x.dtype or None, dWs, dbs)``, dW and db f32.  K10-bwd for
    CUDA tensors, on the body :func:`_mlp_bwd_kernel` picks (``body``
    selects another: "wmma" for bf16 rows, "simt" for f32 ones, the card
    tests' and ``chip_smoke.py``'s references), the plain version for CPU
    tensors."""
    if x.device.type == "cpu":
        return _mlp_bwd_plain(x, g, ws, bs, acts, compute_dx)
    return _mlp_bwd_kernel(x, g, ws, bs, acts, compute_dx, body)


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
