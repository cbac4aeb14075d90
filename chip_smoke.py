#!/usr/bin/env python3
"""Drive the PyTorch port's serving path and its training step on one
NVIDIA card and check them.

    python3 chip_smoke.py

Phases (one JSON line each):

1. device: the card's name and count, ``nvidia-smi`` name and power
   limit; exits non-zero without CUDA.
2. build: the hand-written kernels of ``wcmc_tpu_torch/ops/csrc``
   compiled from the repository's sources (``-Xptxas -v`` registers,
   shared memory and spills per kernel).
3. kernels: K1 (softmax gather), K4-fwd (PathNet embedding) and K5-fwd
   (PathNet head) at the serving shapes (8 tiles of 128 px, 8 spp,
   K = 21, both branches), and the backward kernels K2 (softmax-gather
   d logits), K3 (softmax-gather d buffer), K4-bwd and K5-bwd at the
   training shapes (the same sizes), each held against its plain PyTorch
   version on the same inputs; CUDA-event times (median of repeats after
   warm-up, L2 flushed before each launch) beside the least time the
   card could take (bytes over 3.35 TB/s or operations over the peak
   rate of their type, whichever is larger).  K2 and K3 are first
   driven through ``torch.autograd.grad`` of ``kernel_gather_softmax``
   with a buffer that requires grad (the only path that reaches K3: the
   KPCN buffers are data).
4. serve: a synthetic 512x512, 8-spp scene is written, preprocessed on
   the card and denoised through ``wcmc_tpu_torch.test_models.main`` —
   the full-width KPCN (K 21, depth 9, width 100) + dual PathNet in
   bf16 from seeded weights, 49 tiles in 7 batches of 8.  Every kernel
   must have launched and no plain version may have run.  One tile is
   checked against the same weights run on the CPU in bf16 and in f32,
   and the frame is timed again in steady state (five runs, then one
   under ``torch.profiler`` for the device busy time and the host
   stages).
5. train: the flagship KPCN + manifold training step (FMSE with roll
   pairing, Adam with value clip 1.0, bf16 compute, f32 parameters) on
   a synthetic batch of 8 patches of 128 px at 8 spp, through
   ``init_interfaces`` -> ``to_train_mode`` -> ``preprocess`` ->
   ``train_batch``: 3 warm-up steps, 10 timed steps (step ms, MP/s, peak
   memory, launches per step), 2 more under ``torch.profiler``.  Every
   kernel of the step must launch, no plain version may run, every loss
   must be finite and every model's parameters must change.  One step on
   the card is then held against the same step (weights, batch, draws)
   on the CPU in bf16 and in f32: the loss dict, and each model's
   flattened gradient by cosine and norm ratio.

Then the kernel table, the card's ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``.  Any failed phase raises and the
script exits non-zero without that line.  TF32 is off throughout, so
the f32 reference products are full f32.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

# published H100 SXM peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

K1_TOL = 1e-5          # of max |plain|: same logits, f32 softmax, other order
K2_BF16_TOL = 1e-2     # of max |plain|: one bf16 rounding of an f32 gradient
BF16_TOL = 2e-2        # of max |plain|: bf16 hidden layers summed in another order
# relative L2 of K5-bwd's per-row outputs (d e, d ctx): a recomputed
# pre-activation within rounding of zero can take the other side of its
# relu and move that element's gradient by its full size
ROW_L2_TOL = 1e-2
# of max |ref|, one served tile: the bf16 card path against the port's
# bf16 CPU path (whose parity with wcmc_tpu in bf16 is a CPU test), and
# against its f32 CPU path.  Measured on an H100: at most 1.0e-3 and
# 3.2e-3 absolute over refs of 0.24 to 1.68, so under 4.3e-3 and 1.4e-2
# of max |ref|.
SERVE_BF16_TOL = 1e-2
SERVE_F32_TOL = 3e-2
SEED = 0


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def parse_ptxas(log: str):
    """Per-kernel registers, shared memory and spills from nvcc's
    ``-Xptxas -v`` report."""
    kernels, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            kernels.append({"kernel": name, "registers": int(m.group(1)),
                            "static_smem": int(m.group(2) or 0),
                            "spill_stores": spills[0], "spill_loads": spills[1]})
            name = None
    return kernels


def time_ms(torch, fn, repeats, flush):
    """Median CUDA-event time of ``fn`` over ``repeats`` launches after
    two warm-up calls, with the L2 cache flushed before each launch."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(repeats):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(torch, got, want, tol, pairs=None):
    """Largest |got - want| over the pairs; each pair must be finite, of
    one shape and within ``tol`` of its max |want|.  With ``pairs``, each
    pair's max |want| and error over it are appended there."""
    got, want = [t.double() for t in got], [t.double() for t in want]
    errs = []
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        if not bool(torch.isfinite(g).all()):
            raise AssertionError("non-finite kernel output")
        err = (g - w).abs().max().item()
        scale = w.abs().max().item()
        if pairs is not None:
            pairs.append({"max_abs_ref": scale, "err_over_ref": err / scale})
        if err > tol * scale:
            raise AssertionError(f"max error {err} > {tol} * {scale}")
        errs.append(err)
    return max(errs)


def bound_ms(n_bytes, ops_by_rate):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = sum(ops / rate for ops, rate in ops_by_rate)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def kernel_phase(torch, ka, pf, dev):
    """K1, K4-fwd, K5-fwd at the serving shapes against their plain
    versions; returns the kernel table's rows (without launches)."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    rows = []

    # K1: one launch per branch; buf (8, 92, 92, 3) f32, logits the
    # (8, 72, 72, 441) crop of a channels-last (8, 441, 92, 92) conv
    # output; bf16 logits as on the serving path, plus an f32 leg
    b, k = 8, 21
    buf = torch.rand((b, 92, 92, 3), device=dev, generator=g)
    legs = {}
    for dtype, leg in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        conv_out = 2 * torch.randn((b, k * k, 92, 92), device=dev, generator=g)
        conv_out = conv_out.to(dtype).contiguous(memory_format=torch.channels_last)
        logits = conv_out.permute(0, 2, 3, 1)[:, 10:82, 10:82]
        out = ka.kernel_gather_softmax(buf, logits, k)
        err = max_err(torch, [out], [ka.gather_softmax_plain(buf, logits, k)], K1_TOL)
        taps = b * 72 * 72 * k * k
        # softmax ~5 f32 ops per tap (max, sub, exp, add, scale), 2 per channel
        bms, by = bound_ms(logits.element_size() * taps + nbytes(buf, out),
                           [(taps * (5 + 2 * 3), F32_FLOPS)])
        legs[leg] = {
            "max_abs_err": err,
            "ms": time_ms(torch, lambda: ka.kernel_gather_softmax(buf, logits, k), 20, flush),
            "plain_ms": time_ms(torch, lambda: ka.gather_softmax_plain(buf, logits, k), 3,
                                flush),
            "bound_ms": bms, "bound_by": by,
        }
        del conv_out, logits, out
    rows.append({
        "name": "gather_softmax", "route": "cuda",
        "source": "wcmc_tpu_torch/ops/csrc/gather_softmax.cu",
        "replaces": "wcmc_tpu/ops/pallas_kernels.py:185", "counter": "gather_softmax",
        **legs["bf16"], "library_ms": None, "f32_logits": legs["f32"],
        "shape": {"buf": [b, 92, 92, 3], "logits": [b, 72, 72, k * k],
                  "logits_dtype": "bfloat16", "launches_per_batch": 2},
    })

    # K4-fwd: dual PathNet embedding, 36 -> 128 -> 128 -> 128
    s, hw = 8, 128 * 128
    dims = (36, 128, 128, 128)
    x = torch.randn((b, s, hw, dims[0]), device=dev, generator=g).to(torch.bfloat16)
    ws = [torch.randn((ci, co), device=dev, generator=g) / ci**0.5
          for ci, co in zip(dims[:-1], dims[1:])]
    bs = [0.1 * torch.randn(co, device=dev, generator=g) for co in dims[1:]]
    e, mean = pf.pathnet_embed(x, ws, bs)
    err = max_err(torch, [e, mean], list(pf._embed_plain(x, ws, bs, pf.EMBED_ACTS)),
                  BF16_TOL)
    n_rows = b * s * hw
    flops = 2 * n_rows * sum(ci * co for ci, co in zip(dims[:-1], dims[1:]))
    bms, by = bound_ms(nbytes(x, e, mean) + sum(2 * w.numel() + 4 * w.shape[1] for w in ws),
                       [(flops, BF16_FLOPS)])
    rows.append({
        "name": "pathnet_embed", "route": "cuda",
        "source": "wcmc_tpu_torch/ops/csrc/pathnet_embed.cu",
        "replaces": "wcmc_tpu/ops/pathnet_fused.py:155",
        "counter": "pathnet_embed", "max_abs_err": err,
        "ms": time_ms(torch, lambda: pf.pathnet_embed(x, ws, bs), 20, flush),
        "plain_ms": time_ms(torch, lambda: pf._embed_plain(x, ws, bs, pf.EMBED_ACTS), 3, flush),
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "shape": {"x": list(x.shape), "dims": list(dims)},
    })
    del x

    # K5-fwd: dual PathNet head with moments, [128 | 128] -> 256 -> 6
    # the context is the UNet's output in the compute dtype
    ctx = torch.randn((b, hw, 128), device=dev, generator=g).to(torch.bfloat16)
    hws = [torch.randn((256, 256), device=dev, generator=g) / 16.0,
           torch.randn((256, 6), device=dev, generator=g) / 16.0]
    hbs = [0.1 * torch.randn(256, device=dev, generator=g),
           0.1 * torch.randn(6, device=dev, generator=g)]
    got = pf.pathnet_head(e, ctx, hws, hbs, pf.HEAD_ACTS, True)
    err = max_err(torch, list(got),
                  list(pf._head_plain(e, ctx, hws, hbs, pf.HEAD_ACTS, True)), BF16_TOL)
    # the context product is done once per pixel, not once per sample
    flops = 2 * n_rows * (128 * 256 + 256 * 6) + 2 * b * hw * 128 * 256
    bms, by = bound_ms(nbytes(e, ctx, *got) + sum(2 * w.numel() + 4 * w.shape[1] for w in hws),
                       [(flops, BF16_FLOPS)])
    rows.append({
        "name": "pathnet_head", "route": "cuda",
        "source": "wcmc_tpu_torch/ops/csrc/pathnet_head.cu",
        "replaces": "wcmc_tpu/ops/pathnet_fused.py:457",
        "counter": "pathnet_head", "max_abs_err": err,
        "ms": time_ms(torch, lambda: pf.pathnet_head(e, ctx, hws, hbs, pf.HEAD_ACTS, True),
                      20, flush),
        "plain_ms": time_ms(torch, lambda: pf._head_plain(e, ctx, hws, hbs, pf.HEAD_ACTS, True),
                            3, flush),
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "shape": {"e": list(e.shape), "ctx": list(ctx.shape), "w1": [256, 256], "w2": [256, 6]},
    })
    torch.cuda.synchronize()
    return rows


def rel_l2(torch, got, want):
    got, want = got.double(), want.double()
    return ((got - want).norm() / want.norm()).item()


def backward_kernel_phase(torch, ka, pf, dev):
    """K2, K3, K4-bwd and K5-bwd at the training shapes against their
    plain versions; returns the kernel table's rows, K3's with the
    launches of its autograd drive."""
    from wcmc_tpu_torch.ops import _build

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    rows = []

    # K2 and K3: one branch of the KPCN gather, bf16 logits cropped from
    # a channels-last conv output, reached through autograd
    b, k, h = 8, 21, 72
    buf = torch.rand((b, h + k - 1, h + k - 1, 3), device=dev, generator=g)
    conv_out = 2 * torch.randn((b, k * k, h + k - 1, h + k - 1), device=dev, generator=g)
    conv_out = conv_out.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    conv_out.requires_grad_()
    logits = conv_out.permute(0, 2, 3, 1)[:, 10:10 + h, 10:10 + h]
    cot = torch.randn((b, h, h, 3), device=dev, generator=g)
    src = buf.clone().requires_grad_()
    out = ka.kernel_gather_softmax(src, logits, k)
    _build.reset_counts()
    dbuf, dconv = torch.autograd.grad(out, [src, conv_out], cot)
    torch.cuda.synchronize()
    autograd_launches, autograd_plain = dict(_build.launches), dict(_build.plain_calls)
    if autograd_launches != {"outer_softmax": 1, "scatter_softmax": 1} or autograd_plain:
        raise AssertionError(f"autograd of the gather launched {autograd_launches}, "
                             f"plain {autograd_plain}")
    # the logits' gradient as the train step gets it: K2, then autograd's
    # backward of the crop, which zero-fills the full conv-output gradient
    # and copies K2's output into it
    data_out = ka.kernel_gather_softmax(buf, logits, k)
    through_crop_ms = time_ms(torch, lambda: torch.autograd.grad(
        data_out, conv_out, cot, retain_graph=True), 20, flush)
    lg = logits.detach()
    dlogits = dconv.permute(0, 2, 3, 1)[:, 10:10 + h, 10:10 + h]
    err2 = max_err(torch, [dlogits], [ka.outer_softmax_plain(cot, buf, lg, k)], K2_BF16_TOL)
    err3 = max_err(torch, [dbuf], [ka.scatter_softmax_plain(cot, lg, k)], K1_TOL)
    taps = b * h * h * k * k
    # per tap: 2 flops per channel for dp, ~8 for the softmax and its VJP
    bms2, by2 = bound_ms(2 * 2 * taps + nbytes(cot, buf), [(taps * (2 * 3 + 8), F32_FLOPS)])
    # per tap: exp, scale, 2 flops per channel
    bms3, by3 = bound_ms(2 * taps + nbytes(cot, dbuf), [(taps * (3 + 2 * 3), F32_FLOPS)])
    shape = {"g": [b, h, h, 3], "buf": list(buf.shape), "logits": [b, h, h, k * k],
             "logits_dtype": "bfloat16"}
    rows.append({
        "name": "outer_softmax", "route": "cuda",
        "source": "wcmc_tpu_torch/ops/csrc/outer_softmax.cu",
        "replaces": "wcmc_tpu/ops/pallas_kernels.py:410", "counter": "outer_softmax",
        "max_abs_err": err2,
        "ms": time_ms(torch, lambda: ka.outer_softmax(cot, buf, lg, k), 20, flush),
        "plain_ms": time_ms(torch, lambda: ka.outer_softmax_plain(cot, buf, lg, k), 3, flush),
        "bound_ms": bms2, "bound_by": by2, "library_ms": None,
        "library_note": "no single PyTorch call computes the softmax-gather VJP",
        "through_crop_ms": through_crop_ms,
        "shape": shape,
    })
    rows.append({
        "name": "scatter_softmax", "route": "cuda",
        "source": "wcmc_tpu_torch/ops/csrc/scatter_softmax.cu",
        "replaces": "wcmc_tpu/ops/pallas_kernels.py:297", "counter": "scatter_softmax",
        "max_abs_err": err3,
        "ms": time_ms(torch, lambda: ka.scatter_softmax(cot, lg, k), 20, flush),
        "plain_ms": time_ms(torch, lambda: ka.scatter_softmax_plain(cot, lg, k), 3, flush),
        "bound_ms": bms3, "bound_by": by3, "library_ms": None,
        "library_note": "no single PyTorch call computes the softmax-weighted splat",
        "launches_from": "torch.autograd.grad of kernel_gather_softmax with a buffer "
                         "that requires grad (kernel phase); the KPCN step's buffers are data",
        "autograd_launches": autograd_launches["scatter_softmax"],
        "shape": shape,
    })
    del conv_out, logits, lg, dconv, dlogits, out, data_out

    # K4-bwd: dual PathNet embedding, 36 -> 128 -> 128 -> 128
    s, hw = 8, 128 * 128
    dims = (36, 128, 128, 128)
    x = torch.randn((b, s, hw, dims[0]), device=dev, generator=g).to(torch.bfloat16)
    ws = [torch.randn((ci, co), device=dev, generator=g) / ci**0.5
          for ci, co in zip(dims[:-1], dims[1:])]
    bs = [0.1 * torch.randn(co, device=dev, generator=g) for co in dims[1:]]
    ge = torch.randn((b, s, hw, dims[-1]), device=dev, generator=g).to(torch.bfloat16)
    gmean = torch.randn((b, hw, dims[-1]), device=dev, generator=g)
    _, dws, dbs = pf.pathnet_embed_bwd(x, ge, gmean, ws, bs)
    _, pws, pbs = pf._embed_bwd_plain(x, ge, gmean, ws, bs, pf.EMBED_ACTS)
    err = max_err(torch, dws + dbs, pws + pbs, BF16_TOL)
    n_rows = b * s * hw
    # recompute two layers (the output layer is linear: not needed), then
    # dW2, g2, dW1, g1, dW0
    macs = n_rows * (36 * 128 + 128 * 128 + 4 * 128 * 128 + 36 * 128)
    bms, by = bound_ms(nbytes(x, ge, gmean, *dws, *dbs)
                       + sum(2 * w.numel() + 4 * w.shape[1] for w in ws),
                       [(2 * macs, BF16_FLOPS)])
    rows.append({
        "name": "pathnet_embed_bwd", "route": "cuda",
        "source": "wcmc_tpu_torch/ops/csrc/pathnet_embed_bwd.cu",
        "replaces": "wcmc_tpu/ops/pathnet_fused.py:188", "counter": "pathnet_embed_bwd",
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: pf.pathnet_embed_bwd(x, ge, gmean, ws, bs), 10, flush),
        "plain_ms": time_ms(torch, lambda: pf._embed_bwd_plain(x, ge, gmean, ws, bs,
                                                               pf.EMBED_ACTS), 3, flush),
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "library_note": "no single PyTorch call computes a fused MLP's backward",
        "shape": {"x": list(x.shape), "ge": list(ge.shape), "gmean": list(gmean.shape),
                  "dims": list(dims)},
    })
    del x, ge, gmean, pws, pbs

    # K5-bwd: dual PathNet head with moments, channel-major cotangent
    e = torch.randn((b, s, hw, 128), device=dev, generator=g).to(torch.bfloat16)
    ctx = torch.randn((b, hw, 128), device=dev, generator=g).to(torch.bfloat16)
    hws = [torch.randn((256, 256), device=dev, generator=g) / 16.0,
           torch.randn((256, 6), device=dev, generator=g) / 16.0]
    hbs = [0.1 * torch.randn(256, device=dev, generator=g),
           0.1 * torch.randn(6, device=dev, generator=g)]
    gout = torch.randn((b, s, 6, hw), device=dev, generator=g)
    gsum = torch.randn((b, hw, 6), device=dev, generator=g)
    gsq = 0.1 * torch.randn((b, hw, 6), device=dev, generator=g)
    de, dctx, dws, dbs = pf.pathnet_head_bwd(e, ctx, gout, gsum, gsq, hws, hbs, cmajor=True)
    pde, pdctx, pws, pbs = pf._head_bwd_plain(e, ctx, gout, gsum, gsq, hws, hbs,
                                              pf.HEAD_ACTS, cmajor=True)
    max_err(torch, dws + dbs, pws + pbs, BF16_TOL)
    row_l2 = {"de": rel_l2(torch, de, pde), "dctx": rel_l2(torch, dctx, pdctx)}
    if max(row_l2.values()) > ROW_L2_TOL:
        raise AssertionError(f"K5-bwd per-row outputs off by {row_l2} (relative L2)")
    err = max((a.double() - w.double()).abs().max().item()
              for a, w in zip([de, dctx, *dws, *dbs], [pde, pdctx, *pws, *pbs]))
    pixels = b * hw
    # per row: recompute e.W1e and h1.W2, then dW2, g1, dW1e, de; per
    # pixel (the context is shared by the S samples): ctx.W1c, dW1c, dctx
    macs = n_rows * (3 * 128 * 256 + 3 * 256 * 6) + pixels * 3 * 128 * 256
    bms, by = bound_ms(nbytes(e, ctx, gout, gsum, gsq, de, dctx, *dws, *dbs)
                       + sum(2 * w.numel() + 4 * w.shape[1] for w in hws),
                       [(2 * macs, BF16_FLOPS)])
    rows.append({
        "name": "pathnet_head_bwd", "route": "cuda",
        "source": "wcmc_tpu_torch/ops/csrc/pathnet_head_bwd.cu",
        "replaces": "wcmc_tpu/ops/pathnet_fused.py:511", "counter": "pathnet_head_bwd",
        "max_abs_err": err, "row_rel_l2": row_l2,
        "ms": time_ms(torch, lambda: pf.pathnet_head_bwd(e, ctx, gout, gsum, gsq, hws, hbs,
                                                         cmajor=True), 10, flush),
        "plain_ms": time_ms(torch, lambda: pf._head_bwd_plain(
            e, ctx, gout, gsum, gsq, hws, hbs, pf.HEAD_ACTS, cmajor=True), 3, flush),
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "library_note": "no single PyTorch call computes a fused MLP's backward",
        "shape": {"e": list(e.shape), "ctx": list(ctx.shape), "g": list(gout.shape),
                  "w1": [256, 256], "w2": [256, 6]},
    })
    torch.cuda.synchronize()
    return rows


def profile_frame(torch, evaluate, iface, ds):
    """One more steady-state frame under torch.profiler: device busy
    time and idle share, the host stages named in
    ``evaluate.inference``, and the largest device entries."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        evaluate.inference(iface, ds, batch_size=8)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    # device entries only (kernels and copies): a CPU op's self device
    # time is that of the kernels it launched, which are entries too, and
    # a record_function range also shows up on the device as an annotation
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    top = sorted(device, key=lambda e: e.self_device_time_total, reverse=True)[:15]
    return {
        "wall_ms_profiled": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "host_stage_ms": {e.key: e.cpu_time_total / 1e3 for e in events
                          if e.key.startswith("inference.")
                          and e.device_type == DeviceType.CPU},
        "top_device": [{"name": e.key[:90], "ms": e.self_device_time_total / 1e3,
                        "count": e.count} for e in top],
    }


def serve_phase(torch, dev, work):
    """The serving path through the port's entry point; returns the
    phase record, the launch counts and the interface."""
    from wcmc_tpu_torch import convert, evaluate, test_models
    from wcmc_tpu_torch.data.dataset import offline_preprocess
    from wcmc_tpu_torch.data.full_image import FullImageDataset
    from wcmc_tpu_torch.data.synthetic import build_synthetic_dataset
    from wcmc_tpu_torch.ops import _build
    from wcmc_tpu_torch.train.factory import TrainConfig, init_interfaces

    root = os.path.join(work, "data")
    t0 = time.perf_counter()
    build_synthetic_dataset(root, n_train=0, n_val=0, n_test=1, size=512, spp=8,
                            test_extra_parts=0, seed=SEED)
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    offline_preprocess(root, mode="test", spp=8, test_spps=(8,), device=dev)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0

    args = test_models.parse_args([
        "--model_name", "KPCN_smoke", "--save", os.path.join(work, "weights"),
        "--data_dir", root, "--spps", "8", "--use_llpm_buf",
        "--output_dir", os.path.join(work, "eval"), "--device", str(dev),
        "--seed", str(SEED)])
    _build.reset_counts()
    results, iface = test_models.main(args)
    torch.cuda.synchronize()
    launches, plain = dict(_build.launches), dict(_build.plain_calls)
    for name in ("gather_softmax", "pathnet_embed", "pathnet_head"):
        if launches.get(name, 0) < 1:
            raise AssertionError(f"kernel {name} was not launched on the serving path")
    if plain:
        raise AssertionError(f"plain versions ran on the serving path: {plain}")
    res = results[("scene0", 8)]["output"]
    bad = [k for k, v in res.items() if v != v or abs(v) == float("inf")]
    if bad:
        raise AssertionError(f"non-finite metrics: {bad}")
    csv_path = os.path.join(work, "eval", "results_8.csv")
    if not os.path.isfile(csv_path):
        raise AssertionError("denoise wrote no CSV")

    # steady state: the same frame again, five times
    fn = os.path.join(root, "test", "input", "scene0.npy")
    ds = FullImageDataset(fn, 8, "kpcn", use_llpm_buf=True)
    secs = []
    for _ in range(5):
        out_rad, out_path, dt = evaluate.inference(iface, ds, batch_size=8)
        secs.append(dt)
    if out_rad.shape != (512, 512, 3) or not bool(torch.isfinite(
            torch.from_numpy(out_rad)).all()):
        raise AssertionError(f"bad frame {out_rad.shape}")
    for k, v in out_path.items():
        if v.shape != (8, 512, 512, 3):
            raise AssertionError(f"bad p-buffer {k} {v.shape}")

    profiled = profile_frame(torch, evaluate, iface, ds)

    # one tile against the same weights on the CPU (plain versions), in
    # bf16 and in f32; errors and max |ref| of (radiance, diffuse and
    # specular p-buffers)
    tile = {k: v[None] for k, v in ds[0][0].items()}
    card_rad, card_p = iface.validate_batch(tile)
    card = [card_rad.cpu(), card_p["diffuse"].cpu(), card_p["specular"].cpu()]
    tile_check = {}
    for dtype, tol in (("bfloat16", SERVE_BF16_TOL), ("float32", SERVE_F32_TOL)):
        ref_if = init_interfaces(TrainConfig(kpcn_ksize=21, use_llpm_buf=True,
                                             compute_dtype=dtype), device="cpu")[0]
        for name, m in iface.models.items():
            convert.load_flax_params(ref_if.models[name], convert.to_flax(m))
        t0 = time.perf_counter()
        ref_rad, ref_p = ref_if.validate_batch(tile)
        pairs = []
        err = max_err(torch, card, [ref_rad, ref_p["diffuse"], ref_p["specular"]],
                      tol, pairs)
        tile_check[dtype] = {"max_abs_err": err, "radiance_diffuse_specular": pairs,
                             "tol": tol, "cpu_s": time.perf_counter() - t0}

    frame_ms = 1e3 * statistics.median(secs)
    record = {
        "phase": "serve", "frame": [512, 512], "spp": 8, "tiles": len(ds),
        "batches": -(-len(ds) // 8), "data_s": t_data, "preprocess_s": t_pre,
        "first_frame_ms": 1e3 * res["inference_sec"], "frame_ms": frame_ms,
        "frame_ms_runs": [1e3 * t for t in secs], "mp_per_s": 512 * 512 / 1e6 / (frame_ms / 1e3),
        "launches": launches, "plain_calls": plain,
        "linear_RelMSE": res["linear_RelMSE"], "tile_vs_cpu": tile_check,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
        "profile": profiled,
    }
    return record, launches


TRAIN_KERNELS = ("gather_softmax", "outer_softmax", "pathnet_embed", "pathnet_embed_bwd",
                 "pathnet_head", "pathnet_head_bwd")
# one bf16 step on the card (flagship weights after the timed steps,
# first two patches of the batch) against the same step on the CPU in
# bf16 and in f32: each loss's relative error, and per model the cosine
# of the flattened gradients and |norm ratio - 1|.  Measured on an H100
# (NVIDIA H100 80GB HBM3, 700 W): bf16 5.0e-4, 0.99483, 0.0135; f32
# 7.0e-4, 0.99890, 0.0106.  Limits about 2.5x those errors.
XCHECK_LIMITS = {
    "bfloat16": {"loss_rel": 1.25e-3, "cos": 0.987, "norm_ratio": 0.034},
    "float32": {"loss_rel": 1.75e-3, "cos": 0.9973, "norm_ratio": 0.027},
}


def train_config(**kw):
    from wcmc_tpu_torch.train.factory import TrainConfig

    return TrainConfig(base_model="kpcn", use_llpm_buf=True, manif_learn=True,
                       manif_loss="FMSE", seed=SEED, **kw)


def profile_steps(torch, iface, batch, n):
    """``n`` more train steps under torch.profiler: device busy time and
    idle share, and the largest device entries."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            iface.preprocess(batch)
            iface.train_batch(batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    top = sorted(device, key=lambda e: e.self_device_time_total, reverse=True)[:20]
    return {
        "steps": n, "wall_ms_profiled": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "top_device": [{"name": e.key[:90], "ms": e.self_device_time_total / 1e3,
                        "count": e.count} for e in top],
    }


def cross_check(torch, card_if, batch, dev):
    """One step of ``card_if``'s weights on the card against the same
    step on the CPU in bf16 and in f32 (same batch and draws): relative
    error of each loss, and each model's flattened gradient by cosine
    and norm ratio."""
    from wcmc_tpu_torch import convert
    from wcmc_tpu_torch.train.factory import init_interfaces

    b, s, h = batch["paths"].shape[:3]
    kpcn = card_if.models["dncnn"]
    out_hw = h - 4 * kpcn.depth - (kpcn.ksize - 1)
    draws = card_if.draw_pairings((b, s, 3, out_hw, out_hw))
    card_if.preprocess(batch)
    card_loss = card_if.train_batch(batch, grad_hook_mode=True, draws=draws)
    card_grads = {n: torch.cat([p.grad.flatten().double().cpu() for p in m.parameters()])
                  for n, m in card_if.models.items()}
    host = {k: v.cpu() for k, v in batch.items()}
    result = {}
    for dtype, lim in XCHECK_LIMITS.items():
        ref = init_interfaces(train_config(compute_dtype=dtype, kpcn_ksize=kpcn.ksize),
                              device="cpu")[0]
        for name, m in card_if.models.items():
            convert.load_flax_params(ref.models[name], convert.to_flax(m))
        ref.to_train_mode()
        ref.preprocess(host)
        t0 = time.perf_counter()
        ref_loss = ref.train_batch(host, grad_hook_mode=True, draws=draws)
        cpu_s = time.perf_counter() - t0
        loss_rel = {k: abs(float(card_loss[k]) - float(v)) / abs(float(v))
                    for k, v in ref_loss.items()}
        grads = {}
        for name, m in ref.models.items():
            a = card_grads[name]
            r = torch.cat([p.grad.flatten().double() for p in m.parameters()])
            grads[name] = {"cos": float(a @ r / (a.norm() * r.norm())),
                           "norm_ratio": float(a.norm() / r.norm())}
        result[dtype] = {"loss_rel": loss_rel, "grads": grads, "limits": lim, "cpu_s": cpu_s}
        bad = [k for k, v in loss_rel.items() if v > lim["loss_rel"]]
        bad += [n for n, v in grads.items()
                if v["cos"] < lim["cos"] or abs(v["norm_ratio"] - 1) > lim["norm_ratio"]]
        if bad:
            raise AssertionError(f"card step off the CPU step in {dtype}: {bad}: {result}")
    return result


def train_phase(torch, dev, b=8, patch=128, spp=8, ksize=21):
    """The flagship training step through the port's entry points;
    returns the phase record and the launches of the timed steps."""
    import numpy as np

    from wcmc_tpu_torch.data.batches import synthetic_batch
    from wcmc_tpu_torch.ops import _build
    from wcmc_tpu_torch.train.factory import init_interfaces

    n_warm, n_timed, n_prof = 3, 10, 2
    t0 = time.perf_counter()
    batch = synthetic_batch(np.random.default_rng(SEED), "kpcn", b, patch, spp, True)
    batch = {k: v.to(dev) for k, v in batch.items()}
    t_data = time.perf_counter() - t0
    cfg = train_config(kpcn_ksize=ksize)
    iface = init_interfaces(cfg, device=dev)[0]
    before = {n: [p.detach().clone() for p in m.parameters()]
              for n, m in iface.models.items()}
    iface.to_train_mode()
    losses = []

    def step():
        iface.preprocess(batch)
        ld = iface.train_batch(batch)
        losses.append(ld)

    for _ in range(n_warm):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    step_ms = []
    for _ in range(n_timed):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    launches, plain = dict(_build.launches), dict(_build.plain_calls)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    for name in TRAIN_KERNELS:
        if launches.get(name, 0) < 1:
            raise AssertionError(f"kernel {name} was not launched on the train step")
    if plain:
        raise AssertionError(f"plain versions ran on the train step: {plain}")
    trajectory = [{k: float(v) for k, v in ld.items()} for ld in losses]
    bad = [i for i, ld in enumerate(trajectory)
           if any(v != v or abs(v) == float("inf") for v in ld.values())]
    if bad:
        raise AssertionError(f"non-finite losses at steps {bad}")
    unchanged = [n for n, m in iface.models.items()
                 if all(torch.equal(p, q) for p, q in zip(m.parameters(), before[n]))]
    if unchanged:
        raise AssertionError(f"parameters did not change: {unchanged}")

    profiled = profile_steps(torch, iface, batch, n_prof)
    # the cross-check on the first two patches of the batch
    xbatch = {k: v[:2] for k, v in batch.items()}
    xcheck = cross_check(torch, iface, xbatch, dev)

    med = statistics.median(step_ms)
    record = {
        "phase": "train", "config": {"kpcn_ksize": cfg.kpcn_ksize, "batch": b,
                                     "patch": patch, "spp": spp, "manif_loss": "FMSE",
                                     "manif_pairing": cfg.manif_pairing,
                                     "compute_dtype": cfg.compute_dtype},
        "data_s": t_data, "step_ms": med, "step_ms_runs": step_ms,
        "mp_per_s": b * patch * patch / 1e6 / (med / 1e3),
        "launches_per_step": {k: v / n_timed for k, v in launches.items()},
        "plain_calls": plain, "peak_mem_gb": peak_gb,
        "loss_trajectory": trajectory, "profile": profiled, "cross_check": xcheck,
    }
    return record, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from wcmc_tpu_torch.ops import _build
    from wcmc_tpu_torch.ops import kernel_apply as ka
    from wcmc_tpu_torch.ops import pathnet_fused as pf

    t_start = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    info = _build.build()
    _build.library()
    emit({"phase": "build", "seconds": info["seconds"], "library": info["path"],
          "ptxas": parse_ptxas(info["ptxas"])})

    rows = kernel_phase(torch, ka, pf, dev)
    bwd_rows = backward_kernel_phase(torch, ka, pf, dev)
    emit({"phase": "kernels", "rows": rows + bwd_rows})

    with tempfile.TemporaryDirectory() as work:
        record, serve_launches = serve_phase(torch, dev, work)
    emit(record)
    record, train_launches = train_phase(torch, dev)
    emit(record)

    # launches: the serving kernels count one served frame, the backward
    # kernels the ten timed train steps, K3 its autograd drive
    for row in rows:
        name = row.pop("counter")
        row["launches"] = serve_launches[name]
        row["launches_by_path"] = {"serve_frame": serve_launches[name],
                                   "train_10_steps": train_launches.get(name, 0)}
    for row in bwd_rows:
        name = row.pop("counter")
        row["launches"] = (row.pop("autograd_launches") if name == "scatter_softmax"
                           else train_launches[name])
        row["launches_by_path"] = {"serve_frame": 0,
                                   "train_10_steps": train_launches.get(name, 0)}
    rows += bwd_rows
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
