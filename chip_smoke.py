#!/usr/bin/env python3
"""Drive the PyTorch port's serving paths, training steps and training
entry points from disk on one NVIDIA card and check them: KPCN with the
dual PathNet, LBMC (LayerNet) with the single PathNet, and SBMC
(Multisteps) with the single PathNet.

    python3 chip_smoke.py

Phases (one JSON line each):

1. device: the card's name and count, ``nvidia-smi`` name and power
   limit; exits non-zero without CUDA.
2. build: the hand-written kernels of ``wcmc_tpu_torch/ops/csrc``
   compiled from the repository's sources (``-Xptxas -v`` registers,
   shared memory and spills per kernel).
3. kernels: every kernel held against its plain PyTorch version on the
   same inputs at the shapes of each path that runs it, with CUDA-event
   times (median of repeats after warm-up, L2 flushed before each launch;
   ``ms``) and the median device time of the kernel's own entries in a
   torch.profiler pass over five more calls (``device_ms``, which leaves
   out any wait for the wrapper's host work), beside the least time the
   card could take (bytes over 3.35 TB/s or operations over the peak rate
   of their type, whichever is larger).
   KPCN (8 tiles or patches of 128 px, 8 spp, K = 21, both branches): K1
   (softmax gather), K4-fwd (PathNet embedding), K5-fwd (PathNet head;
   channels-last as served, with the leg without moments, and
   channel-major as the train step runs it), K2 (softmax-gather d
   logits), K3 (softmax-gather d buffer), K4-bwd and K5-bwd (each
   backward MLP also two launches compared bit for bit, their partials
   being summed in block order; every K5-fwd and K4-fwd row too, their
   moments and means summed in sample order, with the body that ran it
   and the host time of its weight pack; K4-fwd's tiled body also against
   its row-chunk body, bit for bit); K2 and K3 are first
   driven through ``torch.autograd.grad`` of
   ``kernel_gather_softmax`` with a buffer that requires grad (KPCN's
   buffers are data, so its step runs no K3); K2's tiled body also
   against its first body, bit for bit, K3's body (the banded one where it
   fits: LBMC's K = 13, not KPCN's K = 21) against its gather body, and
   each against itself over two launches, with the first body's times on
   the same inputs beside it.  LBMC (the same sizes):
   K10-fwd and K10-bwd (the fused per-pixel MLP, 32 -> 32 -> 32 -> 32,
   d(x) on; K10-bwd's tiled body also against its wmma body, d(x) bit for
   bit, and two launches bit for bit), K1, K2 and K3 at K = 13 on a
   layer's slice of the kernel head, and K4 and K5 forward and backward at
   the single PathNet's widths.  SBMC (the same sizes, K = 21): K7 (the splat of radiance and
   a ones channel, C = 4, over the 64 samples' f32 weights; its banded
   body also against its gather body, and two launches bit for bit), K4-fwd in
   Multisteps' form (95 -> 128 -> 128 -> 128, leaky relu) and K5-fwd in
   its update form ([128 | 128] -> 128 -> 128, leaky relu, bf16 output,
   with and without moments); and at the SBMC training shapes K8 (the
   splat's weight gradient, (64, 128, 128, 441) f32; its tiled body also
   against the first port's body and itself, bit for bit), K9 (the weighted
   gather, the splat's d(values)), K4-bwd in Multisteps' form (leaky relu,
   with d(x); also at 97 input channels, in slabs of 96) and K5-bwd in its
   update form (Cout 128, a bf16
   channels-last cotangent, with the ``gsum`` cotangent and without
   moments); K9, which the SBMC step does not run (its radiance is data),
   is driven through ``torch.autograd.grad`` of ``kernel_gather`` and of
   ``kernel_scatter`` with values that require grad.  The fused KPCN
   inference: K6 (the fused 5x5 convolution) at layers 1, 5 and 9 of the
   chain with paths (8 tiles of 128 px, n_in 39) and layer 1 without paths
   (8 tiles of 256 px, n_in 34), each with cuDNN's channels-last bf16
   ``F.conv2d`` + activation as ``library_ms`` and two launches compared
   bit for bit, and one branch's whole 9-layer chain, K6 against cuDNN.
4. serve, serve_lbmc, serve_sbmc: a synthetic 512x512, 8-spp scene is
   written, preprocessed on the card and denoised through
   ``wcmc_tpu_torch.test_models.main`` — the full-width KPCN (K 21,
   depth 9, width 100) + dual PathNet, the LayerNet (K 13, 2 layers,
   widths 96 / 32) + single PathNet, and Multisteps (95 input channels,
   K 21, 3 steps, width 128, exp splat) + single PathNet, in bf16 from
   seeded weights, 49 tiles in 7 batches of 8.  Each kernel of the path must
   have launched its count per batch and no plain version may have run,
   and the profiled frame's K5-fwd and K4-fwd entries must all be their
   tiled bodies' (SBMC's K7 entries its banded body's).
   One tile is checked against the same weights run on the CPU in bf16
   and in f32 (max error of each output, and relative L2 beside that of
   the reference moved by one pixel), and the frame is timed again in
   steady state (five runs, then one under ``torch.profiler`` for the
   device busy time and the host stages).  Then serve_kpcn_fused (the
   KPCN flagship with ``WCMC_FUSED_INFERENCE=1``: K6 18 times per batch),
   serve_kpcn_nopath and serve_kpcn_nopath_fused (KPCN without paths at
   its default 256-px tiles, 9 tiles in 2 batches, unfused and fused), the
   same way, the fused legs' CPU references fused too; and
   fused_vs_default, each fused frame beside its default one of this run.
5. train, train_lbmc, train_sbmc: the flagship training step of each
   (FMSE with roll pairing, bf16 compute, f32 parameters; Adam with value
   clip 1.0 for KPCN, with global-norm clip 250 for LBMC and 1000 for
   SBMC, whose Multisteps is the serving one) on a synthetic batch of 8
   patches of 128 px at 8 spp, through ``init_interfaces`` ->
   ``to_train_mode`` -> ``preprocess`` -> ``train_batch``: 3 warm-up
   steps, 10 timed steps (step ms, MP/s, peak memory, launches per step),
   2 more under ``torch.profiler``.  Each kernel of the step must launch
   its count per step, no plain version may run, K5-fwd's and K4-fwd's
   profiled entries must all be their tiled bodies' (SBMC's K7 and K8
   entries their banded and tiled bodies', LBMC's K10-bwd and K3 entries
   their tiled and banded bodies', KPCN's and LBMC's K2 entries its tiled
   body's), every loss must be
   finite and every model's parameters must change.  One step on the card
   is held against the same step (weights, batch, draws) on the CPU in
   bf16 and in f32, at the seeded initial weights (before the warm-up
   steps, on a copy of the models) and after the timed steps: the loss
   dict and each model's flattened gradient, each within a limit that
   scales with the CPU bf16 step's own distance from f32 at that state
   (``XCHECK``, ``xcheck_decision``).  The steps repeat bit for bit, and
   each record carries a digest of the weights its check starts from.

6. cli_corpus, train_cli_kpcn, train_cli_lbmc, train_cli_sbmc: the training
   entry points from disk, ``python -m wcmc_tpu_torch.train_kpcn`` (then
   ``train_lbmc``, ``train_sbmc``) through their ``main`` with a user's
   argv and ``--device`` the card.  One synthetic corpus (2 train scenes,
   1 val, 1 test; 512x512, 8 spp) is written and preprocessed on the card
   (LLPM, SBMC, KPCN caches and the importance maps).  KPCN runs the README
   flagship (K 21, batch 8, FMSE, ``--train_branches``,
   ``--patches_per_image 32``: 56 steps and 56 validation batches an epoch,
   the loaders spanning spp 2..8) for 2 epochs with the first one profiled
   (``--profile_dir``: device idle share and top entries), resumes from its
   latest checkpoint for a third (the restored parameters and Adam state
   bit for bit the first run's), and serves the best checkpoint through
   ``wcmc_tpu_torch.test_models``; LBMC and SBMC (their flagship widths,
   ``--patches_per_image 4``) one epoch of 7 steps and validation.  Each
   run: every kernel of the family's step launched at least once a step,
   no plain version, finite losses, the checkpoint files; the record holds
   each epoch's steps, seconds, loader wait share and median step ms, and
   peak memory.

7. train_kpcn_ref, train_kpcn_pre_a, train_kpcn_pre_b: the KPCN variants
   of ``train_kpcn.py`` (``--kpcn_ref``; ``--kpcn_pre`` with
   ``--manif_learn``, phase (a), the dual PathNet alone, and without it,
   phase (b), KPCN under the frozen PathNet) at the flagship widths, batch
   8, 128 px, 8 spp, bf16: 3 warm-up and 5 timed steps, each launching
   exactly its counts (``VARIANTS``) with no plain call, finite losses,
   only the trained models' parameters changed (the frozen ones bit for
   bit); the ref variant also serves one tile through its
   ``validate_batch`` (and ``_augment``) at its seeded initial weights,
   held against the CPU in bf16 and f32 to the served KPCN tile's limits.
8. multi_device: the parallel modes on the one card, a world of 2 ranks
   sharing cuda:0 over gloo (``parallel/launch.py``'s ``RankPool``): (i)
   the flagship KPCN + FMSE data-parallel step at global batch 8 (4 a rank)
   against the 1-rank step from the same weights, batch and draws, within
   ``XCHECK``'s limits scaled by the train phase's bf16 noise at the same
   weights, the replicas' checksums equal; (ii) the flagship KPCN on one
   512^2 8-spp frame in 2 bands with halo 32 against the unsharded
   forward's interior; (iii) the dual PathNet, LBMC and SBMC serving
   forwards at 8 spp split 4 + 4 against the unsharded ones (``MD_TOLS``);
   (iv) two data-parallel steps at world 1 over NCCL, bit for bit two 1-rank
   steps.  NCCL across cards is not covered (one card).

Then the kernel table (a row per kernel and path, its ``launches`` from
that path's run: per served frame for a forward kernel, per 10 train
steps for a backward one and for K8; K3 on the KPCN path and K9 from
their autograd drives), the card's ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``.  Any failed phase raises and the
script exits non-zero without that line; so does a run without CUDA, or
from a directory without the port's package.  TF32 is off throughout,
so the f32 reference products are full f32.
"""

from __future__ import annotations

import contextlib
import hashlib
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
# of max |plain|: K6's bf16 products summed in f32 in another order and
# rounded once; a sum on a rounding boundary can take the neighbouring
# bf16 value, one step being at most 2^-7 of a value
CONV_TOL = 8e-3
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
# the same for one served LBMC tile (radiance and p-buffer).  Measured on
# an H100 (NVIDIA H100 80GB HBM3, 700 W): bf16 6.1e-5 and 2.2e-3, f32
# 7.3e-5 and 8.0e-3 of max |ref| (refs 1.44 and 0.38); held to about 2.5x.
LBMC_SERVE_TOLS = {"bfloat16": 6e-3, "float32": 2e-2}
# the same for one served SBMC tile (radiance and p-buffer).  Measured on
# an H100 (NVIDIA H100 80GB HBM3, 700 W): bf16 3.5e-2 and 5.9e-3, f32
# 2.2e-2 and 1.1e-2 of max |ref| (refs 17.0 and 0.20): bf16 roundings in
# three U-Nets move the splat logits, and the standardization's gain of
# 10 amplifies them before exp (on the CPU, wcmc_tpu's own bf16 XLA and
# Pallas paths differ by 2e-2 to 3e-2 of max); held to about 2.5x.
SBMC_SERVE_TOLS = {"bfloat16": 9e-2, "float32": 5.5e-2}
# relative L2 over the whole served tile, the largest over its outputs
# (radiance and p-buffers), card against the CPU; each limit must stay
# under the relative L2 that the reference radiance moved by one pixel
# gives, so a shifted splat or crop fails.  Measured on an H100 (NVIDIA
# H100 80GB HBM3, 700 W), bf16 and f32: KPCN 1.5e-3 and 8.9e-3, LBMC
# 3.7e-4 and 2.9e-3, SBMC 1.4e-2 and 1.2e-2 (its radiance); the one-pixel
# shift gives 0.137, 0.040 and 0.51.  Held to about 2.5x.
SERVE_L2_TOLS = {"kpcn": {"bfloat16": 4e-3, "float32": 2.2e-2},
                 "lbmc": {"bfloat16": 1e-3, "float32": 7.5e-3},
                 "sbmc": {"bfloat16": 3.6e-2, "float32": 3e-2}}
# one bf16 train step on the card against the same step on the CPU in
# bf16 and in f32 (same weights, first two patches of the batch, same
# draws), at the seeded initial weights and after the timed steps.  Per
# model, with g_c, g_b and g_f the flattened gradients (card, CPU bf16,
# CPU f32) and n = |g_b - g_f| the CPU bf16 step's own distance from f32
# at that state, the step passes if |g_c - g_b| <= alpha n + beta |g_f|
# and |g_c - g_f| <= alpha_f32 n + beta |g_f|; each loss the same way,
# with |L_b - L_f| for n, |L_f| for |g_f| and beta_loss for beta
# (xcheck_decision).  The limits scale with the state's own bf16 noise, so
# they hold at every weight state (fixed limits read at one state did not:
# a kernel that sums in another order moves the weights the check starts
# from).  beta is a floor for a model or loss whose CPU bf16 step lies
# closer to f32 than the card's does.  Read on an H100 (NVIDIA H100 80GB
# HBM3, 700 W) with chip_xcheck.py at three states per family (the seeded
# initial weights, and after the train-phase steps with KPCN's K4-bwd chain
# on the row-chunk body and on the tiled one), each with both versions of
# the code: |g_c - g_b| / n at most 2.32 and
# |g_c - g_f| / n at most 2.60 (KPCN's backbone_diffuse at n = 0.0057 |g_f|,
# 1.32% and 1.48% of |g_f|), 1.51 and 1.35 elsewhere; losses within 5.4e-3
# of |L_f|.  Every reading is at most 1 / 2.56 of its limit.  Cosine and
# norm ratio stay in the record, for reading.
XCHECK = {"alpha": 3.5, "alpha_f32": 4.0, "beta": 0.015, "beta_loss": 1.5e-3}
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


def median_device_ms(events, kinds, calls, per_call=None):
    """The median over ``calls`` calls, made one after another, of the
    device time of each call's entries of ``kinds`` (``device_kind``):
    ``events`` the profiled window's device entries as (name, start us,
    duration us).  None where no entry of those kinds ran, or where their
    count does not divide evenly into the calls, or (with ``per_call``) is
    not ``per_call`` entries a call: a profile that lost entries."""
    mine = sorted((start, dur) for name, start, dur in events if device_kind(name) in kinds)
    if not mine or len(mine) % calls or (per_call and len(mine) != per_call * calls):
        return None
    per = len(mine) // calls
    return statistics.median(sum(d for _, d in mine[i:i + per])
                             for i in range(0, len(mine), per)) / 1e3


def device_ms(torch, fn, counter, flush, calls=5, per_call=None):
    """The median device time of one call of ``fn`` in the entries of the
    kernel whose launch counter is ``counter`` (any of its bodies:
    ``counter``, ``counter``_tiled and ``counter``_banded), from one torch.profiler pass over
    ``calls`` calls after a warm-up call, the L2 flushed before each and a
    synchronize after each (``per_call``: the entries a call must have,
    see ``median_device_ms``).  ``time_ms``'s CUDA events also count any
    wait for the wrapper's host work; this does not."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            fn()
            torch.cuda.synchronize()
    events = [(e.name, e.time_range.start, e.time_range.elapsed_us()) for e in prof.events()
              if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    return median_device_ms(events, (counter, counter + "_tiled", counter + "_banded"), calls,
                            per_call)


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


def kernel_row(name, counter, replaces, err, ms, plain_ms, bound, shape, **extra):
    """One row of the kernel table (``counter``: the launch counter whose
    main-path count becomes ``launches``)."""
    bms, by = bound
    return {"name": name, "route": "cuda", "source": f"wcmc_tpu_torch/ops/csrc/{name}.cu",
            "replaces": replaces, "counter": counter, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": None,
            **extra, "shape": shape}


def weight_bytes(ws):
    return sum(2 * w.numel() + 4 * w.shape[1] for w in ws)   # bf16 weights, f32 biases


def rand_mlp(torch, dev, g, dims):
    ws = [torch.randn((ci, co), device=dev, generator=g) / ci**0.5
          for ci, co in zip(dims[:-1], dims[1:])]
    bs = [0.1 * torch.randn(co, device=dev, generator=g) for co in dims[1:]]
    return ws, bs


def embed_fwd_row(torch, pf, dev, g, flush, b, s, hw, dims, acts=None):
    """K4-fwd at (B, S, HW) rows of ``dims`` (PathNet's activations unless
    ``acts``), against its plain version; on the tiled body also against
    the row-chunk body, bit for bit (both sum every layer from zero in k16
    steps and the mean in sample order), with the host time of its weight
    pack; two launches bit for bit.  Returns (the embedding, row)."""
    acts = acts or pf.EMBED_ACTS
    x = torch.randn((b, s, hw, dims[0]), device=dev, generator=g).to(torch.bfloat16)
    ws, bs = rand_mlp(torch, dev, g, dims)
    plan = pf.embed_fwd_plan(tuple(acts), *dims)

    def kernel():
        return pf.pathnet_embed(x, ws, bs, acts)

    e, mean = kernel()
    err = max_err(torch, [e, mean], list(pf._embed_plain(x, ws, bs, acts)), BF16_TOL)
    again = kernel()
    if not (torch.equal(again[0], e) and torch.equal(again[1], mean)):
        raise AssertionError("K4-fwd: a second launch gave other bits")
    del again
    extra = {"body": plan.form or "row_chunk", "bit_for_bit": True}
    if plan.tiled:
        rows_e, rows_mean = pf._embed_fwd_kernel(x, ws, bs, acts, rows=True)
        if not (torch.equal(rows_e, e) and torch.equal(rows_mean, mean)):
            raise AssertionError(
                f"K4-fwd's tiled body is not the row-chunk body's bits ({plan.form}): max "
                f"|diff| e {(rows_e.float() - e.float()).abs().max().item()}, mean "
                f"{(rows_mean - mean).abs().max().item()}")
        extra["rows_body_bit_for_bit"] = True
        extra["pack_ms"] = pack_ms(torch, lambda: pf.pack_embed_weights(ws, bs))
        del rows_e, rows_mean
    flops = 2 * b * s * hw * sum(ci * co for ci, co in zip(dims[:-1], dims[1:]))
    return e, kernel_row(
        "pathnet_embed", "pathnet_embed", "wcmc_tpu/ops/pathnet_fused.py:155", err,
        time_ms(torch, kernel, 20, flush),
        time_ms(torch, lambda: pf._embed_plain(x, ws, bs, acts), 3, flush),
        bound_ms(nbytes(x, e, mean) + weight_bytes(ws), [(flops, BF16_FLOPS)]),
        {"x": list(x.shape), "dims": list(dims), "acts": list(acts)},
        device_ms=device_ms(torch, kernel, "pathnet_embed", flush), **extra)


def head_fwd_leg(torch, pf, flush, e, ctx, hws, hbs, acts, moments, out_dtype, cmajor=False):
    """K5-fwd against its plain version: error, two launches bit for bit
    (each moment has one writer, summed in sample order), times and bound;
    and the kernel's output."""
    b, s, hw, ce = e.shape
    c1, cout = hws[1].shape

    def kernel():
        return pf.pathnet_head(e, ctx, hws, hbs, acts, moments, cmajor, out_dtype)

    def plain():
        return pf._head_plain(e, ctx, hws, hbs, acts, moments, cmajor, out_dtype)

    got, want = kernel(), plain()
    got, want = (list(got), list(want)) if moments else ([got], [want])
    err = max_err(torch, got, want, BF16_TOL)
    again = kernel()
    if not all(torch.equal(x, y) for x, y in zip(list(again) if moments else [again], got)):
        raise AssertionError("K5-fwd: a second launch gave other bits")
    del again
    # the context product is done once per pixel, not once per sample
    flops = 2 * b * s * hw * (ce * c1 + c1 * cout) + 2 * b * hw * ce * c1
    bms, by = bound_ms(nbytes(e, ctx, *got) + weight_bytes(hws), [(flops, BF16_FLOPS)])
    return {"max_abs_err": err, "ms": time_ms(torch, kernel, 20, flush),
            "device_ms": device_ms(torch, kernel, "pathnet_head", flush),
            "plain_ms": time_ms(torch, plain, 3, flush), "bound_ms": bms, "bound_by": by,
            "bit_for_bit": True}, got[0]


def pack_ms(torch, pack, repeats=5):
    """Host milliseconds of one weight pack, ``pack()`` (the median of
    ``repeats``, each ended by a synchronize): what a call pays whose
    weights are made afresh, as KPCN's merged head and embedding are on
    every call."""
    times = []
    for _ in range(repeats + 1):
        t0 = time.perf_counter()
        pack()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times[1:])


def head_fwd_row(torch, pf, dev, g, flush, e, c1, cout, moments, acts=None,
                 out_dtype=None, both_legs=False, cmajor=False):
    """K5-fwd over the embedding ``e`` and a context of its width, [C | C]
    -> c1 -> cout; channels-last (channel-major with ``cmajor``),
    PathNet's activations and an f32 output unless ``acts`` and
    ``out_dtype``.  With ``both_legs`` the row also carries the leg without
    moments, whose output must be the one with them, bit for bit.  Returns
    (the context, row)."""
    acts = acts or pf.HEAD_ACTS
    out_dtype = out_dtype or torch.float32
    b, s, hw, ce = e.shape
    ctx = torch.randn((b, hw, ce), device=dev, generator=g).to(torch.bfloat16)
    hws, hbs = rand_mlp(torch, dev, g, (2 * ce, c1, cout))
    plan = pf.head_fwd_plan(tuple(acts), ce, ce, c1, cout, out_dtype, cmajor)
    leg, out = head_fwd_leg(torch, pf, flush, e, ctx, hws, hbs, acts, moments, out_dtype, cmajor)
    extra = {"body": plan.form or "wmma", "bit_for_bit": True, "device_ms": leg["device_ms"]}
    if plan.tiled:
        extra["pack_ms"] = pack_ms(torch, lambda: pf.pack_head_weights(hws, hbs, acts, ce))
    if both_legs:
        extra["without_moments"], bare = head_fwd_leg(torch, pf, flush, e, ctx, hws, hbs, acts,
                                                       False, out_dtype, cmajor)
        if not torch.equal(bare, out):
            raise AssertionError("K5-fwd: the output without moments is not the one with them")
    return ctx, kernel_row(
        "pathnet_head", "pathnet_head", "wcmc_tpu/ops/pathnet_fused.py:457",
        leg["max_abs_err"], leg["ms"], leg["plain_ms"], (leg["bound_ms"], leg["bound_by"]),
        {"e": list(e.shape), "ctx": list(ctx.shape), "w1": [2 * ce, c1], "w2": [c1, cout],
         "acts": list(acts), "out_dtype": str(out_dtype).replace("torch.", ""),
         "moments": moments, "cmajor": cmajor}, **extra)


def embed_bwd_row(torch, pf, dev, g, flush, b, s, hw, dims, acts=None, compute_dx=False):
    """K4-bwd for cotangents of the embedding and of its mean (PathNet's
    activations unless ``acts``; d(x) with ``compute_dx``)."""
    acts = acts or pf.EMBED_ACTS
    x = torch.randn((b, s, hw, dims[0]), device=dev, generator=g).to(torch.bfloat16)
    ws, bs = rand_mlp(torch, dev, g, dims)
    ge = torch.randn((b, s, hw, dims[-1]), device=dev, generator=g).to(torch.bfloat16)
    gmean = torch.randn((b, hw, dims[-1]), device=dev, generator=g)

    def kernel():
        return pf.pathnet_embed_bwd(x, ge, gmean, ws, bs, acts, compute_dx)

    def plain():
        return pf._embed_bwd_plain(x, ge, gmean, ws, bs, acts, compute_dx)

    dx, dws, dbs = kernel()
    pdx, pws, pbs = plain()
    err = max_err(torch, dws + dbs, pws + pbs, BF16_TOL)
    # the partials are summed in block order: a second launch repeats bit for bit
    again = kernel()
    bit_for_bit = all(torch.equal(a, w) for a, w in zip(
        [*again[1], *again[2]] + ([again[0]] if compute_dx else []),
        [*dws, *dbs] + ([dx] if compute_dx else [])))
    if not bit_for_bit:
        raise AssertionError("K4-bwd: a second launch gave other bits")
    del again
    extra = {"bit_for_bit": bit_for_bit}
    if compute_dx:
        # d(x) per row: a recomputed pre-activation within rounding of zero
        # can take the other slope of its leaky relu
        extra["row_rel_l2"] = {"dx": rel_l2(torch, dx, pdx)}
        if extra["row_rel_l2"]["dx"] > ROW_L2_TOL:
            raise AssertionError(f"K4-bwd d(x) off by {extra['row_rel_l2']} (relative L2)")
        err = max(err, (dx.double() - pdx.double()).abs().max().item())
    c0, c1, c2, c3 = dims
    # recompute the hidden layers (and a non-linear output layer), then
    # dW2, g2, dW1, g1, dW0 and, with d(x), g1 . W0^T
    fwd = c0 * c1 + c1 * c2 + (c2 * c3 if acts[-1] != "linear" else 0)
    macs = b * s * hw * (fwd + 2 * c2 * c3 + 2 * c1 * c2 + (2 if compute_dx else 1) * c0 * c1)
    return kernel_row(
        "pathnet_embed_bwd", "pathnet_embed_bwd", "wcmc_tpu/ops/pathnet_fused.py:188", err,
        time_ms(torch, kernel, 10, flush), time_ms(torch, plain, 3, flush),
        bound_ms(nbytes(x, ge, gmean, dx, *dws, *dbs) + weight_bytes(ws),
                 [(2 * macs, BF16_FLOPS)]),
        {"x": list(x.shape), "ge": list(ge.shape), "gmean": list(gmean.shape),
         "dims": list(dims), "acts": list(acts), "compute_dx": compute_dx},
        library_note="no single PyTorch call computes a fused MLP's backward",
        device_ms=device_ms(torch, kernel, "pathnet_embed_bwd", flush), **extra)


def head_bwd_row(torch, pf, dev, g, flush, b, s, hw, ce, c1, cout, moments, cmajor,
                 acts=None, g_dtype=None, gsq=True):
    """K5-bwd for a per-sample cotangent of the output (channel-major
    with ``cmajor``; PathNet's activations and an f32 cotangent unless
    ``acts`` and ``g_dtype``) and, with ``moments``, of the sample sum
    and (with ``gsq``) of the sum of squares."""
    acts = acts or pf.HEAD_ACTS
    e = torch.randn((b, s, hw, ce), device=dev, generator=g).to(torch.bfloat16)
    ctx = torch.randn((b, hw, ce), device=dev, generator=g).to(torch.bfloat16)
    hws, hbs = rand_mlp(torch, dev, g, (2 * ce, c1, cout))
    gshape = (b, s, cout, hw) if cmajor else (b, s, hw, cout)
    gout = torch.randn(gshape, device=dev, generator=g).to(g_dtype or torch.float32)
    gsum = gsq_t = None
    if moments:
        gsum = torch.randn((b, hw, cout), device=dev, generator=g)
        if gsq:
            gsq_t = 0.1 * torch.randn((b, hw, cout), device=dev, generator=g)

    def kernel():
        return pf.pathnet_head_bwd(e, ctx, gout, gsum, gsq_t, hws, hbs, acts, cmajor=cmajor)

    def plain():
        return pf._head_bwd_plain(e, ctx, gout, gsum, gsq_t, hws, hbs, acts, cmajor=cmajor)

    de, dctx, dws, dbs = kernel()
    pde, pdctx, pws, pbs = plain()
    max_err(torch, dws + dbs, pws + pbs, BF16_TOL)
    # the partials are summed in block order: a second launch repeats bit for bit
    again = kernel()
    bit_for_bit = all(torch.equal(x, y) for x, y in zip(
        [again[0], again[1], *again[2], *again[3]], [de, dctx, *dws, *dbs]))
    if not bit_for_bit:
        raise AssertionError("K5-bwd: a second launch gave other bits")
    del again
    row_l2 = {"de": rel_l2(torch, de, pde), "dctx": rel_l2(torch, dctx, pdctx)}
    if max(row_l2.values()) > ROW_L2_TOL:
        raise AssertionError(f"K5-bwd per-row outputs off by {row_l2} (relative L2)")
    err = max((a.double() - w.double()).abs().max().item()
              for a, w in zip([de, dctx, *dws, *dbs], [pde, pdctx, *pws, *pbs]))
    # per row: recompute e.W1e and h1.W2, then dW2, g1, dW1e, de; per
    # pixel (the context is shared by the S samples): ctx.W1c, dW1c, dctx
    macs = b * s * hw * (3 * ce * c1 + 3 * c1 * cout) + b * hw * 3 * ce * c1
    return kernel_row(
        "pathnet_head_bwd", "pathnet_head_bwd", "wcmc_tpu/ops/pathnet_fused.py:511", err,
        time_ms(torch, kernel, 10, flush), time_ms(torch, plain, 3, flush),
        bound_ms(nbytes(e, ctx, gout, gsum, gsq_t, de, dctx, *dws, *dbs) + weight_bytes(hws),
                 [(2 * macs, BF16_FLOPS)]),
        {"e": list(e.shape), "ctx": list(ctx.shape), "g": list(gout.shape),
         "g_dtype": str(gout.dtype).replace("torch.", ""), "w1": [2 * ce, c1],
         "w2": [c1, cout], "acts": list(acts), "moments": moments,
         "gsq": gsq_t is not None},
        library_note="no single PyTorch call computes a fused MLP's backward", row_rel_l2=row_l2,
        bit_for_bit=bit_for_bit, device_ms=device_ms(torch, kernel, "pathnet_head_bwd", flush))


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
        bodies = gather_softmax_bodies(torch, ka, flush, buf, logits, k)
        taps = b * 72 * 72 * k * k
        # softmax ~5 f32 ops per tap (max, sub, exp, add, scale), 2 per channel
        bms, by = bound_ms(logits.element_size() * taps + nbytes(buf, out),
                           [(taps * (5 + 2 * 3), F32_FLOPS)])
        legs[leg] = {
            "max_abs_err": err,
            "ms": time_ms(torch, lambda: ka.kernel_gather_softmax(buf, logits, k), 20, flush),
            "device_ms": device_ms(torch, lambda: ka.kernel_gather_softmax(buf, logits, k),
                                   "gather_softmax", flush, per_call=1),
            "plain_ms": time_ms(torch, lambda: ka.gather_softmax_plain(buf, logits, k), 3,
                                flush),
            "bound_ms": bms, "bound_by": by, **bodies,
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

    # K4-fwd and K5-fwd: the dual PathNet, 36 -> 128 -> 128 -> 128 and,
    # with moments and the context in the compute dtype, [128 | 128] -> 256 -> 6
    e, row = embed_fwd_row(torch, pf, dev, g, flush, b, 8, 128 * 128, (36, 128, 128, 128))
    rows.append(row)
    rows.append(head_fwd_row(torch, pf, dev, g, flush, e, 256, 6, moments=True,
                             both_legs=True)[1])
    torch.cuda.synchronize()
    return rows


def rel_l2(torch, got, want):
    got, want = got.double(), want.double()
    return ((got - want).norm() / want.norm()).item()


def gather_softmax_bodies(torch, ka, flush, buf, lg, k):
    """K1's tiled body against its first body, bit for bit (each pixel's
    sums in the same order, the same fused multiply-adds), and against itself
    over two launches; with the first body's times on the same inputs."""
    got = ka.gather_softmax(buf, lg, k)
    ref = ka.gather_softmax(buf, lg, k, body="warp")
    if not torch.equal(got, ref):
        raise AssertionError(f"K1's tiled body is not the first body's bits: max |diff| "
                             f"{(got - ref).abs().max().item()}")
    if not torch.equal(ka.gather_softmax(buf, lg, k), got):
        raise AssertionError("K1: a second launch gave other bits")
    del got, ref

    def first():
        return ka.gather_softmax(buf, lg, k, body="warp")

    return {"body": "tiled", "bit_for_bit": True, "first_body_bit_for_bit": True,
            "first_body_ms": time_ms(torch, first, 20, flush),
            "first_body_device_ms": device_ms(torch, first, "gather_softmax", flush, per_call=1)}


def mlp_fused_bodies(torch, mf, flush, x, ws, bs, acts):
    """K10-fwd's tiled body against its wmma body, bit for bit (the same k16
    steps and rounding points), and against itself over two launches; with
    the wmma body's times on the same inputs."""
    got = mf.fused_mlp(x, ws, bs, acts)
    ref = mf._mlp_fwd_kernel(x, ws, bs, acts, body="wmma")
    if not torch.equal(got, ref):
        raise AssertionError(f"K10-fwd's tiled body is not the wmma body's bits: max |diff| "
                             f"{(got.float() - ref.float()).abs().max().item()}")
    if not torch.equal(mf.fused_mlp(x, ws, bs, acts), got):
        raise AssertionError("K10-fwd: a second launch gave other bits")
    del got, ref

    def first():
        return mf._mlp_fwd_kernel(x, ws, bs, acts, body="wmma")

    plan = mf.mlp_fwd_plan(x.shape[-1], tuple(w.shape[1] for w in ws), tuple(acts))
    return {"body": plan.body, "bit_for_bit": True, "wmma_bit_for_bit": True,
            "wmma_ms": time_ms(torch, first, 20, flush),
            "wmma_device_ms": device_ms(torch, first, "mlp_fused", flush, per_call=1)}


def outer_softmax_bodies(torch, ka, flush, cot, buf, lg, k):
    """K2's tiled body against its first body, bit for bit (each tap's sums
    in the same order, one rounding), and against itself over two launches;
    with the first body's times on the same inputs."""
    got = ka.outer_softmax(cot, buf, lg, k)
    ref = ka.outer_softmax(cot, buf, lg, k, body="warp")
    if not torch.equal(got, ref):
        raise AssertionError(f"K2's tiled body is not the first body's bits: max |diff| "
                             f"{(got.float() - ref.float()).abs().max().item()}")
    if not torch.equal(ka.outer_softmax(cot, buf, lg, k), got):
        raise AssertionError("K2: a second launch gave other bits")
    del got, ref

    def first():
        return ka.outer_softmax(cot, buf, lg, k, body="warp")

    return {"body": "tiled", "bit_for_bit": True, "first_body_bit_for_bit": True,
            "first_body_ms": time_ms(torch, first, 20, flush),
            "first_body_device_ms": device_ms(torch, first, "outer_softmax", flush, per_call=1)}


def scatter_softmax_bodies(torch, ka, flush, cot, lg, k):
    """K3 on its plan's body (the banded one where it fits) against its
    gather body within K1_TOL (the same f32 probabilities, d buf summed in
    another order) and against itself over two launches; with the gather
    body's times on the same inputs.  Both bodies are two launches a call."""
    from wcmc_tpu_torch.ops import _build

    b, h, w, c = cot.shape
    plan = ka.scatter_softmax_plan(b, h, w, c, k, lg.element_size(),
                                   _build.sm_count(cot.device.index or 0))
    got = ka.scatter_softmax(cot, lg, k)
    err = max_err(torch, [got], [ka.scatter_softmax(cot, lg, k, body="gather")], K1_TOL)
    if not torch.equal(ka.scatter_softmax(cot, lg, k), got):
        raise AssertionError("K3: a second launch gave other bits")
    del got

    def first():
        return ka.scatter_softmax(cot, lg, k, body="gather")

    return {"body": "banded" if plan.banded else "gather",
            "bands": [plan.rows, plan.cols, plan.bands, plan.tiles], "bit_for_bit": True,
            "gather_max_abs_err": err, "first_body_ms": time_ms(torch, first, 20, flush),
            "first_body_device_ms": device_ms(torch, first, "scatter_softmax", flush,
                                              per_call=2)}


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
        "device_ms": device_ms(torch, lambda: ka.outer_softmax(cot, buf, lg, k),
                               "outer_softmax", flush, per_call=1),
        "plain_ms": time_ms(torch, lambda: ka.outer_softmax_plain(cot, buf, lg, k), 3, flush),
        "bound_ms": bms2, "bound_by": by2, "library_ms": None,
        "library_note": "no single PyTorch call computes the softmax-gather VJP",
        "through_crop_ms": through_crop_ms,
        **outer_softmax_bodies(torch, ka, flush, cot, buf, lg, k),
        "shape": shape,
    })
    rows.append({
        "name": "scatter_softmax", "route": "cuda",
        "source": "wcmc_tpu_torch/ops/csrc/scatter_softmax.cu",
        "replaces": "wcmc_tpu/ops/pallas_kernels.py:297", "counter": "scatter_softmax",
        "max_abs_err": err3,
        "ms": time_ms(torch, lambda: ka.scatter_softmax(cot, lg, k), 20, flush),
        "device_ms": device_ms(torch, lambda: ka.scatter_softmax(cot, lg, k),
                               "scatter_softmax", flush, per_call=2),
        "plain_ms": time_ms(torch, lambda: ka.scatter_softmax_plain(cot, lg, k), 3, flush),
        "bound_ms": bms3, "bound_by": by3, "library_ms": None,
        "library_note": "no single PyTorch call computes the softmax-weighted splat",
        **scatter_softmax_bodies(torch, ka, flush, cot, lg, k),
        "launches_from": "torch.autograd.grad of kernel_gather_softmax with a buffer "
                         "that requires grad (kernel phase); the KPCN step's buffers are data",
        "autograd_launches": autograd_launches["scatter_softmax"],
        "shape": shape,
    })
    del conv_out, logits, lg, dconv, dlogits, out, data_out

    # K5-fwd as the KPCN step runs it: channel-major, with moments; its
    # launches are the train step's
    e = torch.randn((b, 8, 128 * 128, 128), device=dev, generator=g).to(torch.bfloat16)
    row = head_fwd_row(torch, pf, dev, g, flush, e, 256, 6, moments=True, cmajor=True)[1]
    rows.append(dict(row, train_launches=True))
    del e
    # K4-bwd and K5-bwd: the dual PathNet, the head with moments and a
    # channel-major cotangent
    rows.append(embed_bwd_row(torch, pf, dev, g, flush, b, 8, 128 * 128, (36, 128, 128, 128)))
    rows.append(head_bwd_row(torch, pf, dev, g, flush, b, 8, 128 * 128, 128, 256, 6,
                             moments=True, cmajor=True))
    torch.cuda.synchronize()
    return rows


def lbmc_kernel_phase(torch, ka, pf, mf, dev):
    """The kernels of the LBMC path at its shapes (8 tiles or patches of
    128 px at 8 spp) against their plain versions: K10-fwd and K10-bwd
    (1,048,576 rows, 32 -> 32 -> 32 -> 32 leaky, d(x) on); K1, K2 and K3
    at K = 13 on the second layer's slice of a channels-last kernel head,
    with a buffer that requires grad; K4 and K5, forward and backward, at
    the single PathNet's widths (36 -> 64 -> 64 -> 64; [64 | 64] -> 128
    -> 3, channels-last, no moments, a per-sample cotangent)."""
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    rows = []
    b, s, p = 8, 8, 128
    n, dims, acts = b * s * p * p, (32, 32, 32, 32), ("leaky_relu",) * 3
    mac = sum(ci * co for ci, co in zip(dims[:-1], dims[1:]))
    shape = {"x": [n, dims[0]], "dims": list(dims), "acts": list(acts)}
    note = "no single PyTorch call computes a fused MLP"

    # K10-fwd and K10-bwd
    x = torch.randn((n, dims[0]), device=dev, generator=g).to(torch.bfloat16)
    ws, bs = rand_mlp(torch, dev, g, dims)
    y = mf.fused_mlp(x, ws, bs, acts)
    err = max_err(torch, [y], [mf._mlp_fwd_plain(x, ws, bs, acts)], BF16_TOL)
    rows.append(kernel_row(
        "mlp_fused", "mlp_fused", "wcmc_tpu/ops/mlp_fused.py:165", err,
        time_ms(torch, lambda: mf.fused_mlp(x, ws, bs, acts), 20, flush),
        time_ms(torch, lambda: mf._mlp_fwd_plain(x, ws, bs, acts), 3, flush),
        bound_ms(nbytes(x, y) + weight_bytes(ws), [(2 * n * mac, BF16_FLOPS)]), shape,
        library_note=note,
        device_ms=device_ms(torch, lambda: mf.fused_mlp(x, ws, bs, acts), "mlp_fused", flush,
                            per_call=1),
        **mlp_fused_bodies(torch, mf, flush, x, ws, bs, acts)))
    cot = torch.randn((n, dims[-1]), device=dev, generator=g).to(torch.bfloat16)
    plan = mf.mlp_bwd_plan(dims[0], dims[1:], acts)
    dx, dws, dbs = mf.mlp_fused_bwd(x, cot, ws, bs, acts, True)
    pdx, pdws, pdbs = mf._mlp_bwd_plain(x, cot, ws, bs, acts, True)
    max_err(torch, dws + dbs, pdws + pdbs, BF16_TOL)
    # d(x) per row: a recomputed pre-activation within rounding of zero can
    # take the other slope of its leaky relu (1 or 0.01)
    row_l2 = {"dx": rel_l2(torch, dx, pdx)}
    if row_l2["dx"] > ROW_L2_TOL:
        raise AssertionError(f"K10-bwd d(x) off by {row_l2} (relative L2)")
    err = max((a.double() - w.double()).abs().max().item()
              for a, w in zip([dx, *dws, *dbs], [pdx, *pdws, *pdbs]))
    del pdx
    # the tiled body against the wmma body on the same inputs: d(x) bit for
    # bit (the same k16 steps and rounding points), dW and db within K1_TOL
    # (the same f32 products, rows summed in another order); and against
    # itself over two launches (partials summed in warp and block order)
    wdx, wdws, wdbs = mf.mlp_fused_bwd(x, cot, ws, bs, acts, True, body="wmma")
    if not torch.equal(dx, wdx):
        raise AssertionError(f"K10-bwd's tiled d(x) is not the wmma body's bits: max |diff| "
                             f"{(dx.float() - wdx.float()).abs().max().item()}")
    wmma_err = max_err(torch, dws + dbs, wdws + wdbs, K1_TOL)
    del wdx
    again = mf.mlp_fused_bwd(x, cot, ws, bs, acts, True)
    if not all(torch.equal(a, b) for a, b in zip([dx, *dws, *dbs],
                                                 [again[0], *again[1], *again[2]])):
        raise AssertionError("K10-bwd: a second launch gave other bits")
    del again
    # recompute the chain, then dW and the next cotangent (d(x) last) per layer
    rows.append(kernel_row(
        "mlp_fused_bwd", "mlp_fused_bwd", "wcmc_tpu/ops/mlp_fused.py:191", err,
        time_ms(torch, lambda: mf.mlp_fused_bwd(x, cot, ws, bs, acts, True), 20, flush),
        time_ms(torch, lambda: mf._mlp_bwd_plain(x, cot, ws, bs, acts, True), 3, flush),
        bound_ms(nbytes(x, cot, dx, *dws, *dbs) + weight_bytes(ws),
                 [(3 * 2 * n * mac, BF16_FLOPS)]),
        dict(shape, g=[n, dims[-1]], compute_dx=True),
        library_note="no single PyTorch call computes a fused MLP's backward",
        row_rel_l2=row_l2,
        device_ms=device_ms(torch, lambda: mf.mlp_fused_bwd(x, cot, ws, bs, acts, True),
                            "mlp_fused_bwd", flush, per_call=1),
        body=plan.body, bit_for_bit=True, wmma_dx_bit_for_bit=True, wmma_max_abs_err=wmma_err,
        wmma_ms=time_ms(torch, lambda: mf.mlp_fused_bwd(x, cot, ws, bs, acts, True,
                                                        body="wmma"), 20, flush),
        wmma_device_ms=device_ms(
            torch, lambda: mf.mlp_fused_bwd(x, cot, ws, bs, acts, True, body="wmma"),
            "mlp_fused_bwd", flush, per_call=1)))
    del x, y, cot, dx

    # K1, K2, K3 at K = 13: bf16 logits, the layer's slice of the kernel head
    k = 13
    k2 = k * k
    buf = torch.rand((b, p + k - 1, p + k - 1, 3), device=dev, generator=g)
    head = 2 * torch.randn((b, 2 * k2, p, p), device=dev, generator=g)
    head = head.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    head.requires_grad_()
    logits = head.permute(0, 2, 3, 1)[..., k2:]
    lg = logits.detach()
    out = ka.kernel_gather_softmax(buf, lg, k)
    err1 = max_err(torch, [out], [ka.gather_softmax_plain(buf, lg, k)], K1_TOL)
    cot = torch.randn((b, p, p, 3), device=dev, generator=g)
    src = buf.clone().requires_grad_()
    dbuf, dhead = torch.autograd.grad(ka.kernel_gather_softmax(src, logits, k), [src, head], cot)
    dlogits = dhead.permute(0, 2, 3, 1)[..., k2:]
    err2 = max_err(torch, [dlogits], [ka.outer_softmax_plain(cot, buf, lg, k)], K2_BF16_TOL)
    err3 = max_err(torch, [dbuf], [ka.scatter_softmax_plain(cot, lg, k)], K1_TOL)
    taps = b * p * p * k2
    shape = {"buf": list(buf.shape), "logits": [b, p, p, k2], "logits_dtype": "bfloat16",
             "logits_view": f"layer 1 of a channels-last ({b}, {2 * k2}, {p}, {p}) kernel head"}
    rows.append(kernel_row(
        "gather_softmax", "gather_softmax", "wcmc_tpu/ops/pallas_kernels.py:185", err1,
        time_ms(torch, lambda: ka.kernel_gather_softmax(buf, lg, k), 20, flush),
        time_ms(torch, lambda: ka.gather_softmax_plain(buf, lg, k), 3, flush),
        # softmax ~5 f32 ops per tap (max, sub, exp, add, scale), 2 per channel
        bound_ms(2 * taps + nbytes(buf, out), [(taps * (5 + 2 * 3), F32_FLOPS)]), shape,
        device_ms=device_ms(torch, lambda: ka.kernel_gather_softmax(buf, lg, k),
                            "gather_softmax", flush, per_call=1),
        **gather_softmax_bodies(torch, ka, flush, buf, lg, k)))
    rows.append(kernel_row(
        "outer_softmax", "outer_softmax", "wcmc_tpu/ops/pallas_kernels.py:410", err2,
        time_ms(torch, lambda: ka.outer_softmax(cot, buf, lg, k), 20, flush),
        time_ms(torch, lambda: ka.outer_softmax_plain(cot, buf, lg, k), 3, flush),
        bound_ms(2 * 2 * taps + nbytes(cot, buf), [(taps * (2 * 3 + 8), F32_FLOPS)]),
        dict(shape, g=[b, p, p, 3]),
        library_note="no single PyTorch call computes the softmax-gather VJP",
        device_ms=device_ms(torch, lambda: ka.outer_softmax(cot, buf, lg, k), "outer_softmax",
                            flush, per_call=1),
        **outer_softmax_bodies(torch, ka, flush, cot, buf, lg, k)))
    rows.append(kernel_row(
        "scatter_softmax", "scatter_softmax", "wcmc_tpu/ops/pallas_kernels.py:297", err3,
        time_ms(torch, lambda: ka.scatter_softmax(cot, lg, k), 20, flush),
        time_ms(torch, lambda: ka.scatter_softmax_plain(cot, lg, k), 3, flush),
        bound_ms(2 * taps + nbytes(cot, dbuf), [(taps * (3 + 2 * 3), F32_FLOPS)]),
        dict(shape, g=[b, p, p, 3]),
        library_note="no single PyTorch call computes the softmax-weighted splat",
        device_ms=device_ms(torch, lambda: ka.scatter_softmax(cot, lg, k), "scatter_softmax",
                            flush, per_call=2),
        **scatter_softmax_bodies(torch, ka, flush, cot, lg, k)))
    del head, logits, lg, dhead, dlogits, out, dbuf

    # K4 and K5 at the single PathNet's widths
    e, row = embed_fwd_row(torch, pf, dev, g, flush, b, s, p * p, (36, 64, 64, 64))
    rows.append(row)
    rows.append(head_fwd_row(torch, pf, dev, g, flush, e, 128, 3, moments=False)[1])
    del e
    rows.append(embed_bwd_row(torch, pf, dev, g, flush, b, s, p * p, (36, 64, 64, 64)))
    rows.append(head_bwd_row(torch, pf, dev, g, flush, b, s, p * p, 64, 128, 3,
                             moments=False, cmajor=False))
    torch.cuda.synchronize()
    return rows


def splat_row(torch, ka, flush, x, wt, k):
    """K7 on its plan's body (the banded one at the SBMC shapes) against
    its plain version and against the gather body, each within K1_TOL (the
    same f32 products summed in another order), and two launches bit for
    bit (the band partials are summed in band order); beside it the gather
    body's times on the same inputs."""
    plan = ka.splat_plan(*x.shape[1:], k, wt.is_contiguous())
    body, spans = ka.scatter_route(x, wt, k)
    out = ka.scatter(x, wt, k)
    err = max_err(torch, [out], [ka.scatter_plain(x, wt, k)], K1_TOL)
    gather_err = max_err(torch, [out], [ka.scatter(x, wt, k, body="gather")], K1_TOL)
    if not torch.equal(ka.scatter(x, wt, k), out):
        raise AssertionError("K7: a second launch gave other bits")
    return kernel_row(
        "scatter", "scatter", "wcmc_tpu/ops/pallas_kernels.py:297", err,
        time_ms(torch, lambda: ka.scatter(x, wt, k), 10, flush),
        time_ms(torch, lambda: ka.scatter_plain(x, wt, k), 3, flush),
        # each weight and value read once, the canvas written once; one
        # multiply-add per weight and channel
        bound_ms(nbytes(x, wt, out), [(2 * wt.numel() * x.shape[-1], F32_FLOPS)]),
        {"x": list(x.shape), "w": list(wt.shape), "out": list(out.shape)},
        library_note="no single PyTorch call computes the per-pixel-kernel splat",
        # the banded body is two launches a call: the bands, then their sums
        device_ms=device_ms(torch, lambda: ka.scatter(x, wt, k), "scatter", flush,
                            per_call=2 if body == "banded" else 1),
        body=body, spans=spans, bands=[plan.rows, plan.cols, plan.bands, plan.tiles],
        bit_for_bit=True, gather_max_abs_err=gather_err,
        gather_ms=time_ms(torch, lambda: ka.scatter(x, wt, k, body="gather"), 10, flush),
        gather_device_ms=device_ms(torch, lambda: ka.scatter(x, wt, k, body="gather"),
                                   "scatter", flush, per_call=1))


def outer_row(torch, ka, flush, x, gc, k, flops, shape):
    """K8 on its tiled body against its plain version within K1_TOL,
    against the first port's body bit for bit (each output the same f32
    chain of fused multiply-adds over the channels) and against itself over
    two launches; beside it the first body's times on the same inputs."""
    dw = ka.outer(x, gc, k)
    err = max_err(torch, [dw], [ka.outer_plain(x, gc, k)], K1_TOL)
    ref = ka.outer(x, gc, k, body="warp")
    if not torch.equal(ref, dw):
        raise AssertionError(f"K8's tiled body is not the first body's bits: max |diff| "
                             f"{(ref - dw).abs().max().item()}")
    del ref
    if not torch.equal(ka.outer(x, gc, k), dw):
        raise AssertionError("K8: a second launch gave other bits")
    bound = bound_ms(nbytes(x, gc, dw), flops)
    del dw
    return kernel_row(
        "outer", "outer", "wcmc_tpu/ops/pallas_kernels.py:379", err,
        time_ms(torch, lambda: ka.outer(x, gc, k), 10, flush),
        time_ms(torch, lambda: ka.outer_plain(x, gc, k), 3, flush), bound, shape,
        library_note="no single PyTorch call computes the per-pixel-kernel outer product",
        device_ms=device_ms(torch, lambda: ka.outer(x, gc, k), "outer", flush),
        body="tiled", bit_for_bit=True, warp_body_bit_for_bit=True,
        warp_ms=time_ms(torch, lambda: ka.outer(x, gc, k, body="warp"), 10, flush),
        warp_device_ms=device_ms(torch, lambda: ka.outer(x, gc, k, body="warp"), "outer",
                                 flush))


def sbmc_kernel_phase(torch, ka, pf, dev):
    """The kernels of the SBMC serving path at its shapes (8 tiles of 128
    px at 8 spp, K = 21) against their plain versions: K7 (the splat of
    radiance and a ones channel over the 64 samples' f32 weights), K4-fwd
    (95 -> 128 -> 128 -> 128, leaky relu) and K5-fwd ([128 | 128] -> 128
    -> 128, leaky relu, bf16 output; with moments as in steps 0 and 1, and
    without as in step 2)."""
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    rows = []
    b, s, p, k = 8, 8, 128, 21
    n = b * s

    # K7: f32 weights in (0, 1], as exp(logits - shift) gives them
    x = torch.cat([2 * torch.rand((n, p, p, 3), device=dev, generator=g),
                   torch.ones((n, p, p, 1), device=dev)], dim=-1)
    wt = torch.rand((n, p, p, k * k), device=dev, generator=g)
    rows.append(splat_row(torch, ka, flush, x, wt, k))
    del x, wt

    leaky = ("leaky_relu",) * 3
    e, row = embed_fwd_row(torch, pf, dev, g, flush, b, s, p * p, (95, 128, 128, 128), leaky)
    rows.append(row)
    rows.append(head_fwd_row(torch, pf, dev, g, flush, e, 128, 128, True, leaky[:2],
                             torch.bfloat16, both_legs=True)[1])
    torch.cuda.synchronize()
    return rows


def sbmc_train_kernel_phase(torch, ka, pf, dev):
    """The kernels of the SBMC training step at its shapes (8 patches of
    128 px at 8 spp, K = 21) against their plain versions: K8 (d weights
    of the splat of radiance and a ones channel), K9 (d values of that
    splat, the weighted gather of the canvas cotangent), K4-bwd in
    Multisteps' form (95 -> 128 -> 128 -> 128, leaky relu, with d(x)) and
    K5-bwd in its update form ([128 | 128] -> 128 -> 128, leaky relu, a
    bf16 channels-last cotangent; with ``gsum`` as in steps 0 and 1, and
    without moments as in step 2).  K9, which the step does not run (its
    radiance is data), is driven through ``torch.autograd.grad`` of
    ``kernel_gather`` and of ``kernel_scatter`` with values that require
    grad; those launches are K9's count.  Returns the rows and that count."""
    from wcmc_tpu_torch.ops import _build

    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    rows = []
    b, s, p, k = 8, 8, 128, 21
    n = b * s
    canvas = p + k - 1

    # the splat's inputs: f32 values (radiance and a ones channel) and
    # weights in (0, 1], as exp(logits - shift) gives them; the canvas
    # cotangent
    x = torch.cat([2 * torch.rand((n, p, p, 3), device=dev, generator=g),
                   torch.ones((n, p, p, 1), device=dev)], dim=-1)
    wt = torch.rand((n, p, p, k * k), device=dev, generator=g)
    gc = torch.randn((n, canvas, canvas, 4), device=dev, generator=g)
    # one multiply-add per weight and channel; every weight read (K9) or
    # written (K8) once, the values and the canvas once
    flops = [(2 * wt.numel() * x.shape[-1], F32_FLOPS)]
    shape = {"x": list(x.shape), "w": list(wt.shape), "canvas_g": list(gc.shape)}

    rows.append(outer_row(torch, ka, flush, x, gc, k, flops, shape))
    dx = ka.gather(gc, wt, k)
    err = max_err(torch, [dx], [ka.gather_plain(gc, wt, k)], K1_TOL)
    rows.append(kernel_row(
        "gather", "gather", "wcmc_tpu/ops/pallas_kernels.py:185", err,
        time_ms(torch, lambda: ka.gather(gc, wt, k), 10, flush),
        time_ms(torch, lambda: ka.gather_plain(gc, wt, k), 3, flush),
        bound_ms(nbytes(gc, wt, dx), flops), dict(shape, out=list(dx.shape)),
        library_note="no single PyTorch call computes the per-pixel-kernel weighted gather",
        device_ms=device_ms(torch, lambda: ka.gather(gc, wt, k), "gather", flush),
        launches_from="torch.autograd.grad of kernel_gather and of kernel_scatter with "
                      "values that require grad (this phase); the SBMC step's radiance is "
                      "data"))
    del dx

    # K9 through autograd: kernel_gather (K9 forward; K8 and K7 backward)
    # and the splat with values that require grad (K7; K9 and K8)
    _build.reset_counts()
    buf = gc.clone().requires_grad_()
    wg = wt.clone().requires_grad_()
    out = ka.kernel_gather(buf, wg, k)
    dbuf, dwg = torch.autograd.grad(out, [buf, wg], torch.ones_like(out))
    del out, dbuf, dwg
    xg = x.clone().requires_grad_()
    full = ka.kernel_scatter(xg, wg, k)
    dxg, dwg = torch.autograd.grad(full, [xg, wg], gc)
    torch.cuda.synchronize()
    autograd_launches, autograd_plain = dict(_build.launches), dict(_build.plain_calls)
    if autograd_launches != {"gather": 2, "outer": 2, "scatter": 2} or autograd_plain:
        raise AssertionError(f"autograd of kernel_gather and kernel_scatter launched "
                             f"{autograd_launches}, plain {autograd_plain}")
    max_err(torch, [dxg], [ka.gather_plain(gc, wt, k)], K1_TOL)
    rows[-1]["autograd_launches"] = autograd_launches["gather"]
    del x, wt, gc, buf, wg, xg, full, dxg, dwg

    leaky = ("leaky_relu",) * 3
    row = embed_bwd_row(torch, pf, dev, g, flush, b, s, p * p, (95, 128, 128, 128), leaky,
                        compute_dx=True)
    # the same form at 97 input channels (92 + an embedding 5 wide): slabs of 96
    wide = embed_bwd_row(torch, pf, dev, g, flush, b, s, p * p, (97, 128, 128, 128), leaky,
                         compute_dx=True)
    row["c0_97"] = {key: wide[key] for key in
                    ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                     "row_rel_l2", "bit_for_bit", "shape")}
    rows.append(row)
    row = head_bwd_row(torch, pf, dev, g, flush, b, s, p * p, 128, 128, 128, True, False,
                       leaky[:2], torch.bfloat16, gsq=False)
    last = head_bwd_row(torch, pf, dev, g, flush, b, s, p * p, 128, 128, 128, False, False,
                        leaky[:2], torch.bfloat16)
    row["without_moments"] = {key: last[key] for key in
                              ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                               "bound_by", "row_rel_l2")}
    rows.append(row)
    torch.cuda.synchronize()
    return rows


# the shapes of K6 per branch and batch of 8 tiles on the fused KPCN
# serving paths: 9 layers of 5x5, n_in -> 100 -> ... -> 100 -> 441, relu
# between them; with paths (n_in 39) on 128-px tiles, without (n_in 34)
# on 256-px tiles
def conv_chain(n_in, tile, depth=9, width=100, logits=441, k=5):
    """[(input (B, H, W, Cin), Cout, activation)] of one fused chain."""
    layers, h, cin = [], tile, n_in
    for i in range(depth):
        last = i == depth - 1
        layers.append(((8, h, h, cin), logits if last else width, None if last else "relu"))
        h, cin = h - k + 1, width
    return layers


def conv_flops_bytes(xshape, cout, k=5):
    """K6's operations (2 per multiply-add of the VALID convolution) and
    bytes (bf16 x and y once, the weights in bf16 and the f32 bias once)
    for an input of ``xshape`` (B, H, W, Cin)."""
    b, h, w, cin = xshape
    ho, wo = h - k + 1, w - k + 1
    return (2 * b * ho * wo * k * k * cin * cout,
            2 * (b * h * w * cin + b * ho * wo * cout + k * k * cin * cout) + 4 * cout)


def conv_kernel_phase(torch, dev):
    """K6 (the fused convolution) at the fused KPCN serving shapes against
    its plain version: layer 1, a middle layer and layer 9 of the chain
    with paths (128-px tiles), and layer 1 without paths (256-px tiles),
    each in the layouts of the fused chain (a hidden layer written at the
    padded pixel pitch of ``conv5.conv2d_padded`` and read so by the
    next; layer 1's input padded to 40 channels inside the timed call);
    each row with cuDNN's channels-last bf16 ``F.conv2d`` + the in-place
    activation (``library_ms``), two launches compared bit for bit, and
    on the first row the whole 9-layer chain of one branch (K6 against
    cuDNN).  Returns the kernel table's rows (without launches)."""
    import torch.nn.functional as F

    from wcmc_tpu_torch.ops import conv5

    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    in_place = {"relu": torch.relu_, None: lambda y: y}

    def case(xshape, cout):
        x = torch.randn(xshape, device=dev, generator=g).to(torch.bfloat16)
        w = torch.randn((5, 5, xshape[-1], cout), device=dev, generator=g)
        w = w / (25 * xshape[-1]) ** 0.5
        bias = 0.1 * torch.randn(cout, device=dev, generator=g)
        # cuDNN's operands: a channels-last NCHW view of x, OIHW bf16
        # weights in channels-last memory, the bias in bf16
        lib = (x.permute(0, 3, 1, 2),
               w.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
                   memory_format=torch.channels_last), bias.to(torch.bfloat16))
        return x, w, bias, lib

    def library(lib, act):
        return in_place[act](F.conv2d(*lib))

    def layer(act):
        # the chain's route: hidden layers padded, the logits contiguous
        return conv5.conv2d_padded if act else conv5.conv2d

    rows = []
    with_paths, no_paths = conv_chain(39, 128), conv_chain(34, 256)
    for name, (xshape, cout, act) in (("layer 1", with_paths[0]), ("layer 5", with_paths[4]),
                                      ("layer 9", with_paths[8]),
                                      ("layer 1, no paths", no_paths[0])):
        x, w, bias, lib = case(xshape, cout)
        if not name.startswith("layer 1"):
            # a hidden layer's input: the chain hands it over at the padded pitch
            x = conv5._pitched(x, conv5.padded_pitch(xshape[-1]), fill=0)
        conv = layer(act)
        y = conv(x, w, bias, 5, act)
        err = max_err(torch, [y], [conv5.conv2d_plain(x, w, bias, 5, act)], CONV_TOL)
        if not torch.equal(conv(x, w, bias, 5, act), y):
            raise AssertionError(f"K6 {name}: two launches gave different bits")
        lib_y = library(lib, act).permute(0, 2, 3, 1)
        flops, n_bytes = conv_flops_bytes(xshape, cout)
        rows.append(kernel_row(
            "conv5", "conv5", "wcmc_tpu/ops/conv5.py:137", err,
            time_ms(torch, lambda: conv(x, w, bias, 5, act), 20, flush),
            time_ms(torch, lambda: conv5.conv2d_plain(x, w, bias, 5, act), 3, flush),
            bound_ms(n_bytes, [(flops, BF16_FLOPS)]),
            {"layer": name, "x": list(x.shape), "x_stride": list(x.stride()),
             "w": list(w.shape), "act": act, "out": list(y.shape),
             "out_stride": list(y.stride())},
            library_ms=time_ms(torch, lambda: library(lib, act), 20, flush),
            library_call="F.conv2d(x, w, b) in bf16, channels-last, then the in-place "
                         "activation (cuDNN)",
            library_max_abs_err=(lib_y.double() - y.double()).abs().max().item(),
            bitwise_repeat=True,
            device_ms=device_ms(torch, lambda: conv(x, w, bias, 5, act), "conv5", flush)))
        del x, w, bias, lib, y, lib_y

    # one branch's whole chain per batch of 8 tiles (with paths): K6
    # layer by layer against cuDNN layer by layer on the same weights
    cases = [case(xshape, cout) + (act,) for xshape, cout, act in with_paths]
    x0 = cases[0][0]

    def chain_k6():
        h = x0
        for _, w, bias, _, act in cases:
            h = layer(act)(h, w, bias, 5, act)
        return h

    def chain_library():
        h = x0.permute(0, 3, 1, 2)
        for _, _, _, (_, wl, bl), act in cases:
            h = in_place[act](F.conv2d(h, wl, bl))
        return h

    out = chain_k6()
    flops, n_bytes = (sum(v) for v in zip(*(conv_flops_bytes(xs, co)
                                            for xs, co, _ in with_paths)))
    bms, by = bound_ms(n_bytes, [(flops, BF16_FLOPS)])
    rows[0]["branch_chain"] = {
        "layers": len(cases), "out": list(out.shape), "flops": flops, "bytes": n_bytes,
        "ms": time_ms(torch, chain_k6, 10, flush),
        "device_ms": device_ms(torch, chain_k6, "conv5", flush),
        "library_ms": time_ms(torch, chain_library, 10, flush),
        "bound_ms": bms, "bound_by": by}
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
    by_kind = {}
    for e in device:
        kind = device_kind(e.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + e.self_device_time_total / 1e3
    return {
        "wall_ms_profiled": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "host_stage_ms": {e.key: e.cpu_time_total / 1e3 for e in events
                          if e.key.startswith("inference.")
                          and e.device_type == DeviceType.CPU},
        "device_ms_by_kind": by_kind,
        "top_device": [{"name": e.key[:90], "ms": e.self_device_time_total / 1e3,
                        "count": e.count} for e in top],
    }


def check_head_body(kinds, where):
    """Every K5-fwd form a path runs is a tiled form: the profile's device
    entries of K5-fwd must be the tiled body's (``pathnet_head_tiled``),
    none the wmma body's (``pathnet_head``)."""
    if kinds.get("pathnet_head", 0.0) > 0 or kinds.get("pathnet_head_tiled", 0.0) <= 0:
        raise AssertionError(f"{where}: K5-fwd's device ms by body "
                             f"{ {k: v for k, v in kinds.items() if k.startswith('pathnet_head')} }, "
                             "not the tiled body alone")


def check_embed_body(kinds, where):
    """Every K4-fwd form a path runs is a tiled form: the profile's device
    entries of K4-fwd must be the tiled body's (``pathnet_embed_tiled``),
    none the row-chunk body's (``pathnet_embed``)."""
    if kinds.get("pathnet_embed", 0.0) > 0 or kinds.get("pathnet_embed_tiled", 0.0) <= 0:
        raise AssertionError(f"{where}: K4-fwd's device ms by body "
                             f"{ {k: v for k, v in kinds.items() if k.startswith('pathnet_embed')} }, "
                             "not the tiled body alone")


# the body each redesigned kernel must run on every path, by launch counter
# (K7 and K8 on the SBMC paths, K10-bwd and K3 on LBMC's step, K2 on KPCN's
# and LBMC's, K1 on every KPCN and LBMC path, K10-fwd on LBMC's), where the
# first body files under the counter's own name
REDESIGNED_BODIES = {"scatter": "scatter_banded", "outer": "outer_tiled",
                     "mlp_fused_bwd": "mlp_fused_bwd_tiled",
                     "outer_softmax": "outer_softmax_tiled",
                     "scatter_softmax": "scatter_softmax_banded",
                     "gather_softmax": "gather_softmax_tiled",
                     "mlp_fused": "mlp_fused_tiled"}


def check_redesigned_body(kinds, where, counters):
    """K7, K8, K10-bwd, K2, K3, K1 and K10-fwd run their redesigned bodies on the paths:
    for each launch counter of ``counters`` the profile's device entries
    must be its new body's (``REDESIGNED_BODIES``), none its first body's."""
    for counter in counters:
        new = REDESIGNED_BODIES[counter]
        if kinds.get(counter, 0.0) > 0 or kinds.get(new, 0.0) <= 0:
            raise AssertionError(f"{where}: {counter}'s device ms by body "
                                 f"{ {k: kinds.get(k, 0.0) for k in (counter, new)} }, "
                                 f"not the {new} body alone")


def device_kind(name):
    """The group of a device entry in a profile: a hand kernel by the
    name of its launch counter (the bodies that two kernels share, K1 and
    K9, K2 and K8, K3 and K7, told apart by their softmax template
    argument; ``reduce_parts``, the second launch of the backward
    kernels; K4-bwd's and K5-bwd's two bodies each; K5-fwd's two bodies
    apart, ``pathnet_head_tiled`` and the wmma body ``pathnet_head``, and
    K4-fwd's, ``pathnet_embed_tiled`` and the row-chunk body
    ``pathnet_embed``; K7's banded body and its band sums,
    ``scatter_banded``, apart from its gather body ``scatter``, K8's
    tiled body, ``outer_tiled``, apart from the first one ``outer``,
    K10-bwd's tiled body, ``mlp_fused_bwd_tiled``, apart from its wmma body
    ``mlp_fused_bwd``, K2's tiled body, ``outer_softmax_tiled``, apart from
    its first one ``outer_softmax``, K3's banded body and its band sums,
    ``scatter_softmax_banded``, apart from its gather body and statistics
    ``scatter_softmax``, K1's tiled body, ``gather_softmax_tiled``, apart
    from its first one ``gather_softmax``, and K10-fwd's tiled body,
    ``mlp_fused_tiled``, apart from its wmma body ``mlp_fused``), the
    library convolutions and products, copies, or the rest (PyTorch's
    elementwise, reduction and copy kernels)."""
    m = re.search(r"wcmc::(\w+)", name)
    if m:
        kind = m.group(1).removesuffix("_kernel")
        if kind == "softmax_stats":
            return "scatter_softmax"
        if kind in ("splat_banded", "splat_band_sum"):
            return "scatter_banded"
        if kind == "scatter_softmax_band_sum":
            return "scatter_softmax_banded"
        for body in ("pathnet_head_bwd", "pathnet_embed_bwd"):
            if kind.startswith(body):
                return body
        if kind in ("gather", "outer", "splat_gather"):
            kind = "scatter" if kind == "splat_gather" else kind
            if re.search(r"wcmc::\w+<[^>]*\btrue>", name):
                kind += "_softmax"
        return kind
    if "Memcpy" in name or "Memset" in name:
        return "memcpy"
    if any(t in name for t in ("xmma", "cutlass", "cudnn", "nhwc", "gemm", "Padding")):
        return "cudnn_cublas"
    return "pytorch_other"


# How each served model is driven and checked: its name and flags on the
# entry point, its caches, the kernel launches per batch of 8 tiles (K1
# twice: once per KPCN branch, once per LBMC layer; SBMC's K4-fwd once for
# the PathNet and once for Multisteps, K5-fwd once for the PathNet and
# once per Multisteps step), the CPU config of the tile check and the
# tile's limits (of max |ref|; the bf16 card path against the port's bf16
# CPU path, whose parity with wcmc_tpu in bf16 is a CPU test, and against
# its f32 CPU path).  KPCN measured on an H100: at most 1.0e-3 and 3.2e-3
# absolute over refs of 0.24 to 1.68, so under 4.3e-3 and 1.4e-2 of max
# |ref|.  LBMC and SBMC: see LBMC_SERVE_TOLS and SBMC_SERVE_TOLS.
SERVE = {
    "kpcn": {"model_name": "KPCN_smoke", "preprocess": {"test_spps": (8,)},
             "launches": {"gather_softmax": 2, "pathnet_embed": 1, "pathnet_head": 1},
             "cpu_config": {"base_model": "kpcn", "kpcn_ksize": 21, "use_llpm_buf": True},
             "tols": {"bfloat16": SERVE_BF16_TOL, "float32": SERVE_F32_TOL},
             "l2_tols": SERVE_L2_TOLS["kpcn"]},
    "lbmc": {"model_name": "LBMC_smoke", "preprocess": {"sbmc": True, "kpcn": False},
             "launches": {"mlp_fused": 1, "gather_softmax": 2, "pathnet_embed": 1,
                          "pathnet_head": 1},
             "cpu_config": {"base_model": "lbmc", "use_llpm_buf": True},
             "tols": LBMC_SERVE_TOLS,
             "l2_tols": SERVE_L2_TOLS["lbmc"]},
    "sbmc": {"model_name": "SBMC_smoke", "args": ["--use_sbmc_buf"],
             "preprocess": {"sbmc": True, "kpcn": False},
             "launches": {"pathnet_embed": 2, "pathnet_head": 4, "scatter": 1},
             "cpu_config": {"base_model": "sbmc", "use_llpm_buf": True},
             "tols": SBMC_SERVE_TOLS,
             "l2_tols": SERVE_L2_TOLS["sbmc"]},
}
# The opt-in fused KPCN inference (WCMC_FUSED_INFERENCE=1: each chain's 9
# convolutions through K6, 18 launches per batch) beside the default: the
# flagship with paths, held to KPCN's limits, and KPCN without paths at
# its default 256-px tiles (n_in 34; 9 tiles of the 512^2 frame, 2
# batches), unfused and fused.  The fused legs' CPU references are fused
# the same way.  Without paths, measured on an H100 (NVIDIA H100 80GB
# HBM3, 700 W), unfused and fused: bf16 1.1e-3 and 1.7e-3, f32 3.4e-3 and
# 3.3e-3 of max |ref| (ref 3.3), relative L2 bf16 3.6e-5 and 4.1e-5, f32
# 5.8e-5 and 5.9e-5 (the one-pixel shift gives 0.13); held to about 3x.
FUSED = {"WCMC_FUSED_INFERENCE": "1"}
NOPATH = {"model_name": "KPCN_nopath_smoke", "family": "kpcn", "llpm": False, "tile": 256,
          "preprocess": {"test_spps": (8,)}, "launches": {"gather_softmax": 2},
          "cpu_config": {"base_model": "kpcn", "kpcn_ksize": 21, "use_llpm_buf": False},
          "tols": {"bfloat16": 5e-3, "float32": 1e-2},
          "l2_tols": {"bfloat16": 1.5e-4, "float32": 2e-4}}
SERVE["kpcn_fused"] = dict(SERVE["kpcn"], family="kpcn", env=FUSED,
                           launches=dict(SERVE["kpcn"]["launches"], conv5=18))
SERVE["kpcn_nopath"] = NOPATH
SERVE["kpcn_nopath_fused"] = dict(NOPATH, env=FUSED,
                                  launches=dict(NOPATH["launches"], conv5=18))


@contextlib.contextmanager
def environment(values):
    """Set the environment variables ``values`` for the block, and restore
    each one's earlier state after it, whatever happens inside."""
    before = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def p_buffer_list(p):
    """KPCN's two p-buffers (diffuse, specular), the sample-space one, or
    none (KPCN without paths)."""
    if p is None:
        return []
    return [p["diffuse"], p["specular"]] if isinstance(p, dict) else [p]


def serve_phase(torch, dev, work, name, size=512):
    """The serving path ``name`` (a key of ``SERVE``) through the port's
    entry point, on a synthetic ``size`` x ``size`` 8-spp frame (written and
    preprocessed once per model family); returns the phase record and the
    launch counts of the served frame."""
    from wcmc_tpu_torch import convert, evaluate, test_models
    from wcmc_tpu_torch.data.dataset import offline_preprocess
    from wcmc_tpu_torch.data.full_image import FullImageDataset
    from wcmc_tpu_torch.data.synthetic import build_synthetic_dataset
    from wcmc_tpu_torch.ops import _build
    from wcmc_tpu_torch.train.factory import TrainConfig, init_interfaces

    spec = SERVE[name]
    family = spec.get("family", name)
    llpm = spec.get("llpm", True)
    root = os.path.join(work, family)
    torch.cuda.reset_peak_memory_stats()
    t_data = t_pre = 0.0
    if not os.path.isdir(root):
        t0 = time.perf_counter()
        build_synthetic_dataset(root, n_train=0, n_val=0, n_test=1, size=size, spp=8,
                                test_extra_parts=0, seed=SEED)
        t_data = time.perf_counter() - t0
        t0 = time.perf_counter()
        offline_preprocess(root, mode="test", spp=8, device=dev, **spec["preprocess"])
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
    fn = os.path.join(root, "test", "input", "scene0.npy")
    # the tiling denoise picks: 128-px tiles, 256 for KPCN without paths
    ds = FullImageDataset(fn, 8, family, use_llpm_buf=llpm, tile_h=spec.get("tile"),
                          tile_w=spec.get("tile"))
    n_batches = -(-len(ds) // 8)

    args = test_models.parse_args([
        "--model_name", spec["model_name"], "--save", os.path.join(work, "weights"),
        "--data_dir", root, "--spps", "8", *(["--use_llpm_buf"] if llpm else []),
        *spec.get("args", ()), "--output_dir", os.path.join(root, "eval_" + name),
        "--device", str(dev), "--seed", str(SEED)])
    with environment(spec.get("env", {})):
        _build.reset_counts()
        results, iface = test_models.main(args)
        torch.cuda.synchronize()
        launches, plain = dict(_build.launches), dict(_build.plain_calls)
        want = {k: n_batches * v for k, v in spec["launches"].items()}
        if launches != want:
            raise AssertionError(f"the {name} serving path launched {launches}, not {want}")
        if plain:
            raise AssertionError(f"plain versions ran on the {name} serving path: {plain}")
        res = results[("scene0", 8)]["output"]
        bad = [k for k, v in res.items() if v != v or abs(v) == float("inf")]
        if bad:
            raise AssertionError(f"non-finite metrics: {bad}")
        if not os.path.isfile(os.path.join(root, "eval_" + name, "results_8.csv")):
            raise AssertionError("denoise wrote no CSV")

        # steady state: the same frame again, five times
        secs = []
        for _ in range(5):
            out_rad, out_path, dt = evaluate.inference(iface, ds, batch_size=8)
            secs.append(dt)
        if out_rad.shape != (size, size, 3) or not bool(torch.isfinite(
                torch.from_numpy(out_rad)).all()):
            raise AssertionError(f"bad frame {out_rad.shape}")
        if (out_path is None) == llpm:
            raise AssertionError(f"p-buffers {type(out_path)} with use_llpm_buf={llpm}")
        for v in p_buffer_list(out_path):
            if v.shape != (8, size, size, 3):
                raise AssertionError(f"bad p-buffer {v.shape}")

        profiled = profile_frame(torch, evaluate, iface, ds)
        if "pathnet_head" in spec["launches"]:
            check_head_body(profiled["device_ms_by_kind"], name)
        if "pathnet_embed" in spec["launches"]:
            check_embed_body(profiled["device_ms_by_kind"], name)
        check_redesigned_body(profiled["device_ms_by_kind"], name,
                              [k for k in REDESIGNED_BODIES if k in spec["launches"]])

        # one tile against the same weights on the CPU (plain versions), in
        # bf16 and in f32; errors and max |ref| of the radiance and p-buffers
        tile = {k: v[None] for k, v in ds[0][0].items()}
        card_rad, card_p = iface.validate_batch(tile)
        card = [card_rad.cpu()] + [t.cpu() for t in p_buffer_list(card_p)]
        tile_check = {}
        for dtype, tol in spec["tols"].items():
            ref_if = init_interfaces(TrainConfig(compute_dtype=dtype, **spec["cpu_config"]),
                                     device="cpu")[0]
            for model, m in iface.models.items():
                convert.load_flax_params(ref_if.models[model], convert.to_flax(m))
            t0 = time.perf_counter()
            ref_rad, ref_p = ref_if.validate_batch(tile)
            refs, pairs = [ref_rad] + p_buffer_list(ref_p), []
            err = max_err(torch, card, refs, tol, pairs)
            # the whole tile by relative L2, beside the same measure of the
            # reference radiance moved by one pixel (what an off-by-one crop
            # would give): a limit under that shift's error catches it
            l2 = [rel_l2(torch, c, r) for c, r in zip(card, refs)]
            shift_l2 = rel_l2(torch, torch.roll(refs[0], 1, dims=-2), refs[0])
            l2_tol = spec["l2_tols"][dtype]
            tile_check[dtype] = {"max_abs_err": err, "radiance_and_p_buffers": pairs,
                                 "tol": tol, "rel_l2": l2, "l2_tol": l2_tol,
                                 "shift1_rel_l2": shift_l2,
                                 "cpu_s": time.perf_counter() - t0}
    bad = {d: v for d, v in tile_check.items()
           if max(v["rel_l2"]) > v["l2_tol"] or v["l2_tol"] >= v["shift1_rel_l2"]}
    if bad:
        raise AssertionError(f"{name} tile off the CPU path by relative L2: {bad}")

    frame_ms = 1e3 * statistics.median(secs)
    record = {
        "phase": "serve" if name == "kpcn" else f"serve_{name}",
        "model": str(iface.models["dncnn"]), "env": spec.get("env", {}),
        "frame": [size, size], "spp": 8, "tile": spec.get("tile") or 128,
        "tiles": len(ds), "batches": n_batches, "data_s": t_data, "preprocess_s": t_pre,
        "first_frame_ms": 1e3 * res["inference_sec"], "frame_ms": frame_ms,
        "frame_ms_runs": [1e3 * t for t in secs],
        "mp_per_s": size * size / 1e6 / (frame_ms / 1e3),
        "launches": launches, "plain_calls": plain,
        "linear_RelMSE": res["linear_RelMSE"], "tile_vs_cpu": tile_check,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
        "profile": profiled,
    }
    return record, launches


def fused_vs_default(records):
    """The fused legs beside the default ones of the same run: frame ms,
    device busy ms and the device ms of the chains' convolutions (cuDNN
    and the rest of the library calls unfused, K6 fused)."""
    out = {}
    for default, fused in (("kpcn", "kpcn_fused"), ("kpcn_nopath", "kpcn_nopath_fused")):
        legs = {}
        for leg, name in (("default", default), ("fused", fused)):
            r = records[name]
            kinds = r["profile"]["device_ms_by_kind"]
            legs[leg] = {"frame_ms": r["frame_ms"],
                         "device_busy_ms": r["profile"]["device_busy_ms"],
                         "cudnn_cublas_ms": kinds.get("cudnn_cublas", 0.0),
                         "conv5_ms": kinds.get("conv5", 0.0)}
        legs["fused_over_default"] = {k: legs["fused"][k] / legs["default"][k]
                                      for k in ("frame_ms", "device_busy_ms")}
        out[default] = legs
    return out


def train_config(family, **kw):
    """The flagship training config of ``family``: the PathNet, FMSE with
    roll pairing (non-local), w_manif 0.1, lr 1e-4 for each model, bf16
    compute over f32 parameters; KPCN with 21x21 kernels and value clip
    1.0, LBMC (LayerNet k13) with global-norm clip 250, SBMC (Multisteps
    k21, 3 steps, width 128, exp splat, 95 input channels) with
    global-norm clip 1000 and the tonemapped relative MSE."""
    from wcmc_tpu_torch.train.factory import TrainConfig

    if family == "kpcn":
        kw.setdefault("kpcn_ksize", 21)
    return TrainConfig(base_model=family, use_llpm_buf=True, manif_learn=True,
                       manif_loss="FMSE", seed=SEED, **kw)


# Launches per train step: KPCN's K1 and K2 once per branch (its buffers
# are data, so no K3); LBMC's K1, K2 and K3 once per layer; SBMC's K4
# forward and backward for the PathNet and for Multisteps, K5 forward and
# backward for the PathNet and each Multisteps step, the splat (K7) and
# its weights' gradient (K8), but not K9: the splatted radiance is data.
TRAIN_LAUNCHES = {
    "kpcn": {"gather_softmax": 2, "outer_softmax": 2, "pathnet_embed": 1,
             "pathnet_embed_bwd": 1, "pathnet_head": 1, "pathnet_head_bwd": 1},
    "lbmc": {"mlp_fused": 1, "mlp_fused_bwd": 1, "gather_softmax": 2, "outer_softmax": 2,
             "scatter_softmax": 2, "pathnet_embed": 1, "pathnet_embed_bwd": 1,
             "pathnet_head": 1, "pathnet_head_bwd": 1},
    "sbmc": {"pathnet_embed": 2, "pathnet_embed_bwd": 2, "pathnet_head": 4,
             "pathnet_head_bwd": 4, "scatter": 1, "outer": 1},
}


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
    by_kind = {}
    for e in device:
        kind = device_kind(e.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + e.self_device_time_total / 1e3 / n
    return {
        "steps": n, "wall_ms_profiled": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_ms_per_step_by_kind": by_kind,
        "top_device": [{"name": e.key[:90], "ms": e.self_device_time_total / 1e3,
                        "count": e.count} for e in top],
    }


def step_draws(iface, batch, family):
    """The manifold-loss draws of one step for ``batch``: KPCN's p-buffers
    are channel-major over its 21x21 / depth-9 output, LBMC's channels-last
    over the whole patch."""
    b, s, h = batch["paths"].shape[:3]
    if family == "kpcn":
        kpcn = iface.models["dncnn"]
        out_hw = h - 4 * kpcn.depth - (kpcn.ksize - 1)
        return iface.draw_pairings((b, s, 3, out_hw, out_hw))
    return iface.draw_pairings((b, s, h, batch["paths"].shape[3],
                                iface.models["backbone"].outc))


def xcheck_decision(card, bf16, f32, card_loss, bf16_loss, f32_loss, limits=XCHECK):
    """The cross-check's decision, a pure function of one state's
    readings: ``card``, ``bf16`` and ``f32`` map each model to its
    flattened gradient (1-D tensors), the ``*_loss`` dicts each loss to a
    float.  Returns (the terms of every model and loss: n, the two
    distances and their limits; the names that fail, empty when the step
    passes).  See ``XCHECK``."""
    a, a_f = limits["alpha"], limits["alpha_f32"]
    terms, bad = {}, []

    def judge(name, d_cb, d_cf, n, ref, beta):
        t = {"n": n, "card-bf16": d_cb, "card-f32": d_cf, "f32": ref,
             "limit_bf16": a * n + beta * ref, "limit_f32": a_f * n + beta * ref}
        terms[name] = t
        if not (d_cb <= t["limit_bf16"] and d_cf <= t["limit_f32"]):
            bad.append(name)

    for name, c in card.items():
        b, f = bf16[name], f32[name]
        judge(name, float((c - b).norm()), float((c - f).norm()), float((b - f).norm()),
              float(f.norm()), limits["beta"])
    for name, f in f32_loss.items():
        c, b, f = float(card_loss[name]), float(bf16_loss[name]), float(f)
        judge(name, abs(c - b), abs(c - f), abs(b - f), abs(f), limits["beta_loss"])
    return terms, bad


def cross_check(torch, card_if, batch, family):
    """One step of ``card_if``'s weights on the card against the same
    step on the CPU in bf16 and in f32 (same batch and draws), decided by
    ``xcheck_decision``; the record also carries each loss's relative
    error and each model's cosine and norm ratio against either CPU step.
    A failure raises AssertionError with the record as its ``record``."""
    from wcmc_tpu_torch import convert
    from wcmc_tpu_torch.train.factory import init_interfaces

    draws = step_draws(card_if, batch, family)
    card_if.preprocess(batch)
    card_loss = card_if.train_batch(batch, grad_hook_mode=True, draws=draws)
    card_loss = {k: float(v) for k, v in card_loss.items()}
    card_grads = {n: torch.cat([p.grad.flatten().double().cpu() for p in m.parameters()])
                  for n, m in card_if.models.items()}
    host = {k: v.cpu() for k, v in batch.items()}
    # a digest of the weights the check starts from: the steps before it
    # repeat bit for bit, so it is the same in every call
    digest = hashlib.sha1()
    for m in card_if.models.values():
        for p in m.parameters():
            digest.update(p.detach().cpu().numpy().tobytes())
    result = {"weights_sha1": digest.hexdigest(), "limits": XCHECK}
    ref_grads, ref_losses = {}, {}
    for dtype in ("bfloat16", "float32"):
        ref = init_interfaces(train_config(family, compute_dtype=dtype), device="cpu")[0]
        for name, m in card_if.models.items():
            convert.load_flax_params(ref.models[name], convert.to_flax(m))
        ref.to_train_mode()
        ref.preprocess(host)
        t0 = time.perf_counter()
        ref_loss = {k: float(v) for k, v in
                    ref.train_batch(host, grad_hook_mode=True, draws=draws).items()}
        cpu_s = time.perf_counter() - t0
        ref_grads[dtype] = {name: torch.cat([p.grad.flatten().double() for p in m.parameters()])
                            for name, m in ref.models.items()}
        ref_losses[dtype] = ref_loss
        grads = {}
        for name, r in ref_grads[dtype].items():
            a = card_grads[name]
            grads[name] = {"cos": float(a @ r / (a.norm() * r.norm())),
                           "norm_ratio": float(a.norm() / r.norm())}
        result[dtype] = {"loss_rel": {k: abs(card_loss[k] - v) / abs(v)
                                      for k, v in ref_loss.items()},
                         "grads": grads, "cpu_s": cpu_s}
    result["decision"], bad = xcheck_decision(
        card_grads, ref_grads["bfloat16"], ref_grads["float32"], card_loss,
        ref_losses["bfloat16"], ref_losses["float32"])
    if bad:
        exc = AssertionError(f"{family} card step off the CPU steps: {bad}: {result}")
        exc.record = result
        raise exc
    return result


def train_phase(torch, dev, family, b=8, patch=128, spp=8, check=cross_check):
    """The flagship training step of ``family`` through the port's entry
    points; returns the phase record and the launches of the timed steps.
    ``check`` is the cross-check, run at the seeded initial weights (before
    the warm-up steps) and after the timed steps (``chip_xcheck.py`` passes
    one that saves the state the check starts from: the second call's is
    the one kept)."""
    import numpy as np

    from wcmc_tpu_torch.data.batches import synthetic_batch
    from wcmc_tpu_torch.ops import _build
    from wcmc_tpu_torch.train.factory import init_interfaces

    n_warm, n_timed, n_prof = 3, 10, 2
    t0 = time.perf_counter()
    batch = synthetic_batch(np.random.default_rng(SEED), family, b, patch, spp, True)
    batch = {k: v.to(dev) for k, v in batch.items()}
    t_data = time.perf_counter() - t0
    cfg = train_config(family)
    iface = init_interfaces(cfg, device=dev)[0]
    before = {n: [p.detach().clone() for p in m.parameters()]
              for n, m in iface.models.items()}
    iface.to_train_mode()
    # the cross-check at the seeded initial weights, on a copy of the
    # models in an interface of its own (its draws leave this one's
    # generator where it was)
    t0 = time.perf_counter()
    init_if = init_interfaces(cfg, device=dev)[0]
    for name, m in init_if.models.items():
        m.load_state_dict(iface.models[name].state_dict())
    init_if.to_train_mode()
    xcheck_init = check(torch, init_if, {k: v[:2] for k, v in batch.items()}, family)
    del init_if
    xcheck_init_s = time.perf_counter() - t0
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
    want = {k: n_timed * v for k, v in TRAIN_LAUNCHES[family].items()}
    if launches != want:
        raise AssertionError(f"the {family} train step launched {launches} in {n_timed} "
                             f"steps, not {want}")
    if plain:
        raise AssertionError(f"plain versions ran on the {family} train step: {plain}")
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
    check_head_body(profiled["device_ms_per_step_by_kind"], f"the {family} train step")
    check_embed_body(profiled["device_ms_per_step_by_kind"], f"the {family} train step")
    check_redesigned_body(profiled["device_ms_per_step_by_kind"], f"the {family} train step",
                          [k for k in REDESIGNED_BODIES if k in TRAIN_LAUNCHES[family]])
    # the cross-check on the first two patches of the batch, after the timed steps
    t0 = time.perf_counter()
    xcheck = check(torch, iface, {k: v[:2] for k, v in batch.items()}, family)
    xcheck_s = [xcheck_init_s, time.perf_counter() - t0]

    med = statistics.median(step_ms)
    config = {"model": str(iface.models["dncnn"]), "batch": b, "patch": patch, "spp": spp,
              "manif_loss": cfg.manif_loss, "manif_pairing": cfg.manif_pairing,
              "compute_dtype": cfg.compute_dtype}
    if family == "kpcn":
        config["kpcn_ksize"] = cfg.kpcn_ksize
    if family == "sbmc":
        config["sbmc_ksize"] = cfg.sbmc_ksize
    record = {
        "phase": "train" if family == "kpcn" else f"train_{family}", "config": config,
        "data_s": t_data, "step_ms": med, "step_ms_runs": step_ms,
        "mp_per_s": b * patch * patch / 1e6 / (med / 1e3),
        "launches_per_step": {k: v / n_timed for k, v in launches.items()},
        "plain_calls": plain, "peak_mem_gb": peak_gb,
        "loss_trajectory": trajectory, "profile": profiled, "cross_check_init": xcheck_init,
        "cross_check": xcheck, "cross_check_s": xcheck_s,
    }
    return record, launches


# The training entry points from disk (python -m wcmc_tpu_torch.train_*),
# one synthetic 512x512 8-spp corpus (2 train scenes, 1 val, 1 test) for
# all three.  The loaders span spp 2..8, one patch pool per sample count,
# so an epoch is 7 x (2 scenes x patches_per_image / batch) steps: KPCN's
# flagship (--patches_per_image 32, batch 8) 56 a train epoch and 56
# validation batches of 4; LBMC and SBMC (--patches_per_image 4) 7 and 7.
CLI_SPP = 8
CLI = {
    "kpcn": {"module": "train_kpcn", "model_name": "KPCN_cli",
             "args": ["--train_branches", "--patches_per_image", "32", "--num_epoch", "2",
                      "--visual"],
             "resume": ["--start_epoch", "2", "--num_epoch", "3"], "serve": True},
    "lbmc": {"module": "train_lbmc", "model_name": "LBMC_cli",
             "args": ["--patches_per_image", "4", "--num_epoch", "1", "--visual"]},
    "sbmc": {"module": "train_sbmc", "model_name": "SBMC_cli",
             "args": ["--use_sbmc_buf", "--patches_per_image", "4", "--num_epoch", "1",
                      "--visual"]},
}


def cli_corpus(torch, dev, work, size=512):
    """The CLI phases' corpus: 2 train scenes, 1 val and 1 test at ``size``
    px and ``CLI_SPP`` samples, with the LLPM, SBMC and KPCN caches (and the train/val
    importance maps) preprocessed on the card; returns (root, record)."""
    from wcmc_tpu_torch.data.dataset import offline_preprocess
    from wcmc_tpu_torch.data.synthetic import build_synthetic_dataset

    root = os.path.join(work, "corpus")
    t0 = time.perf_counter()
    spp = CLI_SPP
    build_synthetic_dataset(root, n_train=2, n_val=1, n_test=1, size=size, spp=spp,
                            test_extra_parts=0, seed=SEED)
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    for mode in ("train", "val"):
        offline_preprocess(root, mode=mode, spp=8, sbmc=True, device=dev)
    offline_preprocess(root, mode="test", spp=spp, test_spps=(spp,), device=dev)
    torch.cuda.synchronize()
    return root, {"phase": "cli_corpus", "frame": [size, size], "spp": spp,
                  "scenes": {"train": 2, "val": 1, "test": 1}, "data_s": t_data,
                  "preprocess_s": time.perf_counter() - t0}


def optimizer_state(torch, iface):
    """Every model's parameters and Adam state (moments, step), and each
    optimizer's learning rate and warmup count, as CPU tensors."""
    out = {}
    for name, m in iface.models.items():
        opt = iface.optims["optim_" + name]
        for i, p in enumerate(m.parameters()):
            st = opt.adam.state[p]
            out[f"{name}.{i}"] = [p.detach().cpu(), st["exp_avg"].cpu(),
                                  st["exp_avg_sq"].cpu(), torch.as_tensor(float(st["step"]))]
        out[name] = [torch.tensor([opt.lr, float(opt.count)], dtype=torch.float64)]
    return out


def train_cli_phase(torch, dev, root, family):
    """``python -m wcmc_tpu_torch.<module>`` on ``root`` through its
    ``main`` (argv as a user passes it, ``--device`` the card): checkpoints
    written, losses finite, every kernel of the family's train step
    launched at least once a step and no plain version run; for KPCN the
    first epoch profiled (``--profile_dir``), then a resume from the
    latest checkpoint (copied over the best one, which the entry resumes
    from) whose restored parameters and Adam state are bit for bit those
    of the first run, and the best checkpoint served by
    ``wcmc_tpu_torch.test_models``.  Returns the phase record."""
    import importlib
    import shutil

    import numpy as np

    from wcmc_tpu_torch import test_models
    from wcmc_tpu_torch.ops import _build
    from wcmc_tpu_torch.train.checkpoint import load_checkpoint

    spec = CLI[family]
    entry = importlib.import_module("wcmc_tpu_torch." + spec["module"])
    name = spec["model_name"]
    save = os.path.join(os.path.dirname(root), "weights_" + family)
    prof_dir = os.path.join(save, "profile")
    argv = ["--single_gpu", "--batch_size", "8", "--val_epoch", "1", "--data_dir", root,
            "--model_name", name, "--desc", f"chip_smoke {family}", "--save", save,
            "--use_llpm_buf", "--manif_learn", "--manif_loss", "FMSE",
            "--seed", str(SEED), "--device", str(dev), *spec["args"]]
    if "resume" in spec:
        argv += ["--profile_dir", prof_dir]

    def run(args):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_counts()
        t0 = time.perf_counter()
        ifaces, params = entry.main(entry.parse_args(args))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, plain = dict(_build.launches), dict(_build.plain_calls)
        steps = sum(e["steps"] for e in params["epoch_stats"])
        per_step = TRAIN_LAUNCHES[family]
        short = {k: launches.get(k, 0) for k, v in per_step.items()
                 if launches.get(k, 0) < steps * v}
        if not steps or short:
            raise AssertionError(f"the {family} CLI launched {launches} in {steps} steps "
                                 f"(per step at least {per_step})")
        if plain:
            raise AssertionError(f"plain versions ran on the {family} CLI: {plain}")
        iface = ifaces[0]
        bad = {k: float(v) for k, v in iface.m_losses.items()
               if not bool(torch.isfinite(v).all())}
        if bad:
            raise AssertionError(f"non-finite accumulated losses on the {family} CLI: {bad}")
        logs = os.path.join(save, "logs", name)
        step_ms = {}
        for e in params["epoch_stats"]:
            fn = os.path.join(logs, f"step_times_e{e['epoch']}.npy")
            if os.path.isfile(fn):
                step_ms[e["epoch"]] = float(np.median(np.load(fn)))
        record = {
            "seconds": seconds, "steps": steps, "launches": launches,
            "epochs": [dict(e, loader_wait_share=e["loader_wait_s"] / e["seconds"],
                            step_ms_median=step_ms.get(e["epoch"]))
                       for e in params["epoch_stats"]],
            "best_err": iface.best_err, "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
        }
        return iface, record

    iface, first = run(argv)
    latest = os.path.join(save, f"latest_{name}.ckpt")
    best = os.path.join(save, f"{name}.ckpt")
    for fn in (latest, best):
        if not os.path.isfile(fn):
            raise AssertionError(f"the {family} CLI wrote no {os.path.basename(fn)}")
    record = {"phase": f"train_cli_{family}", "argv": argv, "first_run": first,
              "latest_start_epoch": load_checkpoint(latest)["start_epoch"]}
    if "resume" in spec:
        with open(os.path.join(prof_dir, "summary.json")) as f:
            record["profile_first_epoch"] = json.load(f)
        record["profile_trace_mb"] = os.path.getsize(os.path.join(prof_dir, "trace.json")) / 2**20
        # resume from the latest state: the entry resumes from the best
        # checkpoint's name, so the latest is copied there
        shutil.copyfile(latest, best)
        resume = [a for a in argv if a != "--profile_dir" and a != prof_dir]
        i = resume.index("--num_epoch")
        resume = resume[:i] + resume[i + 2:] + spec["resume"]
        saved = optimizer_state(torch, iface)
        restored, _ = entry.init_model(None, entry.parse_args(resume), dev)
        got = optimizer_state(torch, restored[0])
        differ = [k for k, v in saved.items()
                  if any(not torch.equal(a, b) for a, b in zip(v, got[k]))]
        if differ:
            raise AssertionError(f"restored state differs from the saved one: {differ[:8]}")
        del restored
        _, record["resume_run"] = run(resume)
        record["restored_tensors_bit_for_bit"] = len(saved)
        torch.cuda.reset_peak_memory_stats()
        _build.reset_counts()
        t0 = time.perf_counter()
        results, _ = test_models.main(test_models.parse_args([
            "--model_name", name, "--save", save, "--data_dir", root, "--spps", str(CLI_SPP),
            "--use_llpm_buf", "--output_dir", os.path.join(save, "eval"),
            "--device", str(dev), "--seed", str(SEED), *spec.get("serve_args", ())]))
        torch.cuda.synchronize()
        res = results[("scene0", CLI_SPP)]["output"]
        bad = [k for k, v in res.items() if v != v or abs(v) == float("inf")]
        if bad:
            raise AssertionError(f"non-finite served metrics: {bad}")
        if dict(_build.plain_calls):
            raise AssertionError(f"plain versions ran serving the checkpoint: "
                                 f"{dict(_build.plain_calls)}")
        record["served"] = {"seconds": time.perf_counter() - t0,
                            "linear_RelMSE": res["linear_RelMSE"],
                            "gamma22_DSSIM": res["gamma22_DSSIM"],
                            "launches": dict(_build.launches),
                            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
    return record


# The KPCN variants of train_kpcn.py at the README flagship widths (K 21,
# depth 9, width 100; the dual PathNet 36 -> 64^3 where used), batch 8, 128
# px, 8 spp, bf16: --kpcn_ref (the targets joined onto KPCN's inputs),
# --kpcn_pre with --manif_learn (phase (a): the dual PathNet alone under
# FMSE) and without (phase (b): KPCN under the frozen PathNet, whose
# forward runs without autograd).  Each step's launches and the models it
# trains.
VARIANTS = {
    "ref": {"config": {"kpcn_ref": True}, "llpm": False, "trained": ("dncnn",),
            "launches": {"gather_softmax": 2, "outer_softmax": 2},
            "serve_launches": {"gather_softmax": 2}},
    "pre_a": {"config": {"kpcn_pre": True, "use_llpm_buf": True, "manif_learn": True,
                         "manif_loss": "FMSE"}, "llpm": True,
              "trained": ("backbone_diffuse", "backbone_specular"),
              "launches": {"pathnet_embed": 1, "pathnet_embed_bwd": 1, "pathnet_head": 1,
                           "pathnet_head_bwd": 1}},
    "pre_b": {"config": {"kpcn_pre": True, "use_llpm_buf": True}, "llpm": True,
              "trained": ("dncnn",),
              "launches": {"pathnet_embed": 1, "pathnet_head": 1, "gather_softmax": 2,
                           "outer_softmax": 2}},
}


def variant_config(variant, **kw):
    from wcmc_tpu_torch.train.factory import TrainConfig

    return TrainConfig(base_model="kpcn", kpcn_ksize=21, seed=SEED,
                       **VARIANTS[variant]["config"], **kw)


def ref_tile_check(torch, iface, batch):
    """One 128-px tile served through the ref interface's ``validate_batch``
    (and so its ``_augment``: the tile carries its targets) on the card,
    against the same weights on the CPU in bf16 and in f32, held to the
    served KPCN tile's limits."""
    from wcmc_tpu_torch import convert
    from wcmc_tpu_torch.ops import _build
    from wcmc_tpu_torch.train.factory import init_interfaces

    tile = {k: v[:1] for k, v in batch.items()}
    calls = []
    real = iface._augment
    iface._augment = lambda b: calls.append(1) or real(b)
    iface.to_eval_mode()
    _build.reset_counts()
    try:
        card_rad, card_p = iface.validate_batch(tile)
        torch.cuda.synchronize()
    finally:
        del iface._augment
    launches, plain = dict(_build.launches), dict(_build.plain_calls)
    if calls != [1] or card_p is not None or launches != VARIANTS["ref"]["serve_launches"] \
            or plain:
        raise AssertionError(f"the ref tile ran _augment {len(calls)} times, launched "
                             f"{launches}, plain {plain}, p-buffers {card_p is not None}")
    out = {"launches": launches}
    for dtype, tol in (("bfloat16", SERVE_BF16_TOL), ("float32", SERVE_F32_TOL)):
        ref_if = init_interfaces(variant_config("ref", compute_dtype=dtype), device="cpu")[0]
        for name, m in iface.models.items():
            convert.load_flax_params(ref_if.models[name], convert.to_flax(m))
        ref_rad, _ = ref_if.validate_batch({k: v.cpu() for k, v in tile.items()})
        pairs = []
        err = max_err(torch, [card_rad.cpu()], [ref_rad], tol, pairs)
        l2 = rel_l2(torch, card_rad.cpu(), ref_rad)
        shift_l2 = rel_l2(torch, torch.roll(ref_rad, 1, dims=-2), ref_rad)
        l2_tol = SERVE_L2_TOLS["kpcn"][dtype]
        if l2 > l2_tol or l2_tol >= shift_l2:
            raise AssertionError(f"the ref tile is off the CPU's {dtype} path by relative L2 "
                                 f"{l2} (limit {l2_tol}, a one-pixel shift {shift_l2})")
        out[dtype] = {"max_abs_err": err, "pairs": pairs, "tol": tol, "rel_l2": l2,
                      "l2_tol": l2_tol, "shift1_rel_l2": shift_l2}
    return out


def variant_phase(torch, dev, variant, smi, b=8, patch=128, spp=8):
    """A KPCN variant's flagship train step through ``init_interfaces`` ->
    ``train_batch``: 3 warm-up and 5 timed steps, each launching exactly its
    counts with no plain call, finite losses, the trained models' parameters
    changed and the frozen ones' bit for bit; the ref variant also serves
    one tile (``ref_tile_check``) before its steps.  Returns the phase
    record and the timed steps' launches."""
    import numpy as np

    from wcmc_tpu_torch.data.batches import synthetic_batch
    from wcmc_tpu_torch.ops import _build
    from wcmc_tpu_torch.train.factory import init_interfaces

    spec = VARIANTS[variant]
    n_warm, n_timed = 3, 5
    t0 = time.perf_counter()
    batch = synthetic_batch(np.random.default_rng(SEED), "kpcn", b, patch, spp, spec["llpm"])
    batch = {k: v.to(dev) for k, v in batch.items()}
    iface = init_interfaces(variant_config(variant), device=dev)[0]
    set_up_s = time.perf_counter() - t0
    served = None
    if variant == "ref":
        # at the seeded initial weights, as the serving phases check theirs:
        # after training steps the CPU's own bf16 path lies 1.3e-2 of max from
        # its f32 path on this tile (2.6e-4 at the initial weights), beyond the
        # served tile's limits
        served = ref_tile_check(torch, iface, batch)
    before = {n: [p.detach().clone() for p in m.parameters()] for n, m in iface.models.items()}
    iface.to_train_mode()
    losses = []

    def step():
        iface.preprocess(batch)
        losses.append(iface.train_batch(batch))

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
    want = {k: n_timed * v for k, v in spec["launches"].items()}
    if launches != want or plain:
        raise AssertionError(f"the {variant} step launched {launches} in {n_timed} steps, not "
                             f"{want}; plain {plain}")
    trajectory = [{k: float(v) for k, v in ld.items()} for ld in losses]
    if any(v != v or abs(v) == float("inf") for ld in trajectory for v in ld.values()):
        raise AssertionError(f"non-finite {variant} losses: {trajectory}")
    changed = {n for n, m in iface.models.items()
               if not all(torch.equal(p, q) for p, q in zip(m.parameters(), before[n]))}
    if changed != set(spec["trained"]):
        raise AssertionError(f"the {variant} steps changed {sorted(changed)}, not "
                             f"{sorted(spec['trained'])}")
    med = statistics.median(step_ms)
    record = {"phase": f"train_kpcn_{variant}", "nvidia_smi": smi,
              "config": {"model": str(iface.models["dncnn"]), "variant": str(iface), "batch": b,
                         "patch": patch, "spp": spp, "compute_dtype": "bfloat16",
                         **spec["config"]},
              "set_up_s": set_up_s, "step_ms": med, "step_ms_runs": step_ms,
              "mp_per_s": b * patch * patch / 1e6 / (med / 1e3),
              "launches_per_step": {k: v / n_timed for k, v in launches.items()},
              "plain_calls": plain, "trained": sorted(changed),
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
              "loss_trajectory": trajectory}
    if served is not None:
        record["served_tile"] = served
    return record, launches


# The parallel modes on the one card: a world of 2 ranks sharing cuda:0 over
# gloo (NCCL puts no two ranks on one card; gloo runs all-reduce and
# broadcast on CUDA tensors, the only collectives the modes use), then a
# world of 1 over NCCL.  The limits of (ii) and (iii): the served KPCN,
# LBMC and SBMC tiles' bf16 limits against the CPU (max error over max
# |ref|, relative L2), which a sharded forward on the card, differing from
# the unsharded one only in the order of its sample sums, must keep too.
MD_WORLD = 2
MD_DEVICES = ["cuda:0"] * MD_WORLD
MD_BATCH = (8, 128, 8)     # global batch, patch px, spp
MD_FRAME, MD_HALO = 512, 32
MD_HALO_LAUNCHES = {"gather_softmax": 2}
MD_ONE_CARD_BACKEND = "nccl"   # (iv)
MD_TOLS = {"halo": (SERVE_BF16_TOL, SERVE_L2_TOLS["kpcn"]["bfloat16"]),
           "dual_pathnet": (SERVE_BF16_TOL, SERVE_L2_TOLS["kpcn"]["bfloat16"]),
           "lbmc": (LBMC_SERVE_TOLS["bfloat16"], SERVE_L2_TOLS["lbmc"]["bfloat16"]),
           "sbmc": (SBMC_SERVE_TOLS["bfloat16"], SERVE_L2_TOLS["sbmc"]["bfloat16"])}
MD_SAMPLE = {
    "dual_pathnet": {"family": "kpcn", "what": "dual_pathnet",
                     "launches": {"pathnet_embed": 1, "pathnet_head": 1}},
    "lbmc": {"family": "lbmc", "what": "dncnn",
             "launches": {"mlp_fused": 1, "gather_softmax": 2}},
    "sbmc": {"family": "sbmc", "what": "dncnn", "sbmc_buf": True,
             "launches": {"pathnet_embed": 1, "pathnet_head": 3, "scatter": 1}},
}


def md_config(family):
    """``train_config(family)``'s fields (what the ranks rebuild it from)."""
    import dataclasses

    return dataclasses.asdict(train_config(family))


def rank_cuda_flags():
    """A rank's TF32 switches as this script sets its own (off)."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def sample_serve(iface, recipe, what, mesh=None):
    """The serving forward ``what`` of ``iface`` on the batch of ``recipe``
    (``parallel.dryrun.resolve_batch``): the dual PathNet on the paths, or
    the sample-space dncnn on the features with the path buffer joined (by
    the interface, unsharded, as served).  With ``mesh``, the spp axis is
    sharded over its spatial group.  Returns (outputs as numpy, ms of the
    forward after a warm-up one, its launches and plain calls)."""
    import torch

    from wcmc_tpu_torch.models.pathnet import dual_pathnet_apply
    from wcmc_tpu_torch.ops import _build
    from wcmc_tpu_torch.parallel.dryrun import resolve_batch
    from wcmc_tpu_torch.parallel.sample import shard_samples, with_sample_group

    batch = {k: v.to(iface.device) for k, v in resolve_batch(recipe).items()}
    group = None if mesh is None else mesh.spatial_group
    with torch.no_grad():
        if what == "dncnn":
            batch = iface._augment_features(batch, slice_recon_only=True)[0]
        keys = ("paths",) if what == "dual_pathnet" else ("radiance", "features")
        batch = {k: batch[k] for k in keys}
        if mesh is not None:
            batch = shard_samples(batch, mesh)

        def forward():
            if what == "dual_pathnet":
                d, s = (with_sample_group(iface.models[n], group)
                        for n in ("backbone_diffuse", "backbone_specular"))
                p_d, p_s, _ = dual_pathnet_apply(d, s, batch, with_moments=True)
                return {"diffuse": p_d, "specular": p_s}
            return {"radiance": with_sample_group(iface.models["dncnn"], group)(batch)}

        forward()   # warm-up
        torch.cuda.synchronize()
        _build.reset_counts()
        t0 = time.perf_counter()
        outs = forward()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
    return ({k: v.float().cpu().numpy() for k, v in outs.items()}, ms,
            dict(_build.launches), dict(_build.plain_calls))


def rank_sample_serve(cfg, params, recipe, what, devices):
    """``sample_serve`` on every rank of a 1 x n mesh, the interface of
    ``cfg`` with ``params`` loaded."""
    import torch

    from wcmc_tpu_torch.parallel.dryrun import _interface
    from wcmc_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n_data=1, n_spatial=torch.distributed.get_world_size(), devices=devices)
    return sample_serve(_interface(cfg, params, mesh.device), recipe, what, mesh)


def held(torch, got, want, tols, what):
    """Max error over max |want| and relative L2 of ``got`` against
    ``want`` (numpy), each within its limit of ``tols``; raises otherwise."""
    import numpy as np

    g, w = torch.from_numpy(np.ascontiguousarray(got)), torch.from_numpy(want)
    err = float((g.double() - w.double()).abs().max()) / float(w.abs().max())
    l2 = rel_l2(torch, g, w)
    if not (err <= tols[0] and l2 <= tols[1]):
        raise AssertionError(f"{what}: max error {err} of max |ref| (limit {tols[0]}), "
                             f"relative L2 {l2} (limit {tols[1]})")
    return {"err_over_max_ref": err, "rel_l2": l2, "tols": list(tols)}


def multi_device_phase(torch, dev, smi, kpcn_record):
    """(i) the flagship KPCN + FMSE data-parallel step over 2 gloo ranks
    (global batch 8, 4 a rank) against the 1-rank step on the card from the
    same weights, batch and draws, each model's gradient and each loss
    within ``XCHECK``'s limits scaled by the bf16 noise n that the train
    phase read at the same seeded weights (CPU bf16 against f32, batch
    [:2]); the replicas' checksums equal; (ii) the flagship KPCN on one 512^2
    8-spp frame in 2 bands with halo 32 against the unsharded forward's
    interior; (iii) the dual PathNet, LBMC and SBMC serving forwards at 8 spp
    split 4 + 4 against the unsharded ones; (iv) two data-parallel steps at
    world 1 over NCCL, bit for bit two 1-rank steps.  Every rank's launches
    exactly its counts, no plain call."""
    import numpy as np
    import torch.distributed as dist

    from wcmc_tpu_torch import convert
    from wcmc_tpu_torch.parallel import dryrun
    from wcmc_tpu_torch.parallel.halo import KPCN_KEYS
    from wcmc_tpu_torch.parallel.launch import RankPool, init_rank
    from wcmc_tpu_torch.train.factory import TrainConfig, init_interfaces

    record = {"phase": "multi_device", "nvidia_smi": smi, "world": MD_WORLD,
              "backend": "gloo", "devices": MD_DEVICES}
    t_phase = time.perf_counter()
    cfg = md_config("kpcn")
    recipe = ("synthetic", "kpcn", SEED, *MD_BATCH, True)
    single = init_interfaces(TrainConfig(**cfg), device=dev)[0]
    params = {n: convert.to_flax(m) for n, m in single.models.items()}
    batch = {k: v.to(dev) for k, v in dryrun.resolve_batch(recipe).items()}
    single.to_train_mode()
    draws = step_draws(single, batch, "kpcn")
    single.preprocess(batch)
    loss1 = {k: float(v) for k, v in single.train_batch(batch, grad_hook_mode=True,
                                                        draws=draws).items()}
    g1 = {n: torch.cat([p.grad.flatten().double().cpu() for p in m.parameters()])
          for n, m in single.models.items()}
    t0 = time.perf_counter()
    with RankPool(MD_WORLD, "gloo", devices=MD_DEVICES) as pool:
        record["pool_start_s"] = time.perf_counter() - t0
        pool.run(rank_cuda_flags)
        # (i) the data-parallel step
        t0 = time.perf_counter()
        ranks = pool.run(dryrun.dp_step, cfg, recipe, params, draws, 1, MD_DEVICES, False, True)
        noise = kpcn_record["cross_check_init"]["decision"]
        terms, bad = {}, []
        for name, g in g1.items():
            d = float((torch.from_numpy(ranks[0]["grads"][name]) - g).norm())
            limit = XCHECK["alpha"] * noise[name]["n"] + XCHECK["beta"] * float(g.norm())
            terms[name] = {"dp-single": d, "n": noise[name]["n"], "limit": limit}
            bad += [name] if d > limit else []
        for name, v in loss1.items():
            d = abs(ranks[0]["losses"][0][name] - v)
            limit = XCHECK["alpha"] * noise[name]["n"] + XCHECK["beta_loss"] * abs(v)
            terms[name] = {"dp-single": d, "n": noise[name]["n"], "limit": limit}
            bad += [name] if d > limit else []
        want = {k: 2 * v for k, v in TRAIN_LAUNCHES["kpcn"].items()}   # grads, then the step
        sums = {r["checksum"] for r in ranks}
        if bad or len(sums) != 1 or any(r["launches"] != want or r["plain_calls"]
                                        for r in ranks):
            raise AssertionError(f"the data-parallel step: off the 1-rank step in {bad} "
                                 f"({terms}); checksums {sums}; launches "
                                 f"{[r['launches'] for r in ranks]}, plain "
                                 f"{[r['plain_calls'] for r in ranks]}")
        record["data_parallel"] = {
            "config": {"global_batch": MD_BATCH[0], "per_rank": MD_BATCH[0] // MD_WORLD,
                       "patch": MD_BATCH[1], "spp": MD_BATCH[2]},
            "decision": terms, "checksum": sums.pop(), "launches_per_rank": ranks[0]["launches"],
            "rank_step_ms": [r["step_ms"][0] for r in ranks], "losses": ranks[0]["losses"][0],
            "s": time.perf_counter() - t0}

        # (ii) row-sharded KPCN inference with the halo exchange
        t0 = time.perf_counter()
        frame = dryrun.resolve_batch(("synthetic", "kpcn", SEED + 1, 1, MD_FRAME, MD_BATCH[2],
                                      True))
        with torch.no_grad():
            single.to_eval_mode()
            net, _ = single._forward_with_paths({k: v.to(dev) for k, v in frame.items()},
                                                for_training=False)
            net = {k: net[k] for k in KPCN_KEYS}
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            full = single.models["dncnn"](net)["radiance"]
            torch.cuda.synchronize()
            full_ms = 1e3 * (time.perf_counter() - t1)
        ranks = pool.run(dryrun.halo_forward, cfg, {k: v.cpu().numpy() for k, v in net.items()},
                         MD_HALO, {"dncnn": params["dncnn"]}, MD_DEVICES)
        out = np.concatenate([r["band"] for r in ranks], axis=1)
        r = single.models["dncnn"].shrink // 2
        if any(x["launches"] != MD_HALO_LAUNCHES or x["plain_calls"] for x in ranks):
            raise AssertionError(f"halo ranks launched {[x['launches'] for x in ranks]}")
        f = MD_FRAME
        record["halo"] = {"frame": [f, f], "bands": MD_WORLD, "halo": MD_HALO,
                          "unsharded_ms": full_ms, "s": time.perf_counter() - t0,
                          **held(torch, out[:, r:f - r, r:f - r], full.float().cpu().numpy(),
                                 MD_TOLS["halo"], "the halo forward")}

        # (iii) spp-sharded serving forwards
        record["sample_parallel"] = {}
        for name, spec in MD_SAMPLE.items():
            t0 = time.perf_counter()
            fcfg = md_config(spec["family"])
            iface = single if spec["family"] == "kpcn" else init_interfaces(
                TrainConfig(**fcfg), device=dev)[0]
            fparams = {n: convert.to_flax(m) for n, m in iface.models.items()}
            frecipe = ("synthetic", spec["family"], SEED, *MD_BATCH, True,
                       *((True,) if spec.get("sbmc_buf") else ()))
            want_out, full_ms, _, _ = sample_serve(iface, frecipe, spec["what"])
            ranks = pool.run(rank_sample_serve, fcfg, fparams, frecipe, spec["what"], MD_DEVICES)
            rec = {"unsharded_ms": full_ms, "rank_ms": [x[1] for x in ranks]}
            if any(x[2] != spec["launches"] or x[3] for x in ranks):
                raise AssertionError(f"{name} ranks launched {[x[2] for x in ranks]}, plain "
                                     f"{[x[3] for x in ranks]}")
            for key, w in want_out.items():
                if spec["what"] == "dual_pathnet":     # each rank its samples
                    got = np.concatenate([x[0][key] for x in ranks], axis=1)
                else:                                  # the image, on every rank
                    if any(not np.array_equal(x[0][key], ranks[0][0][key]) for x in ranks):
                        raise AssertionError(f"{name}: the ranks' images differ")
                    got = ranks[0][0][key]
                rec[key] = held(torch, got, w, MD_TOLS[name], f"{name} {key}")
            rec["s"] = time.perf_counter() - t0
            record["sample_parallel"][name] = rec
            if iface is not single:
                del iface

    # (iv) two data-parallel steps at world 1 over NCCL: the 1-rank steps bit for bit
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as rdv:
        init_rank(0, 1, "file://" + os.path.join(rdv, "rendezvous"), MD_ONE_CARD_BACKEND, dev)
        try:
            res = dryrun.dp_step(cfg, recipe, params, draws, 2, [str(dev)])
        finally:
            dist.destroy_process_group()
    single.to_train_mode()
    for _ in range(2):
        single.preprocess(batch)
        single_loss = {k: float(v) for k, v in single.train_batch(batch, draws=draws).items()}
    same = all(np.array_equal(a, b) for n, m in single.models.items()
               for a, b in zip(nested_leaves(convert.to_flax(m)),
                               nested_leaves(res["params"][n])))
    want = {k: 2 * v for k, v in TRAIN_LAUNCHES["kpcn"].items()}
    if res["launches"] != want or res["plain_calls"] or res["losses"][1] != single_loss \
            or not same:
        raise AssertionError(f"the NCCL world-1 steps: launches {res['launches']} (want "
                             f"{want}), plain {res['plain_calls']}, losses {res['losses'][1]} "
                             f"against {single_loss}, parameters bit for bit {same}")
    # the first step's ms holds NCCL's set-up (its communicator is made at
    # the first collective)
    record["nccl_world1"] = {"backend": MD_ONE_CARD_BACKEND, "world": 1, "steps": 2,
                             "step_ms": res["step_ms"], "losses": res["losses"],
                             "bit_for_bit_1_rank_steps": same,
                             "s": time.perf_counter() - t0}
    record["phase_s"] = time.perf_counter() - t_phase
    return record


def nested_leaves(tree):
    """The arrays of a nested dict in key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += nested_leaves(v) if isinstance(v, dict) else [v]
    return out


FORWARD_KERNELS = ("gather_softmax", "pathnet_embed", "pathnet_head", "mlp_fused", "scatter",
                   "conv5")


def attach_launches(rows, path, serve, train, autograd=None):
    """Each row's ``launches``: the count from its path's run, per served
    frame for a forward kernel and per 10 train steps for a backward one
    or a forward kernel's training form (KPCN's channel-major K5-fwd);
    KPCN's K3, which its step does not run, from its autograd drive."""
    for row in rows:
        name = row.pop("counter")
        row["path"] = path
        if autograd is not None and name in autograd:
            row["launches"] = autograd[name]
        elif row.pop("train_launches", False):   # a forward kernel's training form
            row["launches"] = train[name]
        else:
            row["launches"] = (serve if name in FORWARD_KERNELS else train)[name]
        row["launches_by_path"] = {"serve_frame": serve.get(name, 0),
                                   "train_10_steps": train.get(name, 0)}
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    try:
        from wcmc_tpu_torch.ops import _build
        from wcmc_tpu_torch.ops import kernel_apply as ka
        from wcmc_tpu_torch.ops import mlp_fused as mf
        from wcmc_tpu_torch.ops import pathnet_fused as pf
    except ImportError as exc:
        print(f"chip_smoke: the port's package is not importable ({exc}); run this script "
              "from the root of a checkout of the repository", file=sys.stderr)
        return 3

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

    kpcn_rows = kernel_phase(torch, ka, pf, dev)
    bwd_rows = backward_kernel_phase(torch, ka, pf, dev)
    lbmc_rows = lbmc_kernel_phase(torch, ka, pf, mf, dev)
    sbmc_rows = sbmc_kernel_phase(torch, ka, pf, dev)
    sbmc_rows += sbmc_train_kernel_phase(torch, ka, pf, dev)
    conv_rows = conv_kernel_phase(torch, dev)
    emit({"phase": "kernels", "rows": kpcn_rows + bwd_rows + lbmc_rows + sbmc_rows + conv_rows})

    records, served = {}, {}
    with tempfile.TemporaryDirectory() as work:
        for name in ("kpcn", "lbmc", "sbmc", "kpcn_fused", "kpcn_nopath",
                     "kpcn_nopath_fused"):
            records[name], served[name] = serve_phase(torch, dev, work, name)
            emit(records[name])
    emit({"phase": "fused_vs_default", **fused_vs_default(records)})
    kpcn_serve, lbmc_serve, sbmc_serve = served["kpcn"], served["lbmc"], served["sbmc"]
    kpcn_record, kpcn_train = train_phase(torch, dev, "kpcn")
    emit(kpcn_record)
    record, lbmc_train = train_phase(torch, dev, "lbmc")
    emit(record)
    record, sbmc_train = train_phase(torch, dev, "sbmc")
    emit(record)
    with tempfile.TemporaryDirectory() as work:
        root, record = cli_corpus(torch, dev, work)
        emit(record)
        for family in ("kpcn", "lbmc", "sbmc"):
            t0 = time.perf_counter()
            record = train_cli_phase(torch, dev, root, family)
            record["phase_s"] = time.perf_counter() - t0
            emit(record)
    for variant in VARIANTS:
        t0 = time.perf_counter()
        record, _ = variant_phase(torch, dev, variant, smi)
        record["phase_s"] = time.perf_counter() - t0
        emit(record)
    emit(multi_device_phase(torch, dev, smi, kpcn_record))

    autograd = {"scatter_softmax": next(r.pop("autograd_launches") for r in bwd_rows
                                        if r["name"] == "scatter_softmax")}
    rows = attach_launches(kpcn_rows + bwd_rows, "kpcn", kpcn_serve, kpcn_train, autograd)
    rows += attach_launches(lbmc_rows, "lbmc", lbmc_serve, lbmc_train)
    autograd = {"gather": next(r.pop("autograd_launches") for r in sbmc_rows
                               if r["name"] == "gather")}
    rows += attach_launches(sbmc_rows, "sbmc", sbmc_serve, sbmc_train, autograd)
    rows += attach_launches(conv_rows[:3], "kpcn_fused", served["kpcn_fused"], {})
    rows += attach_launches(conv_rows[3:], "kpcn_nopath_fused", served["kpcn_nopath_fused"], {})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
