#!/usr/bin/env python3
"""What bounds the new bodies of K1 (the softmax gather), K2 and K3 (its
backward), K9 (the weighted gather) and K10-fwd (the fused per-pixel MLP) on
one NVIDIA card, and of the tensor-core f32 bodies of K5-bwd, K6, K4-bwd,
K5-fwd, K4-fwd and K10-bwd: each is built again from a copy of
``wcmc_tpu_torch/ops/csrc`` with one part of its work dropped, and every
variant is timed at the path shapes beside the whole body.

    python3 chip_parts.py [k1 k2 k3 k9 k10 k5b k6 k4b k5f k4f k10b]

(the kernels named, all eleven without arguments).  K4-fwd's f32 body
(``pathnet_embed_tf32_kernel``) at KPCN's PathNet (8 x 8 spp x 128^2
rows, 36 -> 128^3) and Multisteps' embedding (95 -> 128^3 leaky):
``whole``; ``no_hidden`` (h1's and h2's products skipped); ``no_out`` (e's
product skipped); ``no_store`` (e never leaves the registers; the mean
does); ``no_load`` (the next chunk's x never lands); ``no_split``,
``l1_weights``, ``no_step``, as K5-bwd's; and two trials of the whole body:
``one_block`` (launch bounds for one block an SM, not two, where C0 is 40)
and ``ahead1`` (weight fragments one k8 step ahead, not two).  K10-bwd's f32 body
(``mlp_fused_bwd_tf32_kernel``) at LBMC's shape (1,048,576 rows, 32 ->
32^3 leaky, d(x)): ``whole``; ``no_rows`` (the chain's row products:
the recompute, the cotangents and d(x), skipped); ``no_dw`` (dW0's, dW1's
and dW2's products skipped); ``no_dx`` (d(x) never stored); ``no_load``
(no slab after the first two lands); ``no_split``, ``no_step``.  K4-bwd's f32 body
(``pathnet_embed_bwd_tf32_kernel``) at KPCN's PathNet (8 x 8 spp x 128^2
rows, 36 -> 128^3, no d(x)) and Multisteps' embedding (95 -> 128^3 leaky,
d(x)), both cotangents: ``whole``; ``no_rows`` (the recompute's and the
d(h) products skipped); ``no_dw`` (dW1's and dW2's products skipped);
``no_dw0`` (dW0^T's products skipped); ``no_load`` (the next chunk's x and
ge never land); ``no_split``, ``l1_weights`` (every weight fragment read
from the first k8 step's, which stays in L1) and ``no_step``, as K5-bwd's.
K5-fwd's f32 body (``pathnet_head_tf32_kernel``) at KPCN's training head
(8 x 8 spp x 128^2 rows, [128 | 128] -> 256 -> 6, moments, channel-major):
``whole``; ``no_h1`` (e . W1e's products skipped); ``no_out`` (the output
product skipped); ``no_store`` (no output leaves shared memory); ``no_load``
(the next chunk's e never lands); ``no_split``, ``l1_weights``,
``no_step``.  K5-bwd's f32 body
(``pathnet_head_bwd_tf32_kernel``) at KPCN's training form (8 x 8 spp x
128^2 rows, [128 | 128] -> 256 -> 6, channel-major cotangent with moments):
``whole``; ``no_z`` (e . W1e's products skipped); ``no_dw1e`` (dW1e's
products skipped); ``no_de`` (d(e)'s products and stores skipped);
``no_tile`` (the per-tile ctx . W1c, d(ctx) and dW1c products skipped);
``no_split`` (the activations' split into tf32 hi and lo replaced by a
copy); ``l1_weights`` (every weight fragment read from one small block that
stays in L1, not from L2); ``no_step`` (every product straight into its
running sum, not a partial a k8 step).  Each K5-bwd line also gives d(e)'s
and d(ctx)'s relative L2 distance from an f64 computation and dW1's and
dW2's max error of max (``chip_smoke.py``'s ``head_bwd_f64``); ``whole``
gives them for the SIMT body and the plain version too, and again with
linear activations (no relu to flip: the arithmetic alone).  K6's tensor-core f32 body
(``conv5_tf32_kernel``) at the fused KPCN's layer 5 ((8, 112, 112, 100) at a
pitch of 104 -> 100, relu): ``whole``; ``one_sum`` (each step's products
straight into the running sums, not a partial a step); each with its
relative L2 distance from the f64 convolution, ``whole`` also the SIMT
body's and cuDNN's.  K9 (``gather_tiled_kernel``)
at the splat's d(values) shape ((64, 148, 148, 4) f32 canvas cotangent,
(64, 128, 128, 441) contiguous f32 weights, K 21): ``whole``; ``no_weights``
(no weight lands: no bulk copy and no per-pixel copies); ``no_window`` (no
buffer row lands); ``no_compute`` (no pixel's sums: the landing, the
barriers and the stores).  K1
(``gather_softmax_tiled_kernel``) at LBMC's and KPCN's shapes as K2's below:
``whole``; ``no_compute`` (no pixel's softmax or sums: the landing, the
barriers and the stores); ``no_logits`` (no logit lands); ``no_window`` (no
buffer row lands: the arithmetic on stale shared memory).  K10-fwd
(``mlp_fused_tiled_kernel``) at LBMC's shape (1,048,576 rows, 32 -> 32 -> 32
-> 32 leaky): ``whole``; ``no_products`` (the chain skipped: a slab's x rows
stored as they landed); ``no_load`` (no slab lands); ``no_store`` (the output
never leaves shared memory).  K2 (``outer_softmax_tiled_kernel``) at LBMC's
shape (8 x 128^2, K 13, layer 1's bf16 slice of a channels-last kernel head)
and at KPCN's (8 x 72^2, K 21, the crop of a channels-last convolution
output): ``whole``; ``no_compute``
(no pixel's softmax, dp or gradient: the landing, the barriers and the
stores); ``no_logits`` (no logit lands: the arithmetic on stale shared
memory); ``no_store`` (the gradients never leave shared memory).  K3
(``scatter_softmax_banded_kernel`` and its band sums) at LBMC's shape:
``whole``; ``no_convert`` (no probability is computed); ``no_taps`` (no tap
loop); ``no_logits``.  A dropped part leaves wrong outputs; only ``whole`` is
checked (K1, K2 and K10-fwd bit for bit against their first bodies, K3 within
1e-5 of its gather body; K9 bit for bit against its first body; K4-bwd's,
K5-fwd's, K4-fwd's and K10-bwd's bit for bit against the wrapper's launch).  Each line: the
variant, the path, the CUDA-event ms and the profiler's device ms (``chip_smoke.py``'s ``time_ms`` and ``device_ms``).
The card's ``nvidia-smi`` name and power limit come first.  Exits non-zero
without CUDA or if a variant does not build.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

# (source, [(text, replacement), ...]) by variant; every text must occur in
# the sources, so a variant that no longer drops its part fails loudly
K1_SRC, K2_SRC, K3_SRC, K9_SRC, K10_SRC = ("gather_softmax.cu", "outer_softmax.cu",
                                           "scatter_softmax.cu", "gather.cu", "mlp_fused.cu")
K5B_SRC, K6_SRC = "pathnet_head_bwd_tf32.cu", "conv5_tf32.cu"
K4B_SRC, K5F_SRC = "pathnet_embed_bwd_tf32.cu", "pathnet_head_tf32.cu"
K4F_SRC, K10B_SRC = "pathnet_embed_tf32.cu", "mlp_bwd_tf32.cu"
KERNELS = ("k1", "k2", "k3", "k9", "k10", "k5b", "k6", "k4b", "k5f", "k4f", "k10b")
# the tensor-core f32 bodies' shared parts (tf32x3.cuh)
NO_SPLIT = ("  hi = tf32_rna(a);\n  lo = tf32_rna(a - __uint_as_float(hi));",
            "  hi = __float_as_uint(a);\n  lo = hi;")
L1_WEIGHTS = ("next[kAhead - 1][nt] = __ldg(wp + ((size_t)nt * wk8 + ks + kAhead) * 32);",
              "next[kAhead - 1][nt] = __ldg(wp + (size_t)nt * 32);")
NO_STEP = ("  float t[4];\n"
           "  mma_tf32_zero(t, a.lo, b.v[0], b.v[1]);\n"
           "  mma_tf32(t, a.hi, b.v[2], b.v[3]);\n"
           "  mma_tf32(t, a.hi, b.v[0], b.v[1]);\n"
           "#pragma unroll\n"
           "  for (int i = 0; i < 4; ++i) d[i] += t[i];\n",
           "  mma_tf32(d, a.lo, b.v[0], b.v[1]);\n"
           "  mma_tf32(d, a.hi, b.v[2], b.v[3]);\n"
           "  mma_tf32(d, a.hi, b.v[0], b.v[1]);\n")
NO_LOGITS = ("for (int ch = lane; 16 * ch <", "for (int ch = 32; 16 * ch <")
NO_PIXELS = ("      for (int p = warp; p < n; p += kWarps) {\n        // the first body's softmax",
             "      for (int p = warp; p < 0; p += kWarps) {\n        // the first body's softmax")
VARIANTS = {
    "k1_whole": (K1_SRC, []),
    "k1_no_compute": (K1_SRC, [NO_PIXELS]),
    "k1_no_logits": (K1_SRC, [NO_LOGITS]),
    "k1_no_window": (K1_SRC, [("      land_span(slot, rs, len);\n"
                               "      land_span(slot + (size_t)slots * pitch, rs, len);\n", "")]),
    "k9_whole": (K9_SRC, []),
    "k9_no_weights": (K9_SRC, [(
        "    const bool bulk = dense(first, n);\n"
        "    if (!bulk) land_logit_run(dst, first, a.ws_x, n, K2, lpitch, a.w_end);\n",
        "    const bool bulk = false;\n")]),
    "k9_no_window": (K9_SRC, [("      land_span(slot, rs, len);\n"
                               "      land_span(slot + (size_t)slots * pitch, rs, len);\n", "")]),
    "k9_no_compute": (K9_SRC, [(
        "      for (int p = warp; p < n; p += kWarps) {\n        const TL* lp",
        "      for (int p = warp; p < 0; p += kWarps) {\n        const TL* lp")]),
    "k10_whole": (K10_SRC, []),
    "k10_no_products": (K10_SRC, [(
        "      tb_layer<kA0>(xa, wf[0], bias[0], a.act[0], h1);\n"
        "      tb_layer<kA1>(h1, wf[1], bias[1], a.act[1], h2);\n"
        "      tb_layer<kA2>(h2, wf[2], bias[2], a.act[2], h3);\n",
        "      for (int k = 0; k < 8; ++k) h3[k / 4][k % 4] = xa[k / 4][k % 4];\n")]),
    "k10_no_load": (K10_SRC, [("    tb_land(stage(i), a.x + row0 * a.c0, rows_of(row0), a.c0, "
                               "a.vec_x, lane);\n", "")]),
    "k10_no_store": (K10_SRC, [("    tb_store(a.out + row0 * kTbW, st, rows, kTbW, a.vec_out, "
                                "lane);\n", "")]),
    "k2_whole": (K2_SRC, []),
    "k2_no_compute": (K2_SRC, [NO_PIXELS]),
    "k2_no_logits": (K2_SRC, [NO_LOGITS]),
    "k2_no_store": (K2_SRC, [("if (aligned16(dst) && bytes % 16 == 0) {", "if (false) {"),
                             ("for (int e = tid; e < n * K2; e += kThreads) dst[e] = out[e];",
                              "")]),
    "k3_whole": (K3_SRC, []),
    "k3_no_convert": (K3_SRC, [("      ok[i] = p < n;\n", "      ok[i] = false;\n")]),
    "k3_no_taps": (K3_SRC, [("      splat_step<kC, kK, S>(s_p, s_x, s_ring, K, Wc, cols, wcj, yl, "
                             "r, g, ndy);", "")]),
    "k3_no_logits": (K3_SRC, [NO_LOGITS]),
    "k5b_whole": (K5B_SRC, []),
    "k5b_no_z": (K5B_SRC, [("mm_rows_w<kRing>(acc, Ec + m0 * pe, pe, kCe / 8, W, kCe / 8, jn0, "
                            "ring);", "")]),
    "k5b_no_dw1e": (K5B_SRC, [("mm_rows_t(dw1e, Ec, pe, m5, H, ph, n5, kHtRows / 8);", "")]),
    "k5b_no_de": (K5B_SRC, [("for (int tt = warp; tt < 2 * kCe / 32; tt += 8) {",
                             "for (int tt = warp; tt < 0; tt += 8) {")]),
    "k5b_no_tile": (K5B_SRC, [
        ("mm_rows_w<kRing>(acc, CX, pe, kCe / 8, W + oW1c, kCe / 8, warp * NT0, ring);", ""),
        ("mm_rows_w<kRing>(acc, G, ph, kC1 / 8, W + oW1ct, kC1 / 8, warp * NT7, ring);", ""),
        ("mm_rows_t(acc, CX, pe, m0, G, ph, n0, kHtPix / 8);", "")]),
    "k5b_no_split": (K5B_SRC, [NO_SPLIT]),
    "k5b_l1_weights": (K5B_SRC, [("W + ((size_t)(jn0 + nt) * wk8 + ks) * 128 + lane * 4, 16);",
                                  "W + (size_t)nt * 128 + lane * 4, 16);")]),
    "k5b_no_step": (K5B_SRC, [NO_STEP]),
    "k4b_whole": (K4B_SRC, []),
    "k4b_no_rows": (K4B_SRC, [("mm_rows_ldg(acc, A + m0 * pa, pa, k8s, Wm, k8s, jn0);", "")]),
    "k4b_no_dw": (K4B_SRC, [("mm_rows_t(dw2, H2, ph, mw, G3, ph, nw, kEtRows / 8);", ""),
                            ("mm_rows_t(dw1, H1, ph, mw, H2, ph, nw, kEtRows / 8);", "")]),
    "k4b_no_dw0": (K4B_SRC, [("mm_rows_t(acc, H1, ph, m0, Xc, px, n0, kEtRows / 8);", "")]),
    "k4b_no_load": (K4B_SRC, [("        load_x(X[(q + 1) & 1], tn, sn);\n        load_ge(tn, sn);\n",
                               "")]),
    "k4b_no_split": (K4B_SRC, [NO_SPLIT]),
    "k4b_l1_weights": (K4B_SRC, [L1_WEIGHTS]),
    "k4b_no_step": (K4B_SRC, [NO_STEP]),
    "k5f_whole": (K5F_SRC, []),
    "k5f_no_h1": (K5F_SRC, [("mm_rows_ldg<MTh, 4, kAhead>(acc, Ec + m0 * pe, pe, kCe / 8, W, "
                             "kCe / 8, jn0);", "")]),
    "k5f_no_out": (K5F_SRC, [("mm_rows_ldg<4, kOut / 8, kAhead>(acc, H + warp * kStepsW * 8, ph, "
                              "kStepsW, wo,\n                                         kC1 / 8, "
                              "0);", "")]),
    "k5f_no_store": (K5F_SRC, [("        if (s >= a.S || p >= a.HW || c >= a.cout) continue;",
                                "        if (s >= 0) continue;")]),
    "k5f_no_load": (K5F_SRC, [("        if (tn < tiles) load_e(E[(q + 1) & 1], tn, sn);", "")]),
    "k5f_no_split": (K5F_SRC, [NO_SPLIT]),
    "k5f_l1_weights": (K5F_SRC, [L1_WEIGHTS]),
    "k5f_no_step": (K5F_SRC, [NO_STEP]),
    "k4f_whole": (K4F_SRC, []),
    "k4f_no_hidden": (K4F_SRC, [("    mm_rows_ldg<4, NT, kAhead>(acc, A, pa, k8s, Wm, k8s, jn0);\n",
                                 "")]),
    "k4f_no_out": (K4F_SRC, [("      mm_rows_ldg<4, NT, kAhead>(acc, H2, ph, kC / 8, W + oW2, "
                              "kC / 8, jn0);\n", "")]),
    "k4f_no_store": (K4F_SRC, [("              *reinterpret_cast<float2*>(er + c) = "
                                "make_float2(v0, v1);\n", "")]),
    "k4f_no_load": (K4F_SRC, [("        if (tn < tiles) load_x(X[(q + 1) & 1], tn, sn);\n", "")]),
    "k4f_one_block": (K4F_SRC, [("__launch_bounds__(kThreads, kC0 == 40 ? 2 : 1)",
                                 "__launch_bounds__(kThreads, 1)")]),
    "k4f_ahead1": (K4F_SRC, [("  constexpr int kAhead = 2;     // weight fragments read ahead",
                              "  constexpr int kAhead = 1;     // weight fragments read ahead")]),
    "k4f_no_split": (K4F_SRC, [NO_SPLIT]),
    "k4f_l1_weights": (K4F_SRC, [L1_WEIGHTS]),
    "k4f_no_step": (K4F_SRC, [NO_STEP]),
    "k10b_whole": (K10B_SRC, []),
    "k10b_no_rows": (K10B_SRC, [("      mma3(out[nt], fa, fb);\n", "")]),
    "k10b_no_dw": (K10B_SRC, [
        ("    mm_rows_t<2, 4>(dw[2], H2, kMtPitch, 0, G, kMtPitch, 0, kMtRows / 8);", ""),
        ("    mm_rows_t<2, 4>(dw[1], H1, kMtPitch, 0, G, kMtPitch, 0, kMtRows / 8);", ""),
        ("    mm_rows_t<2, 4>(dw[0], X, kMtPitch, 0, G, kMtPitch, 0, kMtRows / 8);", "")]),
    "k10b_no_dx": (K10B_SRC, [("            *reinterpret_cast<float2*>(d + c) = "
                               "make_float2(v[j][2 * hh], v[j][2 * hh + 1]);\n", "")]),
    "k10b_no_load": (K10B_SRC, [("    if (i + kMtStages - 1 < n_mine) fetch(i + kMtStages - 1);\n",
                                 "")]),
    "k10b_no_split": (K10B_SRC, [NO_SPLIT]),
    "k10b_no_step": (K10B_SRC, [NO_STEP]),
    "k6_whole": (K6_SRC, []),
    "k6_one_sum": (K6_SRC, [
        ("          wgmma_tf32<kN>(part, lo, b_hi, 0);   // the step's own partial, from zero\n"
         "          wgmma_tf32<kN>(part, hi, b_lo, 1);\n"
         "          wgmma_tf32<kN>(part, hi, b_hi, 1);\n",
         "          wgmma_tf32<kN>(acc, lo, b_hi, 1);\n"
         "          wgmma_tf32<kN>(acc, hi, b_lo, 1);\n"
         "          wgmma_tf32<kN>(acc, hi, b_hi, 1);\n"),
        ("            for (int i = 0; i < 4; ++i) acc[jn][i] += part[jn][i];",
         "            for (int i = 0; i < 0; ++i) acc[jn][i] += part[jn][i];")]),
}


def build(nvcc, flags, csrc, work, kernels):
    """Each variant's library of the kernels named, all nvcc processes
    started together."""
    procs = {}
    for name, (src, subs) in VARIANTS.items():
        if name.split("_")[0] not in kernels:
            continue
        d = os.path.join(work, name)
        shutil.copytree(csrc, d)
        for text, _ in subs:
            if not any(text in open(os.path.join(d, f)).read() for f in os.listdir(d)):
                raise RuntimeError(f"{name}: the sources no longer hold {text!r}")
        for f in os.listdir(d):
            path = os.path.join(d, f)
            body = open(path).read()
            for text, repl in subs:
                body = body.replace(text, repl)
            open(path, "w").write(body)
        lib = os.path.join(d, "lib.so")
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *flags, "-shared", os.path.join(d, src), "-o", lib],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name} did not build:\n{out[-4000:]}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def main() -> int:
    import torch

    kernels = sys.argv[1:] or list(KERNELS)
    if set(kernels) - set(KERNELS):
        print(f"chip_parts: no kernel among {kernels}; name {', '.join(KERNELS)}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_parts: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from wcmc_tpu_torch.ops import _build

    # the f32 references (cuBLAS, cuDNN) in full f32, as chip_smoke.py takes them
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from wcmc_tpu_torch.ops import kernel_apply as ka
    from wcmc_tpu_torch.ops import mlp_fused as mf

    print(cs.nvidia_smi_line(), flush=True)
    with tempfile.TemporaryDirectory() as work:
        libs = build(_build._nvcc(), _build.NVCC_FLAGS, str(_build.CSRC), work, kernels)
        dev = torch.device("cuda", 0)
        sms = _build.sm_count(0)
        stream = _build.stream_of(dev)
        g = torch.Generator(device=dev).manual_seed(cs.SEED)
        flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

        def k1(lib, cot, buf, lg, k):
            b, H, W, c = buf.shape
            plan = ka.gather_softmax_plan(b, H - k + 1, W - k + 1, c, k, 2, sms)
            out = torch.empty((b, H - k + 1, W - k + 1, c), dtype=torch.float32, device=dev)
            fn = lib.wcmc_gather_softmax_tiled
            fn.argtypes, fn.restype = [P, P, I, P] + [I] * 5 + [L] * 4 + [I] * 4 + [P], I
            _build.check(fn(buf.data_ptr(), lg.data_ptr(), 1, out.data_ptr(), b, H, W, c, k,
                            *lg.stride()[:3], ka._logit_span(lg), plan.run, plan.rows,
                            plan.blocks, 0, stream), "gather_softmax")
            return out

        def k2(lib, cot, buf, lg, k):
            b, H, W, c = buf.shape
            plan = ka.outer_softmax_plan(b, H - k + 1, W - k + 1, c, k, 2, sms)
            out = torch.empty(tuple(lg.shape), dtype=lg.dtype, device=dev)
            fn = lib.wcmc_outer_softmax_tiled
            fn.argtypes, fn.restype = [P, P, P, I, P] + [I] * 5 + [L] * 4 + [I] * 4 + [P], I
            _build.check(fn(cot.data_ptr(), buf.data_ptr(), lg.data_ptr(), 1, out.data_ptr(), b, H,
                            W, c, k, *lg.stride()[:3], ka._logit_span(lg), plan.run, plan.rows,
                            plan.blocks, 0, stream), "outer_softmax")
            return out

        def k3(lib, cot, buf, lg, k):
            b, h, w, c = cot.shape
            plan = ka.scatter_softmax_plan(b, h, w, c, k, 2, sms)
            out = torch.empty((b, h + k - 1, w + k - 1, c), dtype=torch.float32, device=dev)
            part = torch.empty(b * plan.scratch, dtype=torch.float32, device=dev)
            fn = lib.wcmc_scatter_softmax_banded
            fn.argtypes, fn.restype = [P, P, I, P, P] + [I] * 5 + [L] * 4 + [I] * 3 + [P], I
            _build.check(fn(cot.data_ptr(), lg.data_ptr(), 1, part.data_ptr(), out.data_ptr(), b,
                            h, w, c, k, *lg.stride()[:3], ka._logit_span(lg), plan.rows,
                            plan.cols, 0, stream), "scatter_softmax")
            return out

        def k9(lib, gc, wt, k):
            b, H, W, c = gc.shape
            plan = ka.gather_plan(b, H - k + 1, W - k + 1, c, k, 4, sms)
            out = torch.empty((b, H - k + 1, W - k + 1, c), dtype=torch.float32, device=dev)
            fn = lib.wcmc_gather_tiled
            fn.argtypes, fn.restype = [P, P, I, P] + [I] * 5 + [L] * 4 + [I] * 4 + [P], I
            _build.check(fn(gc.data_ptr(), wt.data_ptr(), 0, out.data_ptr(), b, H, W, c, k,
                            *wt.stride()[:3], ka._logit_span(wt), plan.run, plan.rows,
                            plan.blocks, 0, stream), "gather")
            return out

        def k10(lib, x, ws, bs, acts):
            n, c0 = x.shape
            out = torch.empty((n, 32), dtype=torch.bfloat16, device=dev)
            grid = mf.mlp_fwd_plan(c0, (32, 32, 32), acts).grid(n, sms)
            fn = lib.wcmc_mlp_fused_tiled
            fn.argtypes, fn.restype = [P] * 8 + [L] + [I] * 5 + [I, P], I
            _build.check(fn(x.data_ptr(), *(t.data_ptr() for t in (*ws, *bs)), out.data_ptr(), n,
                            c0, *[mf.ACTS.index(a) for a in acts], grid, 0, stream), "mlp_fused")
            return out

        shapes = {}
        for path, b, p, k in (("lbmc", 8, 128, 13), ("kpcn", 8, 72, 21)):
            buf = torch.rand((b, p + k - 1, p + k - 1, 3), device=dev, generator=g)
            cot = torch.randn((b, p, p, 3), device=dev, generator=g)
            if path == "lbmc":
                head = 2 * torch.randn((b, 2 * k * k, p, p), device=dev, generator=g)
                lg = head.to(torch.bfloat16).contiguous(memory_format=torch.channels_last).permute(
                    0, 2, 3, 1)[..., k * k:]
            else:
                conv = 2 * torch.randn((b, k * k, p + k - 1, p + k - 1), device=dev, generator=g)
                lg = conv.to(torch.bfloat16).contiguous(memory_format=torch.channels_last).permute(
                    0, 2, 3, 1)[:, k // 2:k // 2 + p, k // 2:k // 2 + p]
            shapes[path] = (cot, buf, lg, k)
        # LBMC's K10-fwd: 8 patches x 8 spp x 128^2 rows, 32 -> 32 -> 32 -> 32 leaky
        dims, acts = (32, 32, 32, 32), ("leaky_relu",) * 3
        x = torch.randn((8 * 8 * 128 * 128, 32), device=dev, generator=g).to(torch.bfloat16)
        ws, bs = cs.rand_mlp(torch, dev, g, dims)
        # SBMC's K9: the splat's d(values), (64, 148, 148, 4) canvas cotangent and
        # (64, 128, 128, 441) f32 weights in (0, 1]
        if "k9" in kernels:
            k9_args = (torch.randn((64, 148, 148, 4), device=dev, generator=g),
                       torch.rand((64, 128, 128, 441), device=dev, generator=g), 21)
        runs = {"k1": (k1, "gather_softmax", 1), "k2": (k2, "outer_softmax", 1),
                "k3": (k3, "scatter_softmax", 2)}
        if "k5b" in kernels:
            from wcmc_tpu_torch.ops import pathnet_fused as pf

            # KPCN's training head: 8 x 8 spp x 128^2 rows, channel-major cotangent
            b5, s5, hw5 = 8, 8, 128 * 128
            e5 = torch.randn((b5, s5, hw5, 128), device=dev, generator=g)
            ctx5 = torch.randn((b5, hw5, 128), device=dev, generator=g)
            ws5, bs5 = cs.rand_mlp(torch, dev, g, (256, 256, 6))
            cot5 = (torch.randn((b5, s5, 6, hw5), device=dev, generator=g),
                    torch.randn((b5, hw5, 6), device=dev, generator=g),
                    0.1 * torch.randn((b5, hw5, 6), device=dev, generator=g))
            plan5 = pf.head_bwd_tc_plan(b5, hw5, 128, 128, 256, 6, sms=sms)
            wp5, b15, b25 = pf._packed_head_tf32(ws5, bs5, 128, plan5.form)

        def k5b(lib, acts=(1, 1)):
            de = torch.empty_like(e5)
            dctx = torch.empty_like(ctx5)
            parts = torch.empty(plan5.blocks * plan5.parts, dtype=torch.float32, device=dev)
            out = torch.empty(plan5.parts, dtype=torch.float32, device=dev)
            fn = lib.wcmc_pathnet_head_bwd_tf32
            fn.argtypes, fn.restype = [P] * 12 + [I] * 12 + [P], I
            _build.check(fn(e5.data_ptr(), ctx5.data_ptr(), *(t.data_ptr() for t in cot5),
                            wp5.data_ptr(), b15.data_ptr(), b25.data_ptr(), de.data_ptr(),
                            dctx.data_ptr(), parts.data_ptr(), out.data_ptr(), b5, s5, hw5,
                            *plan5.form, 6, *acts, 1, plan5.blocks, 0, stream),
                         "pathnet_head_bwd")
            kce, kc1, kout = plan5.form
            dw1e, dw1c, dw2 = torch.split(out, [kce * kc1, kce * kc1, kc1 * kout, kc1 + kout])[:3]
            return de, dctx, [torch.cat([dw1e.view(kce, kc1), dw1c.view(kce, kc1)]),
                              dw2.view(kc1, kout)[:, :6]]

        def k5b_f64(got, acts):
            """d(e)'s and d(ctx)'s relative L2 distance from the f64 function,
            dW1's and dW2's max error of max."""
            ref = cs.head_bwd_f64(torch, e5, ctx5, *cot5, ws5, bs5, acts, True)
            return {"de": cs.rel_l2(torch, got[0], ref[0]),
                    "dctx": cs.rel_l2(torch, got[1], ref[1]),
                    **{k: ((a.double() - w).abs().max() / w.abs().max()).item()
                       for k, a, w in zip(("dw1", "dw2"), got[2], ref[2])}}

        if "k4b" in kernels or "k5f" in kernels:
            from wcmc_tpu_torch.ops import pathnet_fused as pf
        if "k4b" in kernels:
            # KPCN's PathNet (36 -> 128^3, relu relu linear) and Multisteps (95 -> 128^3
            # leaky, d(x)) over 8 x 8 spp x 128^2 rows, both cotangents
            k4b_args = {}
            for path, dims, acts4, dx4 in (("kpcn", (36, 128, 128, 128), (1, 1, 0), False),
                                           ("sbmc", (95, 128, 128, 128), (2, 2, 2), True)):
                x4 = torch.randn((8, 8, 128 * 128, dims[0]), device=dev, generator=g)
                ws4, bs4 = cs.rand_mlp(torch, dev, g, dims)
                ge4 = torch.randn((8, 8, 128 * 128, 128), device=dev, generator=g)
                gm4 = torch.randn((8, 128 * 128, 128), device=dev, generator=g)
                plan4 = pf.embed_bwd_tc_plan(8, 128 * 128, *dims, sms=sms)
                wp4, bias4 = pf._packed_embed_tf32(ws4, bs4, plan4.form)
                k4b_args[path] = (x4, ge4, gm4, ws4, bs4, wp4, bias4, plan4, acts4, dx4)

        def k4b(lib, x4, ge4, gm4, ws4, bs4, wp4, bias4, plan4, acts4, dx4):
            dx = torch.empty_like(x4) if dx4 else None
            parts = torch.empty(plan4.blocks * plan4.parts, dtype=torch.float32, device=dev)
            out = torch.empty(plan4.parts, dtype=torch.float32, device=dev)
            fn = lib.wcmc_pathnet_embed_bwd_tf32
            fn.argtypes, fn.restype = [P] * 8 + [I] * 11 + [P], I
            _build.check(fn(x4.data_ptr(), ge4.data_ptr(), gm4.data_ptr(), wp4.data_ptr(),
                            bias4.data_ptr(), None if dx is None else dx.data_ptr(),
                            parts.data_ptr(), out.data_ptr(), 8, 8, 128 * 128, x4.shape[-1],
                            *plan4.form, *acts4, plan4.blocks, 0, stream), "pathnet_embed_bwd")
            return dx, out

        if "k5f" in kernels:
            # KPCN's training head: 8 x 8 spp x 128^2 rows, [128 | 128] -> 256 -> 6 with
            # moments, channel-major f32 output
            e5f = torch.randn((8, 8, 128 * 128, 128), device=dev, generator=g)
            ctx5f = torch.randn((8, 128 * 128, 128), device=dev, generator=g)
            ws5f, bs5f = cs.rand_mlp(torch, dev, g, (256, 256, 6))
            plan5f = pf.head_fwd_tc_plan(8, 128 * 128, 128, 128, 256, 6, sms=sms)
            wp5f, b15f, b25f = pf._packed_head_tf32(ws5f, bs5f, 128, plan5f.form)

        def k5f(lib):
            out = torch.empty((8, 8, 6, 128 * 128), dtype=torch.float32, device=dev)
            ssum = torch.empty((8, 128 * 128, 6), dtype=torch.float32, device=dev)
            ssq = torch.empty_like(ssum)
            fn = lib.wcmc_pathnet_head_tf32
            fn.argtypes, fn.restype = [P] * 8 + [I] * 13 + [P], I
            _build.check(fn(e5f.data_ptr(), ctx5f.data_ptr(), wp5f.data_ptr(), b15f.data_ptr(),
                            b25f.data_ptr(), out.data_ptr(), ssum.data_ptr(), ssq.data_ptr(), 8,
                            8, 128 * 128, *plan5f.form, 6, 1, 1, 0, 1, plan5f.blocks, 0, stream),
                         "pathnet_head")
            return out, ssum, ssq

        if "k4f" in kernels:
            from wcmc_tpu_torch.ops import pathnet_fused as pf

            # KPCN's PathNet (36 -> 128^3, relu relu linear) and Multisteps (95 ->
            # 128^3 leaky) over 8 x 8 spp x 128^2 rows
            k4f_args = {}
            for path, dims, acts4 in (("kpcn", (36, 128, 128, 128), pf.EMBED_ACTS),
                                      ("sbmc", (95, 128, 128, 128), pf.LEAKY)):
                x4 = torch.randn((8, 8, 128 * 128, dims[0]), device=dev, generator=g)
                ws4, bs4 = cs.rand_mlp(torch, dev, g, dims)
                plan4 = pf.embed_fwd_tc_plan(8, 128 * 128, *dims, sms=sms)
                wp4, bias4 = pf._packed_embed_tf32(ws4, bs4, plan4.form)
                k4f_args[path] = (x4, ws4, bs4, wp4, bias4, plan4, acts4)

        def k4f(lib, x4, ws4, bs4, wp4, bias4, plan4, acts4):
            e = torch.empty((8, 8, 128 * 128, 128), dtype=torch.float32, device=dev)
            mean = torch.empty((8, 128 * 128, 128), dtype=torch.float32, device=dev)
            fn = lib.wcmc_pathnet_embed_tf32
            fn.argtypes, fn.restype = [P] * 5 + [I] * 12 + [P], I
            _build.check(fn(x4.data_ptr(), wp4.data_ptr(), bias4.data_ptr(), e.data_ptr(),
                            mean.data_ptr(), 8, 8, 128 * 128, x4.shape[-1], 128, *plan4.form,
                            *(mf.ACTS.index(a) for a in acts4), plan4.blocks, 0, stream),
                         "pathnet_embed")
            return e, mean

        if "k10b" in kernels:
            # LBMC's K10-bwd at f32: 8 patches x 8 spp x 128^2 rows, 32 -> 32^3 leaky, d(x)
            xb = torch.randn((8 * 8 * 128 * 128, 32), device=dev, generator=g)
            gb = torch.randn((8 * 8 * 128 * 128, 32), device=dev, generator=g)
            actsb = ("leaky_relu",) * 3
            wsb, bsb = cs.rand_mlp(torch, dev, g, (32, 32, 32, 32))
            planb = mf.mlp_bwd_tc_plan(32, (32, 32, 32), actsb)
            wpb, biasb = mf.pack_mlp_tf32(*wsb, *bsb)

        def k10b(lib):
            n = xb.shape[0]
            grid = planb.grid(n, sms)
            dx = torch.empty_like(xb)
            parts = torch.empty(grid * planb.parts, dtype=torch.float32, device=dev)
            out = torch.empty(planb.parts, dtype=torch.float32, device=dev)
            fn = lib.wcmc_mlp_fused_bwd_tf32
            fn.argtypes, fn.restype = [P] * 7 + [L] + [I] * 6 + [P], I
            _build.check(fn(xb.data_ptr(), gb.data_ptr(), wpb.data_ptr(), biasb.data_ptr(),
                            dx.data_ptr(), parts.data_ptr(), out.data_ptr(), n, 32,
                            *(mf.ACTS.index(a) for a in actsb), grid, 0, stream),
                         "mlp_fused_bwd")
            return dx, out

        if "k6" in kernels:
            from wcmc_tpu_torch.ops import conv5

            # the fused KPCN's layer 5: (8, 112, 112, 100) at a pitch of 104 -> 100, relu
            x6 = conv5._pitched(torch.randn((8, 112, 112, 100), device=dev, generator=g), 104,
                                fill=0)
            w6 = torch.randn((5, 5, 100, 100), device=dev, generator=g) / (25 * 100) ** 0.5
            b6 = 0.1 * torch.randn(100, device=dev, generator=g)
            plan6 = conv5.conv_tc_plan(100, 100, 5)
            wp6 = conv5.pack_weights_tf32(w6, plan6.n, plan6.chunk, plan6.cin_pad)
            ref6 = torch.relu(torch.nn.functional.conv2d(
                x6.double().permute(0, 3, 1, 2), w6.double().permute(3, 2, 0, 1),
                b6.double())).permute(0, 2, 3, 1)

        def k6(lib):
            y = torch.empty((8, 108, 108, 100), dtype=torch.float32, device=dev)
            fn = lib.wcmc_conv5_tf32
            fn.argtypes, fn.restype = [P] * 4 + [I] * 4 + [L] * 3 + [I] * 8 + [P], I
            _build.check(fn(x6.data_ptr(), wp6.data_ptr(), b6.data_ptr(), y.data_ptr(), 8, 112,
                            112, 100, *x6.stride()[:3], 100, 100, 5, plan6.n, plan6.cin_pad,
                            plan6.chunk, 1, 0, stream), "conv5")
            return y
        for name, lib in libs.items():
            kernel = name.split("_")[0]
            if kernel == "k10":
                def call(lib=lib):
                    return k10(lib, x, ws, bs, acts)
                todo = [("lbmc", call, "mlp_fused", 1)]
            elif kernel == "k5b":
                todo = [("kpcn", lambda lib=lib: k5b(lib), "pathnet_head_bwd", 1)]
            elif kernel == "k6":
                todo = [("kpcn_fused", lambda lib=lib: k6(lib), "conv5", 1)]
            elif kernel == "k4b":
                todo = [(path, lambda lib=lib, a=args: k4b(lib, *a), "pathnet_embed_bwd", 1)
                        for path, args in k4b_args.items()]
            elif kernel == "k5f":
                todo = [("kpcn", lambda lib=lib: k5f(lib), "pathnet_head", 1)]
            elif kernel == "k4f":
                todo = [(path, lambda lib=lib, a=args: k4f(lib, *a), "pathnet_embed", 1)
                        for path, args in k4f_args.items()]
            elif kernel == "k10b":
                todo = [("lbmc", lambda lib=lib: k10b(lib), "mlp_fused_bwd", 1)]
            elif kernel == "k9":
                todo = [("sbmc", lambda lib=lib: k9(lib, *k9_args), "gather", 1)]
            else:
                fn, counter, per_call = runs[kernel]
                # KPCN's K = 21 runs K3's gather body
                todo = [(path, lambda lib=lib, a=args, fn=fn: fn(lib, *a), counter, per_call)
                        for path, args in shapes.items() if kernel != "k3" or path == "lbmc"]
            for path, call, counter, per_call in todo:
                rec = {"variant": name, "path": path, "ms": cs.time_ms(torch, call, 20, flush),
                       "device_ms": cs.device_ms(torch, call, counter, flush, per_call=per_call)}
                if kernel == "k5b":
                    got = call()
                    rec["from_f64"] = k5b_f64(got, pf.HEAD_ACTS)
                if name == "k5b_whole":
                    # the same source as the wrapper's library: the same bits
                    want = pf._head_bwd_kernel(e5, ctx5, *cot5, ws5, bs5, pf.HEAD_ACTS, True)
                    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                        raise AssertionError("k5b_whole is not the wrapper's bits")
                    lin = ("linear", "linear")
                    rec["from_f64_others"] = {
                        "simt": k5b_f64(pf._head_bwd_kernel(e5, ctx5, *cot5, ws5, bs5,
                                                            pf.HEAD_ACTS, True, body="simt"),
                                        pf.HEAD_ACTS),
                        "plain": k5b_f64(pf._head_bwd_plain(e5, ctx5, *cot5, ws5, bs5,
                                                            pf.HEAD_ACTS, True), pf.HEAD_ACTS)}
                    rec["from_f64_linear"] = {
                        "tc": k5b_f64(k5b(lib, (0, 0)), lin),
                        "simt": k5b_f64(pf._head_bwd_kernel(e5, ctx5, *cot5, ws5, bs5, lin,
                                                            True, body="simt"), lin),
                        "plain": k5b_f64(pf._head_bwd_plain(e5, ctx5, *cot5, ws5, bs5, lin,
                                                            True), lin)}
                elif kernel == "k6":
                    rec["from_f64"] = cs.rel_l2(torch, call(), ref6)
                    if name == "k6_whole":
                        lib_y = torch.relu(torch.nn.functional.conv2d(
                            x6.permute(0, 3, 1, 2), w6.permute(3, 2, 0, 1), b6))
                        rec["from_f64_others"] = {
                            "simt": cs.rel_l2(torch, conv5._conv_kernel(
                                x6, w6, b6, 5, "relu", body="simt"), ref6),
                            "cudnn": cs.rel_l2(torch, lib_y.permute(0, 2, 3, 1), ref6)}
                elif name in ("k4b_whole", "k5f_whole"):
                    # the same source as the wrapper's library: the same bits
                    got = call()
                    if kernel == "k4b":
                        x4, ge4, gm4, ws4, bs4, *_, dx4 = k4b_args[path]
                        acts = (pf.EMBED_ACTS if path == "kpcn" else pf.LEAKY)
                        want = pf._embed_bwd_kernel(x4, ge4, gm4, ws4, bs4, acts, dx4)
                        kc0, kc = k4b_args[path][7].form
                        same = torch.equal(got[1][:kc0 * kc].view(kc0, kc)[:x4.shape[-1]],
                                           want[1][0])
                    else:
                        want = pf._head_fwd_kernel(e5f, ctx5f, ws5f, bs5f, pf.HEAD_ACTS, True,
                                                   True, torch.float32)
                        same = all(torch.equal(a, w) for a, w in zip(got, want))
                    if not same:
                        raise AssertionError(f"{name} at {path} is not the wrapper's bits")
                elif name in ("k4f_whole", "k10b_whole"):
                    # the same source as the wrapper's library: the same bits
                    got = call()
                    if kernel == "k4f":
                        x4, ws4, bs4, *_, acts4 = k4f_args[path]
                        want = pf._embed_fwd_kernel(x4, ws4, bs4, acts4)
                        same = all(torch.equal(a, w) for a, w in zip(got, want))
                    else:
                        want = mf.mlp_fused_bwd(xb, gb, wsb, bsb, actsb, True)
                        same = (torch.equal(got[0], want[0])
                                and torch.equal(got[1][:32 * 32].view(32, 32), want[1][0]))
                    if not same:
                        raise AssertionError(f"{name} at {path} is not the wrapper's bits")
                elif name.endswith("_whole"):
                    check_whole(torch, cs, ka, mf, kernel, path, call(),
                                k9_args if kernel == "k9" else shapes.get(path),
                                (x, ws, bs, acts))
                print(json.dumps(rec), flush=True)
    return 0


def check_whole(torch, cs, ka, mf, kernel, path, got, tensors, mlp):
    """A whole body's output against its first body's (K1, K2, K9 and
    K10-fwd bit for bit, K3 within K1_TOL of its gather body)."""
    if kernel == "k10":
        ref = mf._mlp_fwd_kernel(*mlp, body="wmma")
    elif kernel == "k9":
        ref = ka.gather(*tensors, body="warp")
    else:
        cot, buf, lg, k = tensors
        if kernel == "k3":
            cs.max_err(torch, [got], [ka.scatter_softmax(cot, lg, k, body="gather")], cs.K1_TOL)
            return
        ref = (ka.gather_softmax(buf, lg, k, body="warp") if kernel == "k1"
               else ka.outer_softmax(cot, buf, lg, k, body="warp"))
    if not torch.equal(got, ref):
        raise AssertionError(f"{kernel} at {path} is not its first body's bits")


if __name__ == "__main__":
    sys.exit(main())
