#!/usr/bin/env python3
"""What bounds the new bodies of K2 and K3 (the softmax gather's backward) on
one NVIDIA card: each is built again from a copy of
``wcmc_tpu_torch/ops/csrc`` with one part of its work dropped, and every
variant is timed at the path shapes beside the whole body.

    python3 chip_parts.py

K2 (``outer_softmax_tiled_kernel``) at LBMC's shape (8 x 128^2, K 13, layer
1's bf16 slice of a channels-last kernel head) and at KPCN's (8 x 72^2, K 21,
the crop of a channels-last convolution output): ``whole``; ``no_compute``
(no pixel's softmax, dp or gradient: the landing, the barriers and the
stores); ``no_logits`` (no logit lands: the arithmetic on stale shared
memory); ``no_store`` (the gradients never leave shared memory).  K3
(``scatter_softmax_banded_kernel`` and its band sums) at LBMC's shape:
``whole``; ``no_convert`` (no probability is computed); ``no_taps`` (no tap
loop); ``no_logits``.  A dropped part leaves wrong outputs; only ``whole`` is
checked (K2 bit for bit against its first body, K3 within 1e-5 of its gather
body).  Each line: the variant, the path, the CUDA-event ms and the
profiler's device ms (``chip_smoke.py``'s ``time_ms`` and ``device_ms``).
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
K2_SRC, K3_SRC = "outer_softmax.cu", "scatter_softmax.cu"
NO_LOGITS = ("for (int ch = lane; 16 * ch <", "for (int ch = 32; 16 * ch <")
VARIANTS = {
    "k2_whole": (K2_SRC, []),
    "k2_no_compute": (K2_SRC, [("      for (int p = warp; p < n; p += kWarps) {\n"
                                "        // the first body's softmax",
                                "      for (int p = warp; p < 0; p += kWarps) {\n"
                                "        // the first body's softmax")]),
    "k2_no_logits": (K2_SRC, [NO_LOGITS]),
    "k2_no_store": (K2_SRC, [("if (aligned16(dst) && bytes % 16 == 0) {", "if (false) {"),
                             ("for (int e = tid; e < n * K2; e += kThreads) dst[e] = out[e];",
                              "")]),
    "k3_whole": (K3_SRC, []),
    "k3_no_convert": (K3_SRC, [("      ok[i] = p < n;\n", "      ok[i] = false;\n")]),
    "k3_no_taps": (K3_SRC, [("      splat_step<kC, kK, S>(s_p, s_x, s_ring, K, Wc, cols, wcj, yl, "
                             "r, g, ndy);", "")]),
    "k3_no_logits": (K3_SRC, [NO_LOGITS]),
}


def build(nvcc, flags, csrc, work):
    """Each variant's library, all nvcc processes started together."""
    procs = {}
    for name, (src, subs) in VARIANTS.items():
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

    if not torch.cuda.is_available():
        print("chip_parts: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from wcmc_tpu_torch.ops import _build
    from wcmc_tpu_torch.ops import kernel_apply as ka

    print(cs.nvidia_smi_line(), flush=True)
    with tempfile.TemporaryDirectory() as work:
        libs = build(_build._nvcc(), _build.NVCC_FLAGS, str(_build.CSRC), work)
        dev = torch.device("cuda", 0)
        sms = _build.sm_count(0)
        stream = _build.stream_of(dev)
        g = torch.Generator(device=dev).manual_seed(cs.SEED)
        flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

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

        def k3(lib, cot, lg, k):
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
        for name, lib in libs.items():
            for path, (cot, buf, lg, k) in shapes.items():
                if name.startswith("k2"):
                    def call(lib=lib, cot=cot, buf=buf, lg=lg, k=k):
                        return k2(lib, cot, buf, lg, k)
                    counter, per_call = "outer_softmax", 1
                elif path == "lbmc":
                    def call(lib=lib, cot=cot, lg=lg, k=k):
                        return k3(lib, cot, lg, k)
                    counter, per_call = "scatter_softmax", 2
                else:   # KPCN's K = 21 runs K3's gather body
                    continue
                rec = {"variant": name, "path": path, "ms": cs.time_ms(torch, call, 20, flush),
                       "device_ms": cs.device_ms(torch, call, counter, flush, per_call=per_call)}
                if name == "k2_whole":
                    ref = ka.outer_softmax(cot, buf, lg, k, body="warp")
                    if not torch.equal(call(), ref):
                        raise AssertionError(f"K2 at {path} is not its first body's bits")
                elif name == "k3_whole":
                    cs.max_err(torch, [call()], [ka.scatter_softmax(cot, lg, k, body="gather")],
                               cs.K1_TOL)
                print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
