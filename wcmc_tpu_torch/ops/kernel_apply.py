"""Per-pixel kernel application (gather) — the KPCN hot op.

Counterpart of the forward of ``wcmc_tpu/ops/kernel_apply.py``:

* ``kernel_gather_softmax(buf, logits, K)``:
  ``out[p, c] = sum_d softmax_d(logits[p]) * buf[p + d, c]``
  — the hand-written CUDA kernel K1 (``csrc/gather_softmax.cu``) for
  CUDA tensors, its plain version ``gather_softmax_plain`` for CPU
  tensors;
* ``kernel_apply`` / ``kernel_apply_reference``: the public API.

Geometry (channels-last): ``buf (B, H, W, C)``, logits
``(B, h, w, K*K)`` with ``h = H - K + 1``; output ``(B, h, w, C)``.
The backward (scatter and outer products) comes with the training port.
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


def _check_geometry(buf, logits, ksize):
    if buf.dim() != 4 or logits.dim() != 4:
        raise ValueError("buf and logits must be (B, H, W, C) and (B, h, w, K*K)")
    b, H, W, _ = buf.shape
    want = (b, H - ksize + 1, W - ksize + 1, ksize * ksize)
    if ksize < 1 or ksize % 2 == 0 or want[1] < 1 or want[2] < 1:
        raise ValueError(f"gather: buffer {H}x{W} and odd ksize {ksize} give no output")
    if tuple(logits.shape) != want:
        raise ValueError(f"logits shape {tuple(logits.shape)} != {want}")


def kernel_gather_softmax(buf, logits, ksize: int):
    """Softmax-normalized per-pixel gather; ``logits`` f32 or bf16.

    CPU tensors run the plain version.  CUDA tensors launch the K1
    kernel: the softmax is computed in f32 inside the kernel, so the
    probability tensor never exists in device memory.  The logits may be
    a strided view (e.g. the crop of a convolution output) as long as
    the K*K taps of a pixel are contiguous."""
    _check_geometry(buf, logits, ksize)
    if buf.device.type == "cpu" and logits.device.type == "cpu":
        return gather_softmax_plain(buf, logits, ksize)
    if buf.device.type != "cuda" or logits.device != buf.device:
        raise ValueError(f"gather_softmax: buf on {buf.device}, logits on "
                         f"{logits.device}; both must be on one CUDA device")
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gather_softmax: logits dtype {logits.dtype} is not "
                        "float32 or bfloat16")
    if logits.stride(-1) != 1:
        raise ValueError("gather_softmax: the K*K taps of a pixel must be "
                         "contiguous (logits.stride(-1) == 1)")
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


def kernel_apply(buf, kernels, ksize: int, softmax: bool = True):
    """KPCN-style weighted-neighborhood reconstruction.

    Args:
      buf:     (B, H, W, C) radiance buffer.
      kernels: (B, h, w, K*K) per-pixel kernel logits, h = H - K + 1.
      softmax: normalize each pixel's K*K window with a softmax.  Only
        the softmax form is ported; the plain weighted gather (kernel K9)
        comes with the SBMC port.
    Returns:
      (B, h, w, C) reconstruction.
    """
    if not softmax:
        raise NotImplementedError("kernel_apply(softmax=False) is not ported yet")
    return kernel_gather_softmax(buf, kernels, ksize)


def kernel_apply_reference(buf, kernels, ksize: int, softmax: bool = True):
    """Plain version of :func:`kernel_apply` on any device: the softmax
    runs in ``kernels``' dtype, as in the reference."""
    if softmax:
        kernels = torch.softmax(kernels, dim=-1)
    return _gather_plain(buf, kernels, ksize)
