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
  the saved output, then library convolutions for d(x) and d(w).

The kernel computes bfloat16 only and raises ``ValueError`` for another
dtype, as for a shape it does not take.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from wcmc_tpu_torch.ops import _build
from wcmc_tpu_torch.ops.mlp_fused import _act

# activation codes of the kernel (mlp_act of csrc/mlp.cuh)
ACT_CODES = {None: 0, "linear": 0, "relu": 1, "leaky_relu": 2}
COUT_BLOCK = 112     # output channels per block of csrc/conv5.cu (kConvNC)
MAX_BATCH = 65535    # the kernel's grid takes the batch as its z extent


def _check_args(x, w, bias, ksize, act):
    if act not in ACT_CODES:
        raise ValueError(f"conv2d computes the activations {tuple(ACT_CODES)}, got {act!r}")
    if x.dim() != 4:
        raise ValueError(f"conv2d takes x (B, H, W, Cin), got {tuple(x.shape)}")
    cin = x.shape[-1]
    if w.dim() != 4 or tuple(w.shape[:3]) != (ksize, ksize, cin) or \
            tuple(bias.shape) != (w.shape[-1],):
        raise ValueError(f"conv2d: weight {tuple(w.shape)} / bias {tuple(bias.shape)} is not "
                         f"({ksize}, {ksize}, {cin}, Cout) / (Cout,)")
    if x.shape[1] < ksize or x.shape[2] < ksize:
        raise ValueError(f"conv2d: input {tuple(x.shape)} is smaller than the {ksize}x{ksize} "
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


def _conv_kernel(x, w, bias, ksize, act):
    _check_args(x, w, bias, ksize, act)
    dev = x.device
    if dev.type != "cuda" or w.device != dev or bias.device != dev:
        raise ValueError("conv5: inputs must all be on one CUDA device, got "
                         f"{x.device}, {w.device}, {bias.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"conv5 kernel computes in bfloat16, got {x.dtype}")
    b, h, wd, cin = x.shape
    cout = w.shape[-1]
    if b > MAX_BATCH:
        raise ValueError(f"conv5 kernel takes at most {MAX_BATCH} images, got {b}")
    y = torch.empty((b, h - ksize + 1, wd - ksize + 1, cout), dtype=torch.bfloat16, device=dev)
    if b == 0:
        return y
    x = x.contiguous()
    # the weights in x's dtype, zero-padded to whole 16-row taps and whole
    # 112-column block slices, the layout the kernel streams
    cin_pad = -(-cin // 16) * 16
    cout_pad = -(-cout // COUT_BLOCK) * COUT_BLOCK
    wp = torch.zeros((ksize, ksize, cin_pad, cout_pad), dtype=torch.bfloat16, device=dev)
    wp[:, :, :cin, :cout] = w
    bf = bias.float().contiguous()
    P, INT = _build.PTR, _build.INT
    fn = _build.kernel("wcmc_conv5", P, P, P, P, *([INT] * 10), P)
    idx = dev.index or 0
    _build.check(fn(x.data_ptr(), wp.data_ptr(), bf.data_ptr(), y.data_ptr(), b, h, wd, cin,
                    cout, ksize, cin_pad, cout_pad, ACT_CODES[act], idx, _build.stream_of(dev)),
                 "conv5")
    _build.launches["conv5"] += 1
    return y


def _act_grad_mask(act, y, g):
    """The activation's gradient through the saved output ``y``, as the
    reference's ``_act_grad_mask`` takes it."""
    if act in (None, "linear"):
        return g
    if act == "relu":
        return torch.where(y > 0, g, torch.zeros((), dtype=g.dtype, device=g.device))
    return torch.where(y > 0, g, 0.01 * g)


class _Conv2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, ksize, act):
        if x.device.type == "cpu":
            y = conv2d_plain(x, w, bias, ksize, act)
        else:
            y = _conv_kernel(x, w, bias, ksize, act)
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
        return dx, dw, db, None, None


def conv2d(x, w, bias, ksize: int, act=None):
    """VALID ``ksize`` x ``ksize`` convolution + bias + activation over
    channels-last ``x (B, H, W, Cin)`` in the compute dtype; ``w (K, K,
    Cin, Cout)`` and ``bias (Cout,)`` f32 parameters.  Returns ``(B, H - K
    + 1, W - K + 1, Cout)`` in ``x``'s dtype.  K6 for CUDA tensors, the
    plain version for CPU tensors; differentiable in all three inputs."""
    return _Conv2d.apply(x, w, bias, ksize, act)
