"""Reusable building blocks: a plain convolution chain, the per-pixel
MLP and a U-Net.

Counterpart of ``wcmc_tpu/models/blocks.py``.  Modules take and return
NCHW tensors (the models pass channels-last memory, i.e. permuted views
of the reference's NHWC tensors).  Parameters stay float32; with a
compute ``dtype`` every convolution casts its input, weight and bias to
it explicitly and returns that dtype, as flax's ``nn.Conv(dtype=...)``
does.  Sub-modules are named like the flax param tree (``Conv_0``, ...)
so ``convert.py`` maps checkpoints one to one; fresh parameters use
flax's init (``lecun_normal`` weights, zero biases).  ``ConvChain``'s
fused route (the reference's ``fused=True``) takes and returns NHWC.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from wcmc_tpu_torch.ops.conv5 import conv2d, conv2d_padded
from wcmc_tpu_torch.ops.mlp_fused import fused_mlp

# stddev of a unit normal truncated to [-2, 2] (flax's lecun_normal)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, fan_in: int, generator=None):
    """flax ``lecun_normal``: truncated normal, variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    return t


def make_conv(cin: int, cout: int, ksize: int, generator=None, cls=nn.Conv2d) -> nn.Conv2d:
    conv = cls(cin, cout, ksize, device="meta").to_empty(device="cpu")
    lecun_normal_(conv.weight, cin * ksize * ksize, generator)
    nn.init.zeros_(conv.bias)
    return conv


def conv_apply(conv: nn.Conv2d, x, dtype=None, padding=0):
    w, b = conv.weight, conv.bias
    if dtype is not None:
        x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
    return F.conv2d(x, w, b, padding=padding)


class FusedConv(nn.Conv2d):
    """An ``nn.Conv2d`` (weight (Cout, Cin, K, K) and bias, made by
    ``make_conv``: the same ``state_dict`` keys, layout and init) that
    can also run channels-last through the fused convolution K6
    (``ops/conv5.py``), its bias and activation fused into the store:
    :meth:`fused`.  Counterpart of the reference's ``FusedConv``."""

    def fused(self, x, act=None, dtype=None, padded=False):
        """``x (B, H, W, Cin)`` -> ``(B, H - K + 1, W - K + 1, Cout)`` in
        ``dtype`` (or ``x``'s), rounded once after the bias and
        activation; with ``padded``, as the view that ``conv2d_padded``
        returns."""
        if dtype is not None:
            x = x.to(dtype)
        conv = conv2d_padded if padded else conv2d
        return conv(x, self.weight.permute(2, 3, 1, 0), self.bias, self.kernel_size[0], act)


class ConvChain(nn.Module):
    """``depth`` stacked VALID convolutions (shrink ``ksize - 1`` pixels
    each), ReLU between them, linear output.  Two routes over the same
    parameters, chosen per call: by default NCHW in and out through
    library convolutions; with ``fused`` (the reference's
    ``ConvChain(fused=True)``) NHWC in and out, every layer through
    ``FusedConv.fused``, the hidden layers at the padded pixel pitch of
    ``conv2d_padded``."""

    def __init__(self, in_channels: int, out_channels: int, width: int = 64,
                 depth: int = 3, ksize: int = 3, dtype=None, generator=None):
        super().__init__()
        self.depth, self.dtype = depth, dtype
        cin = in_channels
        for i in range(depth):
            cout = out_channels if i == depth - 1 else width
            self.add_module(f"Conv_{i}", make_conv(cin, cout, ksize, generator, FusedConv))
            cin = cout

    def forward(self, x, fused: bool = False):
        if fused:
            for i in range(self.depth):
                hidden = i < self.depth - 1
                x = getattr(self, f"Conv_{i}").fused(x, "relu" if hidden else None, self.dtype,
                                                     padded=hidden)
            return x
        for i in range(self.depth):
            x = conv_apply(getattr(self, f"Conv_{i}"), x, self.dtype)
            if i < self.depth - 1:
                x = F.relu(x)
        return x


class PixelMLP(nn.Module):
    """Per-pixel MLP, a ``ConvChain(ksize=1)`` computed by the fused
    kernel K10 (``ops/mlp_fused.py``), so the hidden activations never
    reach device memory.  Parameters ``w{i}`` (C_{i-1}, C_i) and ``b{i}``
    stay f32 with flax's init; the chain computes in ``dtype``.  Takes and
    returns channels-last ``(..., C)``.  ``compute_dx`` is False when the
    input is data, which skips d(x) in the backward kernel."""

    def __init__(self, in_channels: int, features, acts, compute_dx: bool = True,
                 dtype=None, generator=None):
        super().__init__()
        if len(features) != len(acts):
            raise ValueError("PixelMLP: features and acts differ in length")
        self.features, self.acts = tuple(features), tuple(acts)
        self.compute_dx, self.dtype = compute_dx, dtype
        cin = in_channels
        for i, f in enumerate(self.features):
            w = nn.Parameter(torch.empty(cin, f))
            lecun_normal_(w, cin, generator)
            self.register_parameter(f"w{i}", w)
            self.register_parameter(f"b{i}", nn.Parameter(torch.zeros(f)))
            cin = f

    def forward(self, x):
        n = len(self.features)
        flat = x.reshape(-1, x.shape[-1])
        if self.dtype is not None:
            flat = flat.to(self.dtype)
        y = fused_mlp(flat, [getattr(self, f"w{i}") for i in range(n)],
                      [getattr(self, f"b{i}") for i in range(n)], self.acts, self.compute_dx)
        return y.reshape(x.shape[:-1] + (self.features[-1],))


class UNet(nn.Module):
    """Symmetric encoder/decoder over 3 levels (widths ``width``,
    ``2 width``, ``4 width``) with ``num_convs`` SAME 3x3 convs + leaky
    ReLU per block, 2x2 max-pool downsampling, nearest upsampling, skip
    concatenation and a leaky-ReLU output conv.  Output matches input
    size (spatial dims divisible by 4).  These are the only settings the
    reference's models use."""

    LEVELS = 3

    def __init__(self, in_channels: int, out_channels: int, width: int = 64,
                 num_convs: int = 3, dtype=None, generator=None):
        super().__init__()
        self.num_convs, self.dtype = num_convs, dtype
        widths = [width * 2**lvl for lvl in range(self.LEVELS)]
        # flax names convs in call order: down levels, bottom, up levels, out
        ins, outs = [], []
        cin = in_channels
        for w in widths:
            ins += [cin] + [w] * (num_convs - 1)
            outs += [w] * num_convs
            cin = w
        prev = widths[-1]
        for w in reversed(widths[:-1]):
            ins += [prev + w] + [w] * (num_convs - 1)
            outs += [w] * num_convs
            prev = w
        ins.append(widths[0])
        outs.append(out_channels)
        for i, (ci, co) in enumerate(zip(ins, outs)):
            self.add_module(f"Conv_{i}", make_conv(ci, co, 3, generator))

    def forward(self, x):
        idx = 0

        def conv(x):
            nonlocal idx
            x = conv_apply(getattr(self, f"Conv_{idx}"), x, self.dtype, padding=1)
            idx += 1
            return F.leaky_relu(x, negative_slope=0.01)

        def block(x):
            for _ in range(self.num_convs):
                x = conv(x)
            return x

        skips = []
        for _ in range(self.LEVELS - 1):
            x = block(x)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)
        x = block(x)
        for skip in reversed(skips):
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = block(torch.cat([x, skip], dim=1))
        return conv(x)


def dual_unet_apply(unet_a: UNet, unet_b: UNet, xa, xb):
    """Run two identically-configured UNets (different weights).  The
    reference merges their narrow levels block-diagonally for the TPU's
    matrix unit; the math is two plain applies, which is what runs here.
    Returns (ya, yb)."""
    return unet_a(xa), unet_b(xb)
