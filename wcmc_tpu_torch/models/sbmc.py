"""SBMC "Multisteps": the sample-space kernel-splatting denoiser.

Counterpart of ``wcmc_tpu/models/sbmc.py`` (the [Gharbi 2019] backbone
under the reference's SBMC training interface):

* a per-sample embedding of the features with its sample mean (kernel
  K4-fwd, leaky relu on every layer), RMS-normalized per image;
* ``n_steps`` rounds of context propagation: a U-Net over the sample
  mean, RMS-normalized, then the per-sample update chain over [embedding
  | broadcast context] (kernel K5-fwd, leaky relu, output in the compute
  dtype) whose f32 sample sum is the next round's mean;
* a 1x1 ``kernel_head`` that predicts a K x K splatting kernel per
  sample, its logits standardized per image (gain 10) and soft-capped at
  +-25, and the splat of each sample's radiance (kernel K7), normalized
  by the total weight reaching each pixel (``exp`` weighting, the
  default) or by softmax kernels (``softmax``, an ablation).

Input ``{'radiance' (B, S, H, W, 3), 'features' (B, S, H, W, n_in)}``,
output ``(B, H, W, 3)`` float32.  Parameters are named like the flax
tree (``embedding_w0``, ``propagation_0``, ``update_0_w0``,
``kernel_head``, ...) so ``convert.py`` maps checkpoints by path.  With
``sample_group`` set (a copy made by ``parallel/sample.py``; forward
only), the reference's ``sample_axis_name`` mode: the sample axis is
sharded over that group's ranks, and the RMS normalization's mean
square, the step context, the logits' centre and variance become means
over the ranks of each rank's own, and the splat's sums and window max
collectives (``ops/splat.py``); exact for equal shards.
"""

from __future__ import annotations

import torch
from torch import nn

from wcmc_tpu_torch.models.blocks import UNet, conv_apply, lecun_normal_, make_conv
from wcmc_tpu_torch.ops.pathnet_fused import pathnet_embed, pathnet_head
from wcmc_tpu_torch.ops.splat import splat_normalized, splat_normalized_logits
from wcmc_tpu_torch.parallel.collectives import all_mean

LEAKY = ("leaky_relu",) * 3
# the splat logits' standardization gain: l -> 10 (l - mean) / sqrt(var + 1)
SPLAT_LOGIT_GAIN = 10.0


def _stage_rms(v, ref=None, group=None):
    """Per-image RMS normalization at a stage boundary: the mean of
    squares in f32 (over ``group``'s ranks too: ``v``'s sample axis is
    sharded over them), ``r = rsqrt(ms + 1e-8)``; ``v`` is scaled by
    ``r`` rounded to its dtype, in its dtype, and ``ref`` (the sample
    mean that travels with ``v``) by the same ``r`` in ``ref``'s dtype."""
    ms = v.float().square().mean(dim=tuple(range(1, v.dim())), keepdim=True)
    ms = all_mean(ms, group)
    r = torch.rsqrt(ms + 1e-8)
    out = v * r.to(v.dtype)
    if ref is None:
        return out
    rr = r.reshape(r.shape[0], *([1] * (ref.dim() - 1)))
    return out, ref * rr.to(ref.dtype)


class Multisteps(nn.Module):
    def __init__(self, n_in: int, ksize: int = 21, n_steps: int = 3, width: int = 128,
                 dtype=None, splat_weighting: str = "exp", generator=None):
        super().__init__()
        if splat_weighting not in ("exp", "softmax"):
            raise ValueError(f"unknown splat weighting {splat_weighting!r}")
        self.n_in, self.ksize, self.n_steps, self.width = n_in, ksize, n_steps, width
        self.dtype, self.splat_weighting = dtype, splat_weighting
        self.sample_group = None
        self._chain("embedding", (n_in, width, width, width), generator)
        for step in range(n_steps):
            self.add_module(f"propagation_{step}",
                            UNet(width, width, width=width, num_convs=3, dtype=dtype,
                                 generator=generator))
            self._chain(f"update_{step}", (2 * width, width, width), generator)
        self.kernel_head = make_conv(width, ksize * ksize, 1, generator)

    def _chain(self, name, dims, generator):
        for i, (ci, co) in enumerate(zip(dims[:-1], dims[1:])):
            w = nn.Parameter(torch.empty(ci, co))
            lecun_normal_(w, ci, generator)
            self.register_parameter(f"{name}_w{i}", w)
            self.register_parameter(f"{name}_b{i}", nn.Parameter(torch.zeros(co)))

    def _params(self, name: str, n: int):
        return ([getattr(self, f"{name}_w{i}") for i in range(n)],
                [getattr(self, f"{name}_b{i}") for i in range(n)])

    def forward(self, batch: dict) -> torch.Tensor:
        radiance, features = batch["radiance"], batch["features"]
        b, s, h, w, f = features.shape
        if f != self.n_in:
            raise ValueError(f"Multisteps expects {self.n_in} channels, got {f}")
        wd, k = self.width, self.ksize
        cdtype = self.dtype or torch.float32

        # compute_dx: under use_llpm_buf the features carry the learned
        # p-buffer, so d(features) flows back to the PathNet
        x, mean = pathnet_embed(features.reshape(b, s, h * w, f).to(cdtype),
                                *self._params("embedding", 3), LEAKY, compute_dx=True)
        group = self.sample_group
        x, mean = _stage_rms(x, mean, group)
        for step in range(self.n_steps):
            # channels-last: the U-Net runs on a permuted view of (B, H, W, C)
            ctx = all_mean(mean.reshape(b, h, w, wd), group).to(cdtype).permute(0, 3, 1, 2)
            ctx = getattr(self, f"propagation_{step}")(ctx).permute(0, 2, 3, 1)
            ctx = _stage_rms(ctx).reshape(b, h * w, wd)
            ws, bs = self._params(f"update_{step}", 2)
            if step == self.n_steps - 1:
                x = pathnet_head(x, ctx, ws, bs, LEAKY[:2], out_dtype=cdtype)
            else:
                x, ssum, _ = pathnet_head(x, ctx, ws, bs, LEAKY[:2], moments=True,
                                          out_dtype=cdtype)
                x, mean = _stage_rms(x, ssum / s, group)

        # channels-last kernel head: each sample's K*K taps are contiguous
        x = x.reshape(b * s, h, w, wd).permute(0, 3, 1, 2)
        logits = conv_apply(self.kernel_head, x, self.dtype).float()
        logits = logits.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        logits = logits.reshape(b, s, h, w, k * k)
        if self.splat_weighting == "softmax":
            return splat_normalized(radiance, torch.softmax(logits, dim=-1), k, group=group)
        # standardize per image, then soft-cap at +-25
        center = all_mean(logits.mean(dim=(1, 2, 3, 4), keepdim=True), group)
        var = all_mean((logits - center).square().mean(dim=(1, 2, 3, 4), keepdim=True), group)
        logits = SPLAT_LOGIT_GAIN * (logits - center) * torch.rsqrt(var + 1.0)
        logits = 25.0 * torch.tanh(logits / 25.0)
        return splat_normalized_logits(radiance, logits, k, eps=1e-12, group=group)

    def __str__(self):
        return f"Multisteps i{self.n_in} k{self.ksize} s{self.n_steps} w{self.width}"
