"""LBMC "LayerNet": the layer-embedding denoiser.

Counterpart of ``wcmc_tpu/models/lbmc.py`` (the paper's architecture of
"Neural Denoising with Layer Embeddings", EGSR 2020, under the
reference's LBMC training interface):

* a per-sample embedding (``PixelMLP``, kernel K10) of [features |
  tonemapped radiance], and a 1x1 ``layer_head`` that softly assigns each
  sample to ``num_layers`` layers;
* per-layer sample averages of tonemapped radiance and embedding, plus
  each layer's occupancy, as the context;
* a U-Net over the context and a 1x1 ``kernel_head`` that predict a
  K x K softmax kernel per layer and pixel, applied (kernel K1) to the
  layer's linear radiance, edge-padded so the output keeps the input
  size;
* the composite: each filtered layer weighted by its occupancy.

Input ``{'radiance' (B, S, H, W, 3), 'features' (B, S, H, W, n_in)}``,
output ``(B, H, W, 3)`` float32.  The kernel logits stay in the compute
dtype: the reference casts them to f32 before its gather, and a bf16
value converts to f32 exactly, so the gather (f32 softmax) and its
logits gradient (rounded once to bf16) are the same without the f32
copy.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from wcmc_tpu_torch.models.blocks import PixelMLP, UNet, conv_apply, make_conv
from wcmc_tpu_torch.ops.kernel_apply import kernel_apply


def _default_tonemap(x):
    return torch.log1p(torch.clamp(x, min=0.0))


class LayerNet(nn.Module):
    def __init__(self, n_in: int, tonemap: Callable = _default_tonemap, splat: bool = True,
                 num_layers: int = 2, ksize: int = 13, width: int = 96, embed_width: int = 32,
                 dtype=None, generator=None):
        super().__init__()
        del splat   # kept for constructor parity with the reference
        self.n_in, self.tonemap, self.num_layers, self.ksize = n_in, tonemap, num_layers, ksize
        self.width, self.embed_width, self.dtype = width, embed_width, dtype
        self.embedding = PixelMLP(n_in + 3, (embed_width,) * 3, ("leaky_relu",) * 3,
                                  compute_dx=True, dtype=dtype, generator=generator)
        self.layer_head = make_conv(embed_width, num_layers, 1, generator)
        self.context = UNet(num_layers * (3 + embed_width + 1), width, width=width,
                            num_convs=2, dtype=dtype, generator=generator)
        self.kernel_head = make_conv(width, num_layers * ksize**2, 1, generator)

    def forward(self, batch: dict) -> torch.Tensor:
        radiance, features = batch["radiance"], batch["features"]
        b, s, h, w, f = features.shape
        if f != self.n_in:
            raise ValueError(f"LayerNet expects {self.n_in} channels, got {f}")
        tm_rad = self.tonemap(radiance)
        # compute_dx: with a PathNet the features carry the learned
        # p-buffer, so d(input) flows back to it
        emb = self.embedding(torch.cat([features, tm_rad], dim=-1))   # (B, S, H, W, E)
        e = self.embed_width
        logits = conv_apply(self.layer_head, emb.reshape(b * s, h, w, e).permute(0, 3, 1, 2),
                            self.dtype)
        lw = torch.softmax(logits.permute(0, 2, 3, 1).float().reshape(b, s, h, w, -1), dim=-1)
        emb = emb.float()

        wsums, rads, feats, occupancy = [], [], [], []
        for l in range(self.num_layers):
            wl = lw[..., l:l + 1]                     # (B, S, H, W, 1)
            wsum = wl.sum(dim=1)                      # (B, H, W, 1)
            inv = 1.0 / (wsum + 1e-6)
            wsums.append(wsum)
            rads.append((wl * tm_rad).sum(dim=1) * inv)
            feats.append((wl * emb).sum(dim=1) * inv)
            occupancy.append(wsum / s)
        ctx = torch.cat(rads + feats + occupancy, dim=-1)
        head = self.context(ctx.permute(0, 3, 1, 2))
        # channels-last memory: each pixel's taps are contiguous, so every
        # layer's logits reach the gather as a strided view
        kernels = conv_apply(self.kernel_head, head, self.dtype)
        kernels = kernels.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)

        r, k2 = self.ksize // 2, self.ksize**2
        out = radiance.new_zeros((b, h, w, 3))
        # filter *linear* per-layer radiance so the composite stays linear
        for l in range(self.num_layers):
            wl, wsum = lw[..., l:l + 1], wsums[l]
            lin_rad = (wl * radiance).sum(dim=1) / (wsum + 1e-6)
            padded = F.pad(lin_rad.permute(0, 3, 1, 2), (r, r, r, r), mode="replicate")
            filtered = kernel_apply(padded.permute(0, 2, 3, 1), kernels[..., l * k2:(l + 1) * k2],
                                    self.ksize, softmax=True)
            out = out + filtered * (wsum / s)
        return out

    def __str__(self):
        return f"LayerNet i{self.n_in} L{self.num_layers} k{self.ksize} w{self.width}"
