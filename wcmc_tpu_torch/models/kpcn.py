"""KPCN — kernel-predicting convolutional network (diffuse/specular).

Counterpart of ``wcmc_tpu/models/kpcn.py``:

* ``forward(batch)`` reads ``kpcn_diffuse_in`` / ``kpcn_specular_in`` /
  ``kpcn_diffuse_buffer`` / ``kpcn_specular_buffer`` / ``kpcn_albedo``
  (channels-last) and returns ``{'radiance', 'diffuse', 'specular'}``;
* geometry: 9 stacked 5x5 VALID convs (-36 px) + a 21x21 valid softmax
  kernel application (-20 px), so a 128 px patch yields a 72 px output;
* recombination ``diffuse * albedo + exp(specular) - 1``.

The convolutions run in channels-last memory, so the kernel logits come
out with their K*K taps innermost and go to the gather kernel (K1) as a
strided crop, without a copy.  The two branches call the gather once
each.  With ``fused`` (the reference's ``KPCN.fused``, set for primal-only
steps by the interface's ``_val_model``) the chains take the NHWC inputs
as they are and run through the fused convolution K6; the parameters are
the same either way, so one checkpoint serves both.
"""

from __future__ import annotations

import torch
from torch import nn

from wcmc_tpu_torch.models.blocks import ConvChain
from wcmc_tpu_torch.ops.kernel_apply import kernel_apply
from wcmc_tpu_torch.utils.utils import crop_like


class KPCN(nn.Module):
    def __init__(self, n_in: int, ksize: int = 21, depth: int = 9,
                 width: int = 100, dtype=None, generator=None):
        super().__init__()
        self.n_in, self.ksize, self.depth, self.width, self.dtype = (
            n_in, ksize, depth, width, dtype)
        self.fused = False
        for name in ("diffuse", "specular"):
            self.add_module(name, ConvChain(
                n_in, ksize**2, width=width, depth=depth, ksize=5, dtype=dtype,
                generator=generator,
            ))

    @property
    def shrink(self) -> int:
        """Total spatial shrink: the conv chain and the valid kernel window."""
        return self.depth * 4 + (self.ksize - 1)

    def _branch(self, chain, x, buf):
        if self.fused:
            logits = chain(x, fused=True)   # NHWC in and out, taps innermost
        else:
            logits = chain(x.permute(0, 3, 1, 2))
            logits = logits.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        # keep only kernel positions whose full K x K window lies inside
        # the conv-output grid; the buffer is center-cropped to match
        r = self.ksize // 2
        hh, ww = logits.shape[1], logits.shape[2]
        logits = logits[:, r:hh - r, r:ww - r, :]
        b, h, w, _ = logits.shape
        token = torch.empty((b, h + self.ksize - 1, w + self.ksize - 1, 1), device="meta")
        return kernel_apply(crop_like(buf, token), logits, self.ksize, softmax=True)

    def forward(self, batch: dict) -> dict:
        r_diffuse = self._branch(self.diffuse, batch["kpcn_diffuse_in"],
                                 batch["kpcn_diffuse_buffer"])
        r_specular = self._branch(self.specular, batch["kpcn_specular_in"],
                                  batch["kpcn_specular_buffer"])
        albedo = crop_like(batch["kpcn_albedo"], r_diffuse)
        radiance = albedo * r_diffuse + torch.expm1(r_specular)
        return {"radiance": radiance, "diffuse": r_diffuse, "specular": r_specular}

    def __str__(self):
        return f"KPCN i{self.n_in} k{self.ksize} d{self.depth} w{self.width}"
