"""PathNet — the path embedding network.

Counterpart of ``wcmc_tpu/models/pathnet.py``: per-sample MLP embedding
with its sample mean (kernel K4), U-Net context propagation on the mean,
and the per-sample head over [embedding | broadcast context] (kernel
K5).  Input ``batch['paths']`` is ``(B, S, H, W, 36)``; output
``(B, S, H, W, outc)`` float32.

``sample_group`` (``None`` unless ``parallel/sample.py`` sets it on a
copy) is the process group over which the sample axis is sharded: the
context mean becomes the mean over its ranks of each rank's own sample
mean (the reference's ``pmean`` over ``sample_axis_name``), exact for
equal shards.  Forward only.
"""

from __future__ import annotations

import torch
from torch import nn

from wcmc_tpu_torch.models.blocks import UNet, dual_unet_apply, lecun_normal_
from wcmc_tpu_torch.ops.pathnet_fused import (
    EMBED_ACTS, HEAD_ACTS, pathnet_embed, pathnet_head,
)
from wcmc_tpu_torch.parallel.collectives import all_mean


class PathNet(nn.Module):
    def __init__(self, ic: int = 36, intermc: int = 64, outc: int = 3,
                 dtype=None, generator=None):
        super().__init__()
        self.ic, self.intermc, self.outc, self.dtype = ic, intermc, outc, dtype
        self.sample_group = None
        self._chain("embedding", (ic, intermc, intermc, intermc), generator)
        self._chain("final", (2 * intermc, 2 * intermc, outc), generator)
        self.propagation = UNet(intermc, intermc, width=intermc, num_convs=3,
                                dtype=dtype, generator=generator)

    def _chain(self, name, dims, generator):
        for i, (ci, co) in enumerate(zip(dims[:-1], dims[1:])):
            w = nn.Parameter(torch.empty(ci, co))
            lecun_normal_(w, ci, generator)
            self.register_parameter(f"{name}_w{i}", w)
            self.register_parameter(f"{name}_b{i}", nn.Parameter(torch.zeros(co)))

    def params(self, name: str, n: int):
        return ([getattr(self, f"{name}_w{i}") for i in range(n)],
                [getattr(self, f"{name}_b{i}") for i in range(n)])

    def forward(self, samples: dict) -> torch.Tensor:
        paths = samples["paths"]
        b, s, h, w, nf = paths.shape
        if nf != self.ic:
            raise ValueError(f"PathNet expects {self.ic} path channels, got {nf}")
        ic = self.intermc
        x = paths.reshape(b, s, h * w, nf)
        if self.dtype is not None:
            x = x.to(self.dtype)
        e, reduced = pathnet_embed(x, *self.params("embedding", 3), EMBED_ACTS)
        reduced = all_mean(reduced.reshape(b, h, w, ic), self.sample_group)
        if self.dtype is not None:
            reduced = reduced.to(self.dtype)
        ctx = self.propagation(reduced.permute(0, 3, 1, 2))
        ctx = ctx.permute(0, 2, 3, 1).reshape(b, h * w, ic)
        out = pathnet_head(e, ctx, *self.params("final", 2), HEAD_ACTS)
        return out.reshape(b, s, h, w, self.outc)

    def __str__(self):
        return f"PathNet i{self.ic}in{self.intermc}o{self.outc}"


def dual_pathnet_apply(model_d: PathNet, model_s: PathNet, batch,
                       with_moments=False, cmajor=False):
    """Run the diffuse and specular PathNets as one embedding pass and
    one head pass: the branch weights are combined (concatenated at the
    input layer, block-diagonal in the hidden layers), so each kernel
    reads the paths (or the embedding) once and runs both branches at
    128/256-wide channels.  The off-diagonal blocks are structural
    zeros, so the math is that of two separate applies.  The context
    UNets run per branch.

    Returns (p_diffuse, p_specular), each (B, S, H, W, outc) f32 — or
    (B, S, outc, H, W) with ``cmajor`` — plus, with ``with_moments``,
    ``(sum_S, sum_S of squares)`` of both branches, each
    (B, H, W, 2 * outc) f32 (over this rank's samples when the branches
    carry a ``sample_group``).
    """
    ic, outc = model_d.intermc, model_d.outc
    if ((model_s.intermc, model_s.outc, model_s.ic, model_s.sample_group)
            != (ic, outc, model_d.ic, model_d.sample_group)):
        raise ValueError("dual_pathnet_apply requires identically-configured branches")

    paths = batch["paths"]
    b, s, h, w, nf = paths.shape
    (ed, bed), (es, bes) = model_d.params("embedding", 3), model_s.params("embedding", 3)
    ws_e = [torch.cat([ed[0], es[0]], dim=1),
            torch.block_diag(ed[1], es[1]),
            torch.block_diag(ed[2], es[2])]
    bs_e = [torch.cat([bd, bs_]) for bd, bs_ in zip(bed, bes)]

    x = paths.reshape(b, s, h * w, nf)
    if model_d.dtype is not None:
        x = x.to(model_d.dtype)
    e, mean = pathnet_embed(x, ws_e, bs_e, EMBED_ACTS)

    mean = all_mean(mean.reshape(b, h, w, 2 * ic), model_d.sample_group)
    if model_d.dtype is not None:
        mean = mean.to(model_d.dtype)
    mean = mean.permute(0, 3, 1, 2)
    ctx_d, ctx_s = dual_unet_apply(model_d.propagation, model_s.propagation,
                                   mean[:, :ic], mean[:, ic:])
    ctx = torch.cat([ctx_d, ctx_s], dim=1).permute(0, 2, 3, 1)
    ctx = ctx.reshape(b, h * w, 2 * ic)

    # head layer 1 per branch: rows [:ic] multiply e, rows [ic:] multiply
    # ctx — combine each half block-diagonally, then stack (e rows on
    # top) to match pathnet_head's split at Ce = 2*ic
    (fd, bfd), (fs, bfs) = model_d.params("final", 2), model_s.params("final", 2)
    ws_h = [torch.cat([torch.block_diag(fd[0][:ic], fs[0][:ic]),
                       torch.block_diag(fd[0][ic:], fs[0][ic:])], dim=0),
            torch.block_diag(fd[1], fs[1])]
    bs_h = [torch.cat([bd, bs_]) for bd, bs_ in zip(bfd, bfs)]

    res = pathnet_head(e, ctx, ws_h, bs_h, HEAD_ACTS, with_moments, cmajor)
    out, moments = (res[0], res[1:]) if with_moments else (res, None)
    if cmajor:
        out = out.reshape(b, s, 2 * outc, h, w)
        p_d, p_s = out[:, :, :outc], out[:, :, outc:]
    else:
        out = out.reshape(b, s, h, w, 2 * outc)
        p_d, p_s = out[..., :outc], out[..., outc:]
    if with_moments:
        ssum, ssq = (m.reshape(b, h, w, 2 * outc) for m in moments)
        return p_d, p_s, (ssum, ssq)
    return p_d, p_s
