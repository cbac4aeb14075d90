"""Row-sharded full-frame inference with a halo exchange.

Counterpart of ``wcmc_tpu/parallel/halo.py``.  Each rank of the mesh's
spatial group holds a horizontal band of the frame, receives ``halo``
rows from each neighbour (zeros at the frame's top and bottom), runs the
denoiser on its padded band and crops back to exactly its band, so the
bands put together equal the single-device forward over the globally
valid interior.  Geometry: for a model of VALID convolutions with total
shrink ``s`` (56 for the flagship KPCN: ``KPCN.shrink``) and ``halo >=
s / 2``, a band of ``Hn`` rows padded by ``halo`` each side gives ``Hn +
2 halo - s`` rows, of which ``(2 halo - s) / 2`` a side are cropped; the
width comes back to the frame's by edge-padding ``s / 2`` columns a side,
which, like the frame's outer ``s / 2`` rows, are invalid, as in the
unsharded forward.

The reference's ``ppermute`` becomes one all-reduce a key of zero-filled
neighbour slots (each rank writes its first and last ``halo`` rows into
its own slot and reads its neighbours'), the exchange that gloo also
runs between ranks that share one card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from wcmc_tpu_torch.parallel.collectives import all_sum, group_rank, group_size
from wcmc_tpu_torch.parallel.mesh import Mesh

KPCN_KEYS = ("kpcn_diffuse_in", "kpcn_specular_in", "kpcn_diffuse_buffer",
             "kpcn_specular_buffer", "kpcn_albedo")


def _h_axis(name: str) -> int:
    """Row axis of a key: pixel keys (B, H, W, C) 1, sample keys
    (B, S, H, W, C) 2."""
    return 2 if name in ("paths", "radiance", "features") else 1


def shard_rows(batch: dict, mesh: Mesh) -> dict:
    """This rank's band of every key of a global frame (equal bands of
    the spatial group)."""
    n, r = mesh.n_spatial, mesh.spatial_rank
    out = {}
    for k, v in batch.items():
        ax = _h_axis(k)
        h = v.shape[ax]
        if h % n:
            raise ValueError(f"{k!r} has {h} rows, which do not split evenly over {n} ranks")
        out[k] = torch.as_tensor(v).narrow(ax, r * h // n, h // n).to(mesh.device)
    return out


def exchange_halo(x: torch.Tensor, group, h_axis: int, halo: int) -> torch.Tensor:
    """``x`` padded on its row axis by ``halo`` rows from the neighbour
    above and below in ``group``'s rank order (zeros past the ends)."""
    n, r = group_size(group), group_rank(group)
    if halo > x.shape[h_axis]:
        raise ValueError(f"halo {halo} exceeds the band's {x.shape[h_axis]} rows")
    top = x.narrow(h_axis, 0, halo)
    slots = x.new_zeros((n, 2) + tuple(top.shape))
    slots[r, 0] = top
    slots[r, 1] = x.narrow(h_axis, x.shape[h_axis] - halo, halo)
    slots = all_sum(slots, group)
    zeros = torch.zeros_like(top)
    above = slots[r - 1, 1] if r > 0 else zeros
    below = slots[r + 1, 0] if r < n - 1 else zeros
    return torch.cat([above, x, below], dim=h_axis)


def make_spatial_inference(apply_fn, mesh: Mesh, shrink: int, halo: int = 32):
    """A row-sharded forward over ``mesh``'s spatial group.

    ``apply_fn(batch) -> (B, h, w, 3)`` is a model of VALID geometry with
    total shrink ``shrink``; ``halo`` must satisfy ``2 halo >= shrink``
    (and keep ``2 halo - shrink`` even).  Returns ``fn(band)``: this rank's
    band of every key (``shard_rows``) -> its band of the output, (B, Hn,
    W, 3)."""
    if 2 * halo < shrink or (2 * halo - shrink) % 2:
        raise ValueError(f"halo {halo} does not fit a shrink of {shrink}")
    extra = (2 * halo - shrink) // 2
    pad_w = shrink // 2

    def run(band):
        with torch.no_grad():
            padded = {k: exchange_halo(v, mesh.spatial_group, _h_axis(k), halo)
                      for k, v in band.items()}
            out = apply_fn(padded)
            if extra:
                out = out[:, extra:out.shape[1] - extra]
            out = F.pad(out.permute(0, 3, 1, 2), (pad_w, pad_w, 0, 0), mode="replicate")
            return out.permute(0, 2, 3, 1)

    return run


def kpcn_spatial_inference(model, mesh: Mesh, halo: int = 32):
    """The row-sharded KPCN radiance forward (keys ``KPCN_KEYS``)."""
    return make_spatial_inference(lambda b: model(b)["radiance"], mesh, model.shrink, halo)
