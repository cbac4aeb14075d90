"""Sample-axis (spp) parallelism of the forwards.

Counterpart of ``wcmc_tpu/parallel/sample.py``.  The spp axis of the
sample keys (``paths``, ``radiance``, ``features``: (B, S, H, W, C)) is
sharded over the mesh's spatial group while the pixel keys are
replicated; per-sample work stays local and each model's cross-sample
reductions become collectives over the group (its ``sample_group``):
PathNet's context mean (K4-fwd's fused mean), the dual PathNet's,
LayerNet's per-layer sums and occupancy, Multisteps' RMS mean square,
step context and logit moments, and the splat's sums and window max.
The fused kernels return each shard's own mean or moments, and a mean
over ranks of those is the global one only for equal shards, so every
rank must hold the same number of samples.  Forward only, as the
reference: PathNet's output stays sharded (each rank its samples), an
image output comes back whole on every rank.
"""

from __future__ import annotations

import copy

import torch

from wcmc_tpu_torch.parallel.mesh import Mesh

SAMPLE_KEYS = ("paths", "radiance", "features")


def shard_samples(batch: dict, mesh: Mesh) -> dict:
    """This rank's slice of the sample axis of every sample key (equal
    shards of the spatial group); the other keys as they are."""
    n, r = mesh.n_spatial, mesh.spatial_rank
    out = dict(batch)
    for k in SAMPLE_KEYS:
        if k not in batch:
            continue
        s = batch[k].shape[1]
        if s % n:
            raise ValueError(f"{k!r} has {s} samples, which do not split evenly over {n} ranks")
        out[k] = batch[k][:, r * s // n:(r + 1) * s // n]
    return out


def with_sample_group(model: torch.nn.Module, group) -> torch.nn.Module:
    """A shallow copy of ``model`` (the same parameters and sub-modules)
    whose sample axis is sharded over ``group``."""
    m = copy.copy(model)
    m.sample_group = group
    return m


def make_sample_parallel(model: torch.nn.Module, mesh: Mesh):
    """The forward of ``model`` (PathNet, LayerNet or Multisteps) with
    the spp axis sharded over ``mesh``'s spatial group: a function of the
    global batch (host or device tensors; the sample keys are sliced to
    this rank's shard) returning the model's output (PathNet's: this
    rank's samples)."""
    sharded = with_sample_group(model, mesh.spatial_group)

    def run(batch):
        local = {k: torch.as_tensor(v).to(mesh.device) for k, v in
                 shard_samples(batch, mesh).items()}
        with torch.no_grad():
            return sharded(local)

    return run
