"""Data parallelism over ``torch.distributed``.

Counterpart of ``wcmc_tpu/parallel/mesh.py``.  The reference compiles
one step over a ``('data', 'spatial')`` device mesh: the batch sharded on
its leading axis over 'data', the states replicated, and XLA
all-reducing the gradients of a loss taken over the global batch.  Here
there is one process per device (``parallel/launch.py`` starts them), and
a :class:`Mesh` holds the world, this rank, its device and its two
groups: the ranks that share its spatial index ('data', over which the
batch is sharded and the gradients are averaged) and the ranks that
share its data index ('spatial', for the halo-exchanged and the
spp-sharded forwards).  Ranks are laid out as the reference lays out its
devices, ``rank = data index * n_spatial + spatial index``.

A data-parallel step (:func:`data_parallel_step`) runs the interface's
forward and backward on this rank's slice of the global batch, which the
host cuts before anything reaches the device (:func:`shard_batch`, or
the loaders' ``shard``), as ``jax.device_put`` with ``P('data')`` puts
only each device's shard on it; it then averages each model's gradients
over the data group in one flat bucket per model, in the models' order,
and the loss dict with them; the
optimizers then step on the averaged gradients (so the clips see them)
and every replica stays bit for bit the same.  Every loss of the
interfaces is a mean over the batch, so the average over equal shards is
the global loss; the manifold losses' cross-batch term is taken over the
gathered global batch (``losses.py``, ``group``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from wcmc_tpu_torch.parallel.collectives import all_mean, gather_cat, group_size


@dataclasses.dataclass
class Mesh:
    """This rank's place in an ``n_data x n_spatial`` world."""

    n_data: int
    n_spatial: int
    rank: int
    device: torch.device
    data_group: Any        # None when n_data is 1 in a larger world
    spatial_group: Any     # None when n_spatial is 1 in a larger world

    @property
    def world(self) -> int:
        return self.n_data * self.n_spatial

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_spatial

    @property
    def spatial_rank(self) -> int:
        return self.rank % self.n_spatial


def _group(ranks, world):
    # a world of one keeps its group, so its steps still run the
    # backend's collectives (NCCL's path on one card); a single rank of a
    # larger world has nothing to combine
    if len(ranks) == world:
        return dist.group.WORLD
    if len(ranks) == 1:
        return None
    return dist.new_group(ranks)


def make_mesh(n_data: Optional[int] = None, n_spatial: int = 1,
              devices: Optional[Sequence] = None, backend: Optional[str] = None) -> Mesh:
    """The mesh of the initialized process group (``launch.init_rank``):
    ``n_data`` defaults to the world over ``n_spatial``.  ``devices``
    names each rank's device (several ranks may share one card over
    gloo); by default rank r takes ``cuda:r`` under NCCL and the CPU
    otherwise.  ``backend``, when given, must be the group's.  Every rank
    calls this, with the same arguments."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group: start the ranks "
                           "with wcmc_tpu_torch.parallel.launch")
    world, rank = dist.get_world_size(), dist.get_rank()
    if backend is not None and dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, not {backend}")
    if n_data is None:
        n_data = world // n_spatial
    if n_data * n_spatial != world:
        raise ValueError(f"a {n_data} x {n_spatial} mesh needs {n_data * n_spatial} ranks, "
                         f"the world has {world}")
    # every rank creates every group, in the same order
    data_groups = [_group([d * n_spatial + s for d in range(n_data)], world)
                   for s in range(n_spatial)]
    spatial_groups = [_group([d * n_spatial + s for s in range(n_spatial)], world)
                      for d in range(n_data)]
    if devices is not None:
        device = torch.device(devices[rank])
    elif dist.get_backend() == "nccl":
        device = torch.device("cuda", rank % torch.cuda.device_count())
    else:
        device = torch.device("cpu")
    return Mesh(n_data, n_spatial, rank, device, data_groups[rank % n_spatial],
                spatial_groups[rank // n_spatial])


def shard_slice(size: int, index: int, count: int) -> slice:
    """Shard ``index`` of ``count`` of a leading axis of ``size``:
    ``[index * size / count, (index + 1) * size / count)``.  A size that
    ``count`` does not divide raises, as the reference's sharding does."""
    if size % count:
        raise ValueError(f"a batch of {size} does not split over {count} data ranks")
    n = size // count
    return slice(index * n, (index + 1) * n)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's slice of a global batch (numpy arrays or tensors) on
    its leading axis: rank d of the data group takes ``shard_slice(B, d,
    n_data)``."""
    return {k: v[shard_slice(v.shape[0], mesh.data_rank, mesh.n_data)]
            for k, v in batch.items()}


def _broadcast_(t: torch.Tensor, mesh: Mesh):
    buf = t.detach().to(mesh.device).contiguous()
    dist.broadcast(buf, src=0)
    t.data.copy_(buf)


def replicate(models: Dict[str, torch.nn.Module], optims: Dict[str, Any], mesh: Mesh):
    """Broadcast rank 0's parameters, buffers and optimizer state (Adam's
    moments and step, the learning rate and the warmup count) to every
    rank, in place."""
    if mesh.world == 1:
        return
    with torch.no_grad():
        for name, m in models.items():
            for t in list(m.parameters()) + list(m.buffers()):
                _broadcast_(t, mesh)
            opt = optims.get("optim_" + name)
            if opt is None:
                continue
            for p in opt.params:
                for key in sorted(opt.adam.state.get(p, {})):
                    _broadcast_(opt.adam.state[p][key], mesh)
            hyper = torch.tensor([opt.lr, float(opt.count)], dtype=torch.float64)
            _broadcast_(hyper, mesh)
            opt.lr, opt.count = float(hyper[0]), int(hyper[1])


def reduce_gradients(models: Dict[str, torch.nn.Module], group):
    """Average each model's ``.grad`` over ``group``: one all-reduce of a
    flat bucket per model, in the models' order (the parameters without a
    gradient, a frozen model's, take no part)."""
    if group is None:
        return
    n = group_size(group)
    for m in models.values():
        grads = [p.grad for p in m.parameters() if p.grad is not None]
        if not grads:
            continue
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        flat /= n
        at = 0
        for g in grads:
            g.copy_(flat[at:at + g.numel()].view_as(g))
            at += g.numel()


def reduce_losses(loss_dict: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """The loss dict averaged over ``group`` (one all-reduce)."""
    if group is None or not loss_dict:
        return loss_dict
    keys = list(loss_dict)
    vals = all_mean(torch.stack([loss_dict[k].detach().float() for k in keys]), group)
    return {k: vals[i] for i, k in enumerate(keys)}


def data_parallel_step(grad_step: Callable, models: Dict[str, torch.nn.Module],
                       mesh: Mesh) -> Callable:
    """Wrap an interface's ``grad_step(batch, draws) -> loss dict``
    (forward and backward, gradients left in ``.grad``) for the mesh:
    the step on this rank's shard of the global batch, then the gradients
    and the loss dict averaged over the data group."""

    def step(batch, draws=None):
        loss_dict = grad_step(batch, draws)
        reduce_gradients(models, mesh.data_group)
        return reduce_losses(loss_dict, mesh.data_group)

    return step


def _gather_tree(x, group):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: gather_cat(v, group) for k, v in x.items()}
    return gather_cat(x, group)


def data_parallel_val(val_step: Callable, mesh: Mesh) -> Callable:
    """Wrap an interface's ``val_step(batch) -> (radiance, p-buffers,
    l_test)`` for the mesh: the step on this rank's shard, then the
    radiance and the p-buffers gathered over the data group in batch
    order, and ``l_test`` averaged over it (the global batch's)."""

    def step(batch):
        radiance, p_buffers, l_test = val_step(batch)
        group = mesh.data_group
        return (_gather_tree(radiance, group), _gather_tree(p_buffers, group),
                all_mean(l_test, group))

    return step


def checksum(models: Dict[str, torch.nn.Module]) -> str:
    """A digest of every model's parameters (replicas that agree bit for
    bit have the same one)."""
    import hashlib

    h = hashlib.sha1()
    for m in models.values():
        for p in m.parameters():
            h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()
