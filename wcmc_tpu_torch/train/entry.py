"""What the three training entry points share: the datasets and loaders
from disk, the interfaces with their resume, and the run.

``train_kpcn``, ``train_lbmc`` and ``train_sbmc`` (the port's
counterparts of the repository's root scripts) each add their flags, their
``TrainConfig`` and their epoch schedulers, and call these.

``--n_devices N`` above 1 trains data parallel over N ranks that
``run`` spawns itself (``parallel/launch.py``): rank r on ``cuda:r``
over NCCL, or, with ``--device cpu``, N gloo ranks on the CPU.  Every
rank draws the same global batches and cuts and moves to its device only
its own shard of each (the loaders' ``shard``), restores the same
checkpoint and steps on its shard; rank 0 alone writes checkpoints, logs
and step times.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from wcmc_tpu_torch.data.dataset import BatchLoader, MSDenoiseDataset, ShuffleLoader
from wcmc_tpu_torch.data.prefetch import DevicePrefetcher
from wcmc_tpu_torch.train.checkpoint import load_checkpoint, restore_interface
from wcmc_tpu_torch.train.factory import init_interfaces, sweep_checkpoint_name
from wcmc_tpu_torch.train.loop import train
from wcmc_tpu_torch.utils.utils import resolve_device

BS_VAL = 4  # validation batch size


def init_data(args, base_model: str, device, use_g_buf: bool = True,
              use_sbmc_buf: bool = False, pnet_out_size: int = 3):
    """The train (random patches, cross-image shuffled) and val (grid
    patches) multi-spp datasets of ``args.data_dir``, each behind a
    ``DevicePrefetcher`` to ``device``; returns (datasets, loaders).  On
    a rank of a data-parallel run the loaders serve this rank's shard of
    each global batch."""
    # the training mesh is n_devices x 1, so the data rank is the rank
    shard = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    common = dict(use_g_buf=use_g_buf, use_sbmc_buf=use_sbmc_buf,
                  use_llpm_buf=args.use_llpm_buf, pnet_out_size=pnet_out_size, seed=args.seed)
    datasets = {
        "train": MSDenoiseDataset(
            args.data_dir, 8, base_model, "train", args.batch_size, "random",
            patches_per_image=args.patches_per_image,
            serve_paths_dtype="bfloat16" if args.serve_bf16 else None, **common),
        "val": MSDenoiseDataset(
            args.data_dir, 8, base_model, "val", BS_VAL, "grid",
            patches_per_image=(max(args.patches_per_image, BS_VAL)
                               if args.patches_per_image else None), **common),
    }
    loaders = {
        "train": DevicePrefetcher(
            ShuffleLoader(datasets["train"], args.batch_size, seed=args.seed, shard=shard),
            device=device),
        "val": DevicePrefetcher(BatchLoader(datasets["val"], BS_VAL, shard=shard),
                                device=device),
    }
    return datasets, loaders


def init_model(args, cfg, device, params=None):
    """The interfaces of ``cfg`` on ``device``, each restored from its
    checkpoint in ``args.save`` when ``--start_epoch`` is not 0 (with
    the fresh learning rates unless ``--lr_ckpt``, and ``--best_err``
    over the checkpoint's); returns (interfaces, params)."""
    interfaces = init_interfaces(cfg, args, device=device)
    for i, iface in enumerate(interfaces):
        fn = sweep_checkpoint_name(args.save, args.model_name, interfaces, i)
        if args.start_epoch == 0 and os.path.isfile(fn):
            raise FileExistsError(f"Model {fn} already exists.")
        if args.start_epoch != 0 and os.path.isfile(fn):
            lr_override = None
            if not args.lr_ckpt:
                lr_override = {name: (args.lr_dncnn if name == "dncnn" else args.lr_pnet[0])
                               for name in iface.models}
            restore_interface(iface, load_checkpoint(fn), lr_override=lr_override)
            if args.best_err is not None:
                iface.best_err = args.best_err
            print("Pretraining weights are loaded.")
        else:
            print("Train models from scratch.")
    if getattr(args, "n_devices", 0) and args.n_devices > 1:
        from wcmc_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(n_data=args.n_devices)
        for iface in interfaces:
            iface.to_mesh(mesh)
    os.makedirs(args.save, exist_ok=True)
    return interfaces, {"plots": {}, "data_device": 0, **(params or {})}


def run(args, init_data, init_model):
    """An entry module's ``main``: its ``init_data(args, device)`` and
    ``init_model(dataset, args, device)``, then ``train``; returns
    (interfaces, params).  With ``--n_devices`` above 1 it spawns the
    ranks and returns (None, rank 0's ``{"epoch_stats", "best_err"}``)."""
    n = getattr(args, "n_devices", 0) or 0
    if n > 1 and not dist.is_initialized():
        return None, _spawn_ranks(args, init_data, init_model, n)
    device = resolve_device(args.device)
    if dist.is_initialized() and device.type == "cuda":
        device = torch.device("cuda", dist.get_rank())
    np.random.seed(args.seed)
    datasets, loaders = init_data(args, device)
    interfaces, params = init_model(datasets, args, device)
    train(interfaces, loaders, params, args)
    return interfaces, params


def _rank_run(args, init_data, init_model):
    interfaces, params = run(args, init_data, init_model)
    return {"epoch_stats": params.get("epoch_stats", []),
            "best_err": [iface.best_err for iface in interfaces]}


def _spawn_ranks(args, init_data, init_model, n):
    """``run`` on ``n`` spawned ranks: NCCL over ``cuda:0..n-1`` (the
    kernels built once here first), or gloo on the CPU."""
    from wcmc_tpu_torch.parallel.launch import RankPool

    device = resolve_device(args.device)
    if device.type == "cuda":
        count = torch.cuda.device_count()
        if n > count:
            raise ValueError(f"--n_devices {n} needs {n} cards; {count} are visible")
        from wcmc_tpu_torch.ops import _build

        _build.build()
        backend, devices = "nccl", [f"cuda:{r}" for r in range(n)]
    elif device.type == "cpu":
        backend, devices = "gloo", None
    else:
        raise ValueError(f"--n_devices runs on CUDA cards or the CPU, not {device}")
    print(f"Data parallel over {n} ranks ({backend})")
    with RankPool(n, backend, devices) as pool:
        return pool.run(_rank_run, args, init_data, init_model)[0]
