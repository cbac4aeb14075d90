"""What the three training entry points share: the datasets and loaders
from disk, the interfaces with their resume, and the run.

``train_kpcn``, ``train_lbmc`` and ``train_sbmc`` (the port's
counterparts of the repository's root scripts) each add their flags, their
``TrainConfig`` and their epoch schedulers, and call these.
"""

from __future__ import annotations

import os

import numpy as np

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
    ``DevicePrefetcher`` to ``device``; returns (datasets, loaders)."""
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
            ShuffleLoader(datasets["train"], args.batch_size, seed=args.seed), device=device),
        "val": DevicePrefetcher(BatchLoader(datasets["val"], BS_VAL), device=device),
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
        for iface in interfaces:
            iface.to_mesh(None)
    os.makedirs(args.save, exist_ok=True)
    return interfaces, {"plots": {}, "data_device": 0, **(params or {})}


def run(args, init_data, init_model):
    """An entry module's ``main``: its ``init_data(args, device)`` and
    ``init_model(dataset, args, device)``, then ``train``; returns
    (interfaces, params)."""
    device = resolve_device(args.device)
    np.random.seed(args.seed)
    datasets, loaders = init_data(args, device)
    interfaces, params = init_model(datasets, args, device)
    train(interfaces, loaders, params, args)
    return interfaces, params
