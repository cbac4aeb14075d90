"""The epoch loop shared by the three training entry points.

Counterpart of ``wcmc_tpu/train/loop.py``: ``train_epoch``,
``validate`` and ``train`` (latest and best checkpoints, ``--not_save``,
``--visual`` metrics and p-buffer dumps, a profile of the first epoch,
epoch-end learning-rate schedulers ``params['sched_<model>']``, callables
``f(epoch) -> lr``).  Batches are host numpy dicts or device tensors (a
``DevicePrefetcher`` in front of the loader); steps are not synchronized
one by one: each step's loss tensor is kept and the one
``WCMC_TRAIN_IN_FLIGHT`` steps behind (default 8; 0 keeps none) is read
back, which bounds how far the host runs ahead of the card.
"""

from __future__ import annotations

import os
import time

import numpy as np

from wcmc_tpu_torch.train.checkpoint import save_checkpoint
from wcmc_tpu_torch.train.state import set_learning_rate


def step_lr(base_lr: float, step_size: int, gamma: float):
    """StepLR schedule: ``base_lr * gamma ** ((epoch + 1) // step_size)``
    after epoch ``epoch``."""

    def schedule(epoch: int) -> float:
        return base_lr * gamma ** ((epoch + 1) // step_size)

    return schedule


def train_epoch(epoch, interfaces, dataloaders, params, args, verbose=True):
    """One pass over ``dataloaders['train']``: each batch through every
    interface's ``preprocess`` and ``train_batch``.  Appends the epoch's
    steps, seconds and time spent waiting for the loader to
    ``params['epoch_stats']``."""
    if "train" not in dataloaders:
        raise KeyError("train_epoch needs a 'train' loader")
    if verbose:
        print(f"[][] Epoch {epoch}")
    for iface in interfaces:
        iface.to_train_mode()
    writer = params.get("metrics_writer")
    timer = params.setdefault("step_timer", _new_timer())
    max_in_flight = int(os.environ.get("WCMC_TRAIN_IN_FLIGHT", "8"))
    lagged: list = []
    n_batches = 0
    wait_s = 0.0
    t_start = time.perf_counter()
    batches = iter(dataloaders["train"])
    while True:
        t0 = time.perf_counter()
        batch = next(batches, None)
        wait_s += time.perf_counter() - t0
        if batch is None:
            break
        n_batches += 1
        for iface in interfaces:
            iface.preprocess(batch)
            loss_dict = iface.train_batch(batch)
            if max_in_flight > 0 and loss_dict:
                lagged.append(next(iter(loss_dict.values())))
                if len(lagged) > max_in_flight:
                    lagged.pop(0).item()  # readback of the step K behind
            timer.tick()
            if writer is not None and iface.iters % 50 == 0:
                writer.log(iface.iters, loss_dict, prefix="train/")
                writer.log(iface.iters, {"step_ms": timer.mean_ms}, prefix="perf/")
        if writer is not None and n_batches % 128 == 0:
            # partial step times, so a truncated run still leaves them
            _save_step_times(writer.log_dir, epoch, timer.snapshot_ms())
    for v in lagged:
        v.item()
    seconds = time.perf_counter() - t_start
    params.setdefault("epoch_stats", []).append(
        {"epoch": epoch, "steps": n_batches, "seconds": seconds, "loader_wait_s": wait_s})
    if writer is not None:
        # per-step wall times; steps are not synchronized one by one, so a
        # tick measures the host's launch rate and their sum the epoch
        _save_step_times(writer.log_dir, epoch, timer.drain_all_ms())
        writer.log(epoch, {"epoch_s": seconds, "loader_wait_s": wait_s}, prefix="perf/")
    if verbose:
        for iface in interfaces:
            # normalized by the batches actually served (a shape-partitioned
            # loader can yield fewer than its len() predicts)
            iface.get_epoch_summary(mode="train", norm=max(n_batches, 1))
        if timer.mean_ms == timer.mean_ms:  # not NaN
            print(f"[][] Mean step time: {timer.mean_ms:.1f} ms")


def _new_timer():
    from wcmc_tpu_torch.utils.observability import StepTimer

    return StepTimer()


def _save_step_times(log_dir, epoch, all_ms):
    if all_ms:
        np.save(os.path.join(log_dir, f"step_times_e{epoch}.npy"),
                np.asarray(all_ms, np.float32))


def validate(epoch, interfaces, dataloaders, params, args, verbose=True):
    """Every interface's mean validation loss over ``dataloaders['val']``;
    ``inf`` for each when the loader yields nothing."""
    if "val" not in dataloaders:
        raise KeyError("validate needs a 'val' loader")
    if verbose:
        print(f"[][] Validation (epoch {epoch})")
    for iface in interfaces:
        iface.to_eval_mode()
    n_batches = 0
    for batch in dataloaders["val"]:
        n_batches += 1
        for iface in interfaces:
            iface.validate_batch(batch)
    if n_batches == 0:
        # e.g. patches_per_image < batch_size drops every partial batch;
        # an empty validation must not look like a perfect score
        print("[][] WARNING: validation loader produced no batches")
        return [float("inf") for _ in interfaces]
    return [iface.get_epoch_summary(mode="eval", norm=n_batches) for iface in interfaces]


def train(interfaces, dataloaders, params, args, verbose=True):
    """The full training run: epochs, latest/best checkpoints, periodic
    validation, epoch-end schedulers.  Data parallel (interfaces on a
    mesh), rank 0 alone prints and writes checkpoints, logs and traces."""
    save_dir = getattr(args, "save", "./weights")
    os.makedirs(save_dir, exist_ok=True)
    model_name = getattr(args, "model_name", "model")
    num_epoch = getattr(args, "num_epoch", 1)
    start_epoch = getattr(args, "start_epoch", 0)
    val_epoch = getattr(args, "val_epoch", 1)
    mesh = getattr(interfaces[0], "mesh", None) if interfaces else None
    writes = mesh is None or mesh.rank == 0
    verbose = verbose and writes
    not_save = getattr(args, "not_save", False) or not writes
    desc = getattr(args, "desc", "")

    from wcmc_tpu_torch.train.factory import sweep_checkpoint_name

    save_fns = [os.path.basename(sweep_checkpoint_name("", model_name, interfaces, i))
                for i in range(len(interfaces))]

    if getattr(args, "visual", False) and writes:
        if "metrics_writer" not in params:
            from wcmc_tpu_torch.utils.observability import MetricsWriter

            params["metrics_writer"] = MetricsWriter(os.path.join(save_dir, "logs", model_name))
        for iface in interfaces:
            iface.pbuf_dump_dir = os.path.join(save_dir, "logs", model_name, "pbuf")

    from wcmc_tpu_torch.utils.observability import maybe_profile

    for epoch in range(start_epoch, num_epoch):
        start_time = time.time()
        profile_dir = (getattr(args, "profile_dir", None)
                       if epoch == start_epoch and writes else None)
        with maybe_profile(profile_dir):
            train_epoch(epoch, interfaces, dataloaders, params, args, verbose)
        if verbose:
            print(f"[][] Elapsed time: {int(time.time() - start_time)}")

        if not not_save:
            for iface, fn in zip(interfaces, save_fns):
                save_checkpoint(os.path.join(save_dir, "latest_" + fn), iface, epoch,
                                args=args, description=desc)

        if epoch % val_epoch == val_epoch - 1:
            summaries = validate(epoch, interfaces, dataloaders, params, args, verbose)
            for iface, fn, summary in zip(interfaces, save_fns, summaries):
                if summary < iface.best_err:
                    iface.best_err = summary
                    if not not_save:
                        save_checkpoint(os.path.join(save_dir, fn), iface, epoch,
                                        args=args, description=desc)
                        if verbose:
                            print(f"[][] Model {fn} saved at epoch {epoch}.")
                if verbose:
                    print(f"[][] Model {fn} RelMSE: {summary * 1000:.3f}e-3 \t "
                          f"Best RelMSE: {iface.best_err * 1000:.3f}e-3")

        # epoch-end schedulers: params['sched_<model>'] -> lr callable
        for key, sched in params.items():
            if not key.startswith("sched_"):
                continue
            name = key[len("sched_"):]
            for iface in interfaces:
                if name in iface.models:
                    set_learning_rate(iface.optims["optim_" + name], sched(epoch))
    if verbose:
        print("[] Training complete!")
