"""Starting the ranks of a multi-device run.

The reference runs all its devices from one process; the port runs one
process per rank (``torch.multiprocessing``, spawn), each joining one
``torch.distributed`` process group: NCCL when every rank has a card of
its own, gloo on the CPU or for ranks that share one card.  The ranks
meet at a ``file://`` rendezvous in a directory the caller owns (no
port to pick, so several runs on one machine never collide).

* :func:`init_rank` joins this process to the group.
* :class:`RankPool` keeps a world of ranks up and runs one task after
  another on all of them (the training entry points' ``--n_devices``,
  the tests, the dry run and ``chip_smoke.py``).

A task is a function importable by name (the ranks are fresh
interpreters); its arguments and results travel pickled, so they are
numpy arrays, numbers and dicts of them.
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import traceback
from typing import Optional, Sequence

import torch
import torch.distributed as dist

TIMEOUT_S = 600


def init_rank(rank: int, world: int, init_method: str, backend: str = "gloo", device=None):
    """Join the process group as ``rank`` of ``world`` (``device``, a
    card, becomes this process's current card).  A collective that waits
    longer than ``TIMEOUT_S`` raises instead of hanging."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))


def _rendezvous(directory: Optional[str]) -> tuple:
    """(init_method, directory to remove afterwards or None)."""
    own = directory is None
    directory = tempfile.mkdtemp(prefix="wcmc_rdv_") if own else directory
    path = os.path.join(directory, "rendezvous")
    if os.path.exists(path):
        raise FileExistsError(f"{path} exists: a rendezvous file must be new")
    return "file://" + path, (directory if own else None)


def _pool_main(rank, world, init_method, backend, device, tasks, results, threads):
    try:
        if threads:
            torch.set_num_threads(threads)
        init_rank(rank, world, init_method, backend, device)
        results.put((rank, True, None))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        return
    while True:
        item = tasks.get()
        if item is None:
            break
        fn, args = item
        try:
            results.put((rank, True, fn(*args)))
        except Exception:    # reported to the caller; the rank takes the next task
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    """``world`` spawned ranks of one process group that stay up between
    tasks: ``pool.run(fn, *args)`` runs ``fn(*args)`` on every rank and
    returns the results in rank order.  ``devices`` names each rank's
    device (a card shared by several gloo ranks too); ``threads`` caps
    each rank's intra-op threads.  Use it as a context manager."""

    def __init__(self, world: int, backend: str = "gloo", devices: Optional[Sequence] = None,
                 rendezvous_dir: Optional[str] = None, threads: int = 0):
        ctx = torch.multiprocessing.get_context("spawn")
        self.world = world
        init_method, self._own = _rendezvous(rendezvous_dir)
        self._tasks = [ctx.SimpleQueue() for _ in range(world)]
        self._results = ctx.Queue()
        self._procs = [
            ctx.Process(target=_pool_main, daemon=True,
                        args=(r, world, init_method, backend, devices[r] if devices else None,
                              self._tasks[r], self._results, threads))
            for r in range(world)]
        for p in self._procs:
            p.start()
        try:
            self._collect("joining the process group")
        except BaseException:
            self.close()
            raise

    def _collect(self, what):
        out, errors = [None] * self.world, []
        for _ in range(self.world):
            try:
                rank, ok, val = self._results.get(timeout=TIMEOUT_S + 60)
            except queue.Empty as exc:   # a rank is gone or stuck
                dead = [r for r, p in enumerate(self._procs) if not p.is_alive()]
                raise RuntimeError(f"no answer from the ranks {what} (dead: {dead})") from exc
            if ok:
                out[rank] = val
            else:
                errors.append(f"rank {rank}:\n{val}")
        if errors:
            raise RuntimeError(f"{what} failed on {len(errors)} rank(s):\n" + "\n".join(errors))
        return out

    def run(self, fn, *args) -> list:
        """``fn(*args)`` on every rank; the results in rank order."""
        for q in self._tasks:
            q.put((fn, args))
        return self._collect(getattr(fn, "__name__", "the task"))

    def close(self):
        import shutil

        for q, p in zip(self._tasks, self._procs):
            if p.is_alive():
                q.put(None)
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        if self._own:
            shutil.rmtree(self._own, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
