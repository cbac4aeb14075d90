"""Training observability: the metrics log, the profiler hook and step
timing.

Counterpart of ``wcmc_tpu/utils/observability.py``: ``MetricsWriter``
appends the same JSONL records (and TensorBoard events when
``tensorboardX`` imports), ``maybe_profile`` traces a block with
``torch.profiler`` (CPU, and CUDA where there is a card) into a
directory, and ``StepTimer`` keeps the rolling step times.
"""

from __future__ import annotations

import contextlib
import json
import os
import time


class MetricsWriter:
    """Append-only JSONL metrics log + optional TensorBoard events."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except ImportError:
                pass

    def log(self, step: int, values: dict, prefix: str = ""):
        rec = {"step": step, "time": time.time()}
        for k, v in values.items():
            key = f"{prefix}{k}"
            rec[key] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(key, float(v), step)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def profile_summary(prof, wall_ms: float, top: int = 20) -> dict:
    """Device busy time and idle share over ``wall_ms`` and the largest
    device entries (kernels and copies) of a finished ``torch.profiler``
    run."""
    from torch.autograd import DeviceType

    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    largest = sorted(device, key=lambda e: e.self_device_time_total, reverse=True)[:top]
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms if device and wall_ms > 0 else None,
        "top_device": [{"name": e.key[:90], "ms": e.self_device_time_total / 1e3,
                        "count": e.count} for e in largest],
    }


@contextlib.contextmanager
def maybe_profile(profile_dir: str | None):
    """Trace the enclosed block with torch.profiler when a directory is
    given: ``trace.json`` (Chrome trace) and ``summary.json``
    (``profile_summary``) are written there when the block ends."""
    if not profile_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    with open(os.path.join(profile_dir, "summary.json"), "w") as f:
        json.dump(profile_summary(prof, wall_ms), f, indent=1)


class StepTimer:
    """Rolling wall-clock step timing."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times = []
        self._all = []   # full history, for the step-time histogram
        self._last = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            self._all.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    def drain_all_ms(self):
        """Return and clear the full per-step history, in ms."""
        out = [1e3 * t for t in self._all]
        self._all = []
        return out

    def snapshot_ms(self):
        """Full per-step history, in ms, without clearing it (for
        periodic mid-epoch flushes that must survive a truncated run)."""
        return [1e3 * t for t in self._all]

    @property
    def mean_ms(self) -> float:
        if not self._times:
            return float("nan")
        return 1e3 * sum(self._times) / len(self._times)
