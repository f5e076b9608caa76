"""Profiling + timing: torch.profiler traces and step timers (counterpart
of ``cmdgen_tpu/utils/profiling.py``).

The reference has no tracing at all (SURVEY.md §5) — only wall-clock prints
(AverageMeter/timeSince, GCPG/utils/utils.py:10-40). This module makes both
first-class: a device trace context around any code region, and functional
meters for the training loops. ``device_trace`` records with
``torch.profiler`` where the JAX package records with ``jax.profiler``; the
meters are copies.
"""
from __future__ import annotations

import contextlib
import math
import time
from pathlib import Path
from typing import Dict, Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(logdir):
    """Profile the region with ``torch.profiler``, the CPU and, where CUDA
    is available, the GPU's kernels, and write ``logdir/trace.json`` as a
    Chrome trace (chrome://tracing or Perfetto), also when the region
    raises. Yields the profiler, whose ``key_averages()`` sum the events."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = Path(logdir)
    path.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(str(path / TRACE_FILE))


class AverageMeter:
    """Running value/average meter (GCPG/utils/utils.py:10-25)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def time_since(since: float, fraction: float) -> str:
    """'elapsed (remain X)' progress string (utils.py:28-40)."""

    def fmt(s):
        m = math.floor(s / 60)
        return f"{m}m {int(s - m * 60)}s"

    now = time.time()
    elapsed = now - since
    total = elapsed / max(fraction, 1e-9)
    return f"{fmt(elapsed)} (remain {fmt(total - elapsed)})"


class StepTimer:
    """Per-phase wall-clock accounting for train/sample loops."""

    def __init__(self):
        self.meters: Dict[str, AverageMeter] = {}
        self._t0: Optional[float] = None
        self._phase: Optional[str] = None

    def start(self, phase: str):
        self._t0 = time.perf_counter()
        self._phase = phase

    def stop(self):
        if self._phase is None:
            return
        dt = time.perf_counter() - self._t0
        self.meters.setdefault(self._phase, AverageMeter()).update(dt)
        self._phase = None

    @contextlib.contextmanager
    def phase(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.stop()

    def summary(self) -> Dict[str, float]:
        return {k: m.avg for k, m in self.meters.items()}
