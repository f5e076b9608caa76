"""Profiling + timing: torch.profiler traces, spans at the port's layer
boundaries, and meters (counterpart of ``cmdgen_tpu/utils/profiling.py``).

The reference has no tracing at all (SURVEY.md §5) — only wall-clock prints
(AverageMeter/timeSince, GCPG/utils/utils.py:10-40). This module makes both
first-class: a device trace context around any code region, spans that say
which layer of the port the host was in, and functional meters for the
training loops. ``device_trace`` records with ``torch.profiler`` where the
JAX package records with ``jax.profiler``; the meters are copies.

**Spans.** ``with span("denoiser"):`` marks a layer boundary. A span is
recorded only while a ``torch.profiler`` session records (PyTorch's own
flag, ``torch.autograd.profiler._is_profiler_enabled``); otherwise a site
costs one flag check. Each recorded span has its name, start and end in ns
on ``time.time_ns()``, the clock of the profiler's events (kineto's
``start_ns()``), its own id, the id of the span open around it on the same
thread (its parent) and a request id: ``span(name, request=True)`` opens a
new request, and spans inside it share it. They are kept in memory, the
newest ``SPAN_CAPACITY``; ``spans()`` returns them and ``dropped_spans()``
counts those pushed out. The port's spans:

- ``sampler.batch``: one batch of ``sample_pharmacophores`` (a request);
- ``sampler.step``: one reverse step of ``sample_given_pocket`` or
  ``JointDDPM.inpaint``, or its final decode;
- ``denoiser``: one call of the dynamics (``EGNNDynamics.forward``,
  ``make_fused_apply``'s function);
- ``kernel.k1``, ``kernel.k2``: the host side of a K1 or K2 launch
  (checks, casts, plan, launch), on CUDA tensors only.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import math
import os
import threading
import time
from pathlib import Path
from typing import List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

TRACE_FILE = "trace.json"
# spans kept in memory; older ones are pushed out (a ca-config chain of 500
# steps records about 3,500)
SPAN_CAPACITY = 1 << 17
# the Chrome trace's thread id of the spans' track (no thread has id 0)
SPAN_TRACK = 0


class Span(NamedTuple):
    """One recorded span; times in ns on ``time.time_ns()``."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    request: Optional[int]


class _Recorder:
    """The process's spans: a bounded buffer, the count pushed out of it,
    and each thread's stack of open spans."""

    def __init__(self, capacity: int):
        self.kept: collections.deque = collections.deque(maxlen=capacity)
        self.dropped = 0
        self.lock = threading.Lock()
        self.ids = itertools.count(1)
        self.requests = itertools.count(1)
        self.local = threading.local()

    def stack(self) -> list:
        return self.local.__dict__.setdefault("stack", [])

    def keep(self, s: Span) -> None:
        with self.lock:
            if len(self.kept) == self.kept.maxlen:
                self.dropped += 1
            self.kept.append(s)


_RECORDER = _Recorder(SPAN_CAPACITY)
_OFF = contextlib.nullcontext()


class _OpenSpan:
    __slots__ = ("name", "new_request", "id", "parent", "request", "start")

    def __init__(self, name: str, new_request: bool):
        self.name = name
        self.new_request = new_request

    def __enter__(self):
        stack = _RECORDER.stack()
        outer = stack[-1] if stack else None
        self.id = next(_RECORDER.ids)
        self.parent = outer.id if outer else None
        self.request = (next(_RECORDER.requests) if self.new_request
                        else outer.request if outer else None)
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _RECORDER.stack().pop()
        _RECORDER.keep(Span(self.name, self.start, end, self.id, self.parent, self.request))
        return False


def span(name: str, request: bool = False):
    """A context that records the region as span ``name`` while a
    ``torch.profiler`` session records, and does nothing otherwise;
    ``request``: the span opens a new request id."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _OpenSpan(name, request)


def spans() -> List[Span]:
    """The recorded spans, in the order they ended."""
    with _RECORDER.lock:
        return list(_RECORDER.kept)


def dropped_spans() -> int:
    """Spans pushed out of the buffer since it was last cleared."""
    return _RECORDER.dropped


def clear_spans() -> None:
    with _RECORDER.lock:
        _RECORDER.kept.clear()
        _RECORDER.dropped = 0


def _write_spans(path: Path, recorded: List[Span], dropped: int) -> None:
    """Add ``recorded`` to the Chrome trace at ``path`` as complete events
    on a track of their own, on the profiler events' timeline."""
    trace = json.loads(path.read_text())
    base = trace.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    events = trace.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": SPAN_TRACK,
                   "args": {"name": "cmdgen_tpu_torch spans"}})
    for s in recorded:
        events.append({"ph": "X", "cat": "span", "name": s.name, "pid": pid,
                       "tid": SPAN_TRACK, "ts": (s.start_ns - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"id": s.id, "parent": s.parent, "request": s.request}})
    trace["spansDropped"] = dropped
    path.write_text(json.dumps(trace))


@contextlib.contextmanager
def device_trace(logdir):
    """Profile the region with ``torch.profiler``, the CPU and, where CUDA
    is available, the GPU's kernels, and write ``logdir/trace.json`` as a
    Chrome trace (chrome://tracing or Perfetto), also when the region
    raises. The port's spans recorded in the region go into the same
    trace, on a track of their own (``spansDropped`` counts any pushed out
    of the buffer); the buffer is cleared when the region starts and when
    the trace is written. Yields the profiler, whose ``key_averages()`` sum
    the events."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = Path(logdir)
    path.mkdir(parents=True, exist_ok=True)
    clear_spans()
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(str(path / TRACE_FILE))
        _write_spans(path / TRACE_FILE, spans(), dropped_spans())
        clear_spans()


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
