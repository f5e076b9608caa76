"""A traced chain and its reduction.

``ChainTrace`` profiles the window's first chain, one whole call of the
entry, with device activity only (kernels, copies and the CUDA API calls
of the host; host op recording would slow the host-bound cells' dispatch
about twofold). CUPTI's callbacks on the API calls still slow the host's
dispatch, so in a host-bound cell the traced chain runs slower than the
window's others (each traced run logs both). The functions below turn the
profiler's raw kineto events into the numbers the per-layer readers take.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

# host calls that put work on the device: kernels, cooperative kernels and
# graphs (runtime and driver API)
LAUNCH_CALLS = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
    "cudaLaunchCooperativeKernelMultiDevice", "cudaGraphLaunch", "cuLaunchKernel",
    "cuLaunchKernelEx", "cuLaunchCooperativeKernel", "cuGraphLaunch",
})


@dataclasses.dataclass
class Events:
    """The traced span's events as plain tuples (wall-clock ns): device
    (name, start, end, correlation), host API calls (name, start, end,
    correlation), and the span's bounds."""

    device: List[Tuple[str, int, int, int]]
    api: List[Tuple[str, int, int, int]]
    start: int
    end: int


class ChainTrace:
    """Profiles one whole chain of the entry: ``torch.profiler`` with device
    activity (kernels, copies and the CUDA API calls of the host) between
    two synchronisations of the device, whose host times bound the span;
    the port's K1 and K2 launch counters over the same span (``counters``);
    and how its denoiser calls ran there (``calls``: the module's CUDA graph
    ``captures``, ``replays`` and ``eager_calls``, ``graphed_forward``'s
    counters; ``eager_reasons``, why the calls that ran op by op did).
    ``off_graph`` names the calls that ran op by op, for the run's log."""

    def __init__(self):
        self.events: Optional[Events] = None
        self.counters: Dict[str, int] = {}
        self.calls: Dict[str, int] = {}
        self.eager_reasons: Dict[str, int] = {}
        self._prof = None
        self._start = 0

    @staticmethod
    def warm_up(device: torch.device) -> None:
        """Start the profiler once outside the window: its first start
        loads the tracing library."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.ones(1, device=device).add_(1)
            torch.cuda.synchronize(device)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        from cmdgen_tpu_torch.models.dynamics import graphed_forward
        from cmdgen_tpu_torch.ops.egnn_fused import egnn_forward_fused
        from cmdgen_tpu_torch.ops.egnn_msgpass import gcl_message_agg

        torch.cuda.synchronize()
        self._launch_counters = (gcl_message_agg, egnn_forward_fused)
        self._before = [f.launches for f in self._launch_counters]
        self._graphed = graphed_forward
        self._calls_before = self._call_counts()
        self._reasons_before = collections.Counter(graphed_forward.eager_reasons)
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self._start = time.time_ns()

    def stop(self) -> None:
        torch.cuda.synchronize()
        end = time.time_ns()
        self._prof.stop()
        self.counters = {f.__name__: f.launches - b
                         for f, b in zip(self._launch_counters, self._before)}
        self.calls = {k: v - self._calls_before[k] for k, v in self._call_counts().items()}
        self.eager_reasons = dict(collections.Counter(self._graphed.eager_reasons)
                                  - self._reasons_before)
        self.events = collect(self._prof, self._start, end)
        self._prof = None

    def _call_counts(self) -> Dict[str, int]:
        return {k: getattr(self._graphed, k) for k in ("captures", "replays", "eager_calls")}

    def off_graph(self) -> Optional[str]:
        """A warning where some of the traced chain's denoiser calls ran op
        by op or captured a graph inside the window (a cell whose engine the
        program replays should read ``replays`` only), else None."""
        eager, captures = self.calls.get("eager_calls", 0), self.calls.get("captures", 0)
        if not eager and not captures:
            return None
        return (f"warning: of the traced chain's denoiser calls {eager} ran op by op "
                f"(the program's reasons: {self.eager_reasons}) and {captures} captured a "
                f"CUDA graph; {self.calls.get('replays', 0)} replayed one")


def collect(prof, start: int, end: int) -> Events:
    """The raw kineto events of a finished profile, kept as tuples."""
    from torch.autograd import DeviceType

    device, api = [], []
    for e in prof.profiler.kineto_results.events():
        if e.is_hidden_event():
            continue
        row = (e.name(), e.start_ns(), e.end_ns(), e.correlation_id())
        (device if e.device_type() == DeviceType.CUDA else api).append(row)
    return Events(device, api, start, end)


def busy_intervals(ev: Events) -> List[Tuple[int, int]]:
    """The union of device activity inside the span, as sorted intervals."""
    spans = sorted((max(s, ev.start), min(e, ev.end)) for _, s, e, _ in ev.device
                   if e > ev.start and s < ev.end)
    merged: List[Tuple[int, int]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def launches(ev: Events) -> int:
    """Host calls inside the span that launched device work."""
    return sum(1 for name, s, _, _ in ev.api if name in LAUNCH_CALLS and ev.start <= s < ev.end)


def kernel_seconds(ev: Events, prefix: str) -> Tuple[float, int]:
    """(seconds, count) of the device events whose name starts with ``prefix``
    (a kernel's name as the compiler prints it, e.g. ``void name<...>``
    shortened to its function name)."""
    total, count = 0, 0
    for name, s, e, _ in ev.device:
        if kernel_name(name).startswith(prefix):
            total += e - s
            count += 1
    return total / 1e9, count


def kernel_name(name: str) -> str:
    """A device event's function name: without a leading ``void ``, its
    namespaces and its template arguments."""
    if name.startswith("void "):
        name = name[5:]
    name = name.replace("(anonymous namespace)::", "")
    return name.split("<", 1)[0].split("(", 1)[0].rsplit("::", 1)[-1]


def breakdown(ev: Events, top: int = 10) -> Dict[str, list]:
    """The device ops that took most time, and the idle gaps grouped by
    what the host was doing: the API call that launched the work that ended
    the gap, and that work's kernel."""
    by_name: Dict[str, float] = collections.defaultdict(float)
    for name, s, e, _ in ev.device:
        by_name[name[:160]] += (e - s) / 1e9
    api_by_corr = {c: name for name, _, _, c in ev.api}
    first_after = sorted((s, corr, name) for name, s, _, corr in ev.device)
    gaps: Dict[str, float] = collections.defaultdict(float)
    busy = busy_intervals(ev)
    edges = [(ev.start, ev.start)] + busy + [(ev.end, ev.end)]
    for (_, prev_end), (next_start, _) in zip(edges, edges[1:]):
        if next_start <= prev_end:
            continue
        i = bisect.bisect_left(first_after, (next_start, -1, ""))
        label = "span end"
        if i < len(first_after) and next_start < ev.end:
            _, corr, kname = first_after[i]
            label = f"{api_by_corr.get(corr, '?')} -> {kernel_name(kname)[:80]}"
        gaps[label] += (next_start - prev_end) / 1e9
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(by_name), "idle_gaps": rank(gaps)}
