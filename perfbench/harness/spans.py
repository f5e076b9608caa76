"""The traced chain's idle time put down to the layer of the program that
the host was in.

The program records spans at its layer boundaries while a profiler
records (``cmdgen_tpu_torch.utils.profiling``: ``sampler.batch``,
``sampler.step``, ``denoiser``, ``kernel.k1``, ``kernel.k2``), on the
clock of the profiler's events. Each instant of the chain in which no
operation ran on the device (the complement of ``trace.busy_intervals``,
what ``device_idle_share`` reads) goes to the innermost span open at that
instant: ``sampler`` (a batch or a step), ``dispatch`` (the denoiser),
``kernel_call`` (the host side of a K1 or K2 launch), or ``outside``
where none is open. The four parts sum to the idle time. The spans only
say whose the idle time is; the time itself is the device trace's.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

from perfbench.harness import trace

LAYERS = {"sampler.batch": "sampler", "sampler.step": "sampler", "denoiser": "dispatch",
          "kernel.k1": "kernel_call", "kernel.k2": "kernel_call"}
PARTS = ("sampler", "dispatch", "kernel_call", "outside")

# (name, start, end) in the wall-clock ns of the trace's events
Interval = Tuple[str, int, int]


def program_spans(ev: trace.Events) -> Optional[List[Interval]]:
    """The program's spans of known names that overlap the chain, read
    through its public accessor; None where the program has no such
    accessor or recorded no span there."""
    from cmdgen_tpu_torch.utils import profiling

    accessor = getattr(profiling, "spans", None)
    if accessor is None:
        return None
    out = [(s.name, s.start_ns, s.end_ns) for s in accessor()
           if s.name in LAYERS and s.end_ns > ev.start and s.start_ns < ev.end]
    return out or None


def idle_intervals(ev: trace.Events) -> List[Tuple[int, int]]:
    """The chain's instants with no device activity, as sorted intervals."""
    out, t = [], ev.start
    for s, e in trace.busy_intervals(ev):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if ev.end > t:
        out.append((t, ev.end))
    return out


def layer_timeline(ev: trace.Events, spans: List[Interval]) -> List[Tuple[int, int, str]]:
    """[ev.start, ev.end] cut into (start, end, part) pieces: at each
    instant the part of the innermost open span of a known name (the latest
    started, the shorter of two started together), else ``outside``."""
    clipped = sorted((max(s, ev.start), min(e, ev.end), LAYERS[name])
                     for name, s, e in spans
                     if name in LAYERS and e > ev.start and s < ev.end)
    points = sorted({ev.start, ev.end} | {t for s, e, _ in clipped for t in (s, e)})
    open_: list = []
    pieces: List[Tuple[int, int, str]] = []
    j = 0
    for t0, t1 in zip(points, points[1:]):
        while j < len(clipped) and clipped[j][0] <= t0:
            s, e, part = clipped[j]
            heapq.heappush(open_, (-s, e, part))
            j += 1
        while open_ and open_[0][1] <= t0:
            heapq.heappop(open_)
        part = open_[0][2] if open_ else "outside"
        if pieces and pieces[-1][2] == part and pieces[-1][1] == t0:
            pieces[-1] = (pieces[-1][0], t1, part)
        else:
            pieces.append((t0, t1, part))
    return pieces


def idle_by_layer(ev: trace.Events, spans: List[Interval]) -> Dict[str, float]:
    """Seconds of the chain's idle time in each part of ``PARTS``."""
    pieces = layer_timeline(ev, spans)
    total = dict.fromkeys(PARTS, 0)
    i = 0
    for a, b in idle_intervals(ev):
        while i < len(pieces) and pieces[i][1] <= a:
            i += 1
        k = i
        while k < len(pieces) and pieces[k][0] < b:
            total[pieces[k][2]] += min(b, pieces[k][1]) - max(a, pieces[k][0])
            k += 1
    return {part: ns / 1e9 for part, ns in total.items()}


def idle_share(run, part: str) -> Optional[float]:
    """``part``'s idle seconds over the traced chain's length, %; None
    without a traced chain or without the program's spans in it."""
    ev = run.events
    if ev is None:
        return None
    spans = program_spans(ev)
    if spans is None:
        return None
    return 100.0 * idle_by_layer(ev, spans)[part] / ((ev.end - ev.start) / 1e9)
