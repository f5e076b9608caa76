"""The share of the traced chain in which no operation ran on the device:
one minus the union of its device events over the chain's length, %."""
from perfbench.harness import trace


def read(run):
    ev = run.events
    if ev is None:
        return None
    busy = sum(e - s for s, e in trace.busy_intervals(ev))
    return 100.0 * (1.0 - busy / (ev.end - ev.start))
