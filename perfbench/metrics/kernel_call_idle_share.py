"""The share of the traced chain in which the device was idle while the
host was in K1's or K2's wrapper (``kernel.k1`` or ``kernel.k2`` the
innermost span open: checks, casts, plan and launch), % (``harness/spans``)."""
from perfbench.harness import spans


def read(run):
    return spans.idle_share(run, "kernel_call")
