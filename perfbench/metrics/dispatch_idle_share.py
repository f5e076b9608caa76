"""The share of the traced chain in which the device was idle while the
host was in the denoiser outside a kernel wrapper (``denoiser`` the
innermost span open: encoders, adjacency, neighbour list, the EGNN's
PyTorch ops, decoders), % (``harness/spans``)."""
from perfbench.harness import spans


def read(run):
    return spans.idle_share(run, "dispatch")
