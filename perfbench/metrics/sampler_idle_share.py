"""The share of the traced chain in which the device was idle while the
host was in the sampler (``sampler.batch`` or ``sampler.step`` the
innermost span open: the sampler's update between denoiser calls, node
counts, the host copies and the answer's build), % (``harness/spans``)."""
from perfbench.harness import spans


def read(run):
    return spans.idle_share(run, "sampler")
