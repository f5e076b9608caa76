"""Seconds from the start of the process to the first timed call: imports,
the CUDA context, the kernels' build or load, weights, inputs and the
warm-up chains (host clock)."""


def read(run):
    return run.setup_s
