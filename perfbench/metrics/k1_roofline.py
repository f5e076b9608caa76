"""K1's share of its roofline over the traced chain: the least time the
chip needs for the in-cutoff edges of every K1 launch (``work.k1``, one a
GCL), over the time K1's kernels took, %."""
from perfbench.harness import trace, work


def read(run):
    ev = run.events
    if ev is None or not run.graphs:
        return None
    seconds, count = trace.kernel_seconds(ev, "gcl_message_agg_kernel")
    if not count:
        return None
    e = run.cell.config["dynamics"]["egnn"]
    bound = sum(e["n_layers"] * work.roofline_seconds(*work.k1(g, e["hidden_nf"], run.dtype),
                                                      run.dtype) for g in run.graphs)
    return 100.0 * bound / seconds
