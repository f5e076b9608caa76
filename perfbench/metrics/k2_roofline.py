"""K2's share of its roofline over the traced chain: the least time the
chip needs for the whole layer stack's in-cutoff work of every K2 launch
(``work.k2``, one a denoiser call), over the time K2's kernels took, %."""
from perfbench.harness import trace, work


def read(run):
    ev = run.events
    if ev is None or not run.graphs:
        return None
    seconds, count = trace.kernel_seconds(ev, "egnn_fused_kernel")
    if not count:
        return None
    e = run.cell.config["dynamics"]["egnn"]
    bound = sum(work.roofline_seconds(*work.k2(g, e["hidden_nf"], e["n_layers"], run.dtype),
                                      run.dtype) for g in run.graphs)
    return 100.0 * bound / seconds
