"""Host calls that launched device work (kernels, cooperative kernels,
graphs) per denoiser call (a reverse step, or the final decode) in the
traced chain. The trace's K1 and K2
kernels are held against the port's own launch counters: where they
disagree the trace missed launches and nothing is read."""
import sys

from perfbench.harness import trace


def read(run):
    ev = run.events
    if ev is None or not run.graphs:
        return None
    seen = {"gcl_message_agg": trace.kernel_seconds(ev, "gcl_message_agg_kernel")[1],
            "egnn_forward_fused": trace.kernel_seconds(ev, "egnn_fused_kernel")[1]}
    if seen != run.trace.counters:
        print(f"launches_per_step: trace kernels {seen} != launch counters "
              f"{run.trace.counters}", file=sys.stderr)
        return None
    return trace.launches(ev) / len(run.graphs)
