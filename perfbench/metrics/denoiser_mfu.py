"""The whole reverse step's share of the chip's peak over the traced
chain: the model's operations for the in-cutoff edges and real nodes of
every denoiser call of the chain (``work.denoiser_flops``, the same
whichever engine runs) over the chain's length and the published peak, %."""
from perfbench.harness import work


def read(run):
    ev = run.events
    if ev is None or not run.graphs:
        return None
    flops = sum(work.denoiser_flops(g, run.cell.config) for g in run.graphs)
    return 100.0 * flops / ((ev.end - ev.start) / 1e9 * work.PEAK_FLOPS[run.dtype])
