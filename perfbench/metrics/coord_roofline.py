"""K3's share of its roofline over the traced chain: the least time the
chip needs for the coordinate update of every K3 launch (one a layer of
each denoiser call) over the time K3's kernels took, %. K3 is the port's
coordinate update on the neighbor list (``cmdgen_tpu_torch/ops/egnn_coord.py``,
the device function ``coord_update_agg_kernel``); it belongs to the kernels
layer, whose name in ``BENCHMARK.json`` lists K1 and K2. The work is counted
from ``work.Graph``'s rows that move and their in-cutoff edges
(``moving_edges``): operations, coord_mid's product and the gate's dot on
each edge; bytes, each input read once and each output written once (the
projections w_i h of the moving rows and w_j h of every row, x in and out,
each edge's int64 neighbor index, dist0 and kmask, the weights). Where no
K3 kernel ran (a program without it) it reads nothing."""
from perfbench.harness import trace, work


def coord_work(g: work.Graph, hidden: int, dtype: str):
    """(flops, bytes) of one K3 launch: one block's coordinate update."""
    es = work.ELEMENT_BYTES[dtype]
    flops = 2 * g.moving_edges * hidden * hidden + 2 * g.moving_edges * hidden
    nbytes = ((g.moving + g.nodes) * hidden * es     # w_i h (moving rows), w_j h in
              + 2 * g.nodes * 3 * 4                 # x in, x out (float32)
              + g.moving_edges * (8 + 2 * es)       # index (int64), dist0, kmask of each edge
              + (hidden * hidden + 4 * hidden) * es)  # coord_mid, its bias, w_e, the gate
    return flops, nbytes


def read(run):
    ev = run.events
    if ev is None or not run.graphs:
        return None
    seconds, count = trace.kernel_seconds(ev, "coord_update_agg_kernel")
    if not count:
        return None
    e = run.cell.config["dynamics"]["egnn"]
    bound = sum(e["n_layers"] * work.roofline_seconds(
        *coord_work(g, e["hidden_nf"], run.dtype), run.dtype) for g in run.graphs)
    return 100.0 * bound / seconds
