"""The share of the neighbour list's slots that K1 and K3 put through their
product, %: the edge rows their pre-pass packed into tiles (the live slots,
kmask non-zero) over the B x r x K slots of their launches. Read from the
program's device-side counters (``gcl_message_agg.edge_rows`` and
``coord_update_agg.edge_rows``, ``cmdgen_tpu_torch/ops/egnn_msgpass.py:
EdgeRows``), which count every launch of the run: the set-up's warm-up
chains, the window with its traced chain, and the chains run again after
it, all drawn as the traced chain is. Where the program has no such counter
(kernels that compute every slot) or launched neither kernel it reads
nothing."""


def read(run):
    if run.events is None:
        return None
    try:
        from cmdgen_tpu_torch.ops.egnn_coord import coord_update_agg
        from cmdgen_tpu_torch.ops.egnn_msgpass import gcl_message_agg
    except ImportError:
        return None
    counters = [getattr(f, "edge_rows", None) for f in (gcl_message_agg, coord_update_agg)]
    if any(c is None for c in counters):
        return None
    rows = slots = 0
    for c in counters:
        r, s = c()
        rows, slots = rows + r, slots + s
    return 100.0 * rows / slots if slots else None
