"""``edge_rows_share``: the program's edge-row counters read as a share of
the slots, and nothing where the program has none."""
import pytest

from perfbench.harness import cell as cellmod, spec, trace

from conftest import ROOT


def traced_run(name="fa-k160-b16"):
    run = cellmod.Run(spec.load_cell(ROOT, name))
    run.trace = trace.ChainTrace()
    run.trace.events = trace.Events([], [], 0, 1)
    return run


@pytest.mark.parametrize("name", ["edge_rows_share", "edge_rows_share.host_bound"])
def test_edge_rows_share_reads_both_kernels_counters(monkeypatch, name):
    from cmdgen_tpu_torch.ops import egnn_coord, egnn_msgpass

    monkeypatch.setattr(egnn_msgpass.gcl_message_agg, "edge_rows", lambda: (38, 100))
    monkeypatch.setattr(egnn_coord.coord_update_agg, "edge_rows", lambda: (2, 10))
    assert spec.reader_of(name)(traced_run()) == pytest.approx(100.0 * 40 / 110)
    assert spec.reader_of(name)(cellmod.Run(spec.load_cell(ROOT, "fa-k160-b16"))) is None


def test_edge_rows_share_reads_nothing_without_the_counter(monkeypatch):
    from cmdgen_tpu_torch.ops import egnn_msgpass

    read = spec.reader_of("edge_rows_share")
    monkeypatch.setattr(egnn_msgpass.gcl_message_agg, "edge_rows", lambda: (0, 0))
    assert read(traced_run()) is None  # no launch: no slot
    monkeypatch.delattr(egnn_msgpass.gcl_message_agg, "edge_rows")
    assert read(traced_run()) is None  # a program without the counter
