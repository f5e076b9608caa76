"""The port's profiling helpers against the JAX package's: the meters and
``time_since`` give the same numbers and text; ``device_trace`` writes a
``torch.profiler`` Chrome trace of the region (here the CPU's events)."""
import json

import pytest
import torch

from cmdgen_tpu.utils import profiling as jprofiling
from cmdgen_tpu_torch.utils import profiling


def test_average_meter_matches_jax():
    got, want = profiling.AverageMeter(), jprofiling.AverageMeter()
    for v, n in [(1.5, 1), (3.0, 4), (-2.0, 2), (0.25, 1)]:
        got.update(v, n)
        want.update(v, n)
        assert (got.val, got.sum, got.count, got.avg) == (want.val, want.sum, want.count,
                                                          want.avg)
    got.reset()
    assert (got.val, got.sum, got.count, got.avg) == (0.0, 0.0, 0, 0.0)


@pytest.mark.parametrize("elapsed,fraction", [(0.0, 0.5), (75.0, 0.25), (3725.0, 0.9),
                                              (10.0, 0.0)])
def test_time_since_matches_jax(monkeypatch, elapsed, fraction):
    monkeypatch.setattr(profiling.time, "time", lambda: 1000.0 + elapsed)
    monkeypatch.setattr(jprofiling.time, "time", lambda: 1000.0 + elapsed)
    assert profiling.time_since(1000.0, fraction) == jprofiling.time_since(1000.0, fraction)


def test_step_timer_matches_jax(monkeypatch):
    summaries = []
    for mod in (profiling, jprofiling):
        ticks = iter([0.0, 0.5, 1.0, 1.25, 2.0, 3.5])
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks))
        t = mod.StepTimer()
        with t.phase("data"):
            pass
        t.start("step")
        t.stop()
        t.stop()  # no phase open: a no-op
        with t.phase("data"):
            pass
        summaries.append(t.summary())
    assert summaries[0] == summaries[1] == {"data": 1.0, "step": 0.25}


def test_device_trace_writes_a_trace(tmp_path):
    with profiling.device_trace(tmp_path / "trace") as prof:
        torch.ones(32, 32) @ torch.ones(32, 32)
    trace = json.loads((tmp_path / "trace" / profiling.TRACE_FILE).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any(n and "mm" in n for n in names)
    assert any(e.key.startswith("aten::mm") for e in prof.key_averages())
