"""The idle time's attribution to the program's layers (``harness/spans``)
on synthetic events, and the six readers on spans the program records."""
import time
import types

import pytest
from torch.profiler import ProfilerActivity, profile

from perfbench.harness import spans as spansmod
from perfbench.harness.spec import reader_of
from perfbench.harness.trace import Events

from cmdgen_tpu_torch.utils import profiling

READERS = ["sampler_idle_share", "dispatch_idle_share", "kernel_call_idle_share"]


def chain(device, start=0, end=100):
    return Events(device=[("k", s, e, i) for i, (s, e) in enumerate(device)], api=[],
                  start=start, end=end)


def test_the_innermost_span_takes_the_idle_time():
    """Busy [10, 20) and [30, 40) of [0, 100); a batch, a step, a denoiser
    call and a K1 call nested in it; worked out by hand."""
    ev = chain([(10, 20), (30, 40)])
    spans = [("sampler.batch", 5, 90), ("sampler.step", 15, 60), ("denoiser", 22, 55),
             ("kernel.k1", 25, 28)]
    got = {k: v * 1e9 for k, v in spansmod.idle_by_layer(ev, spans).items()}
    assert got == pytest.approx({"sampler": 42, "dispatch": 20, "kernel_call": 3,
                                 "outside": 15}, abs=1e-9)


def test_the_chains_ends_are_outside_and_the_parts_sum_to_the_idle_time():
    ev = chain([(0, 3), (50, 60), (58, 70), (95, 130)], start=0, end=120)
    spans = [("sampler.batch", 10, 90), ("sampler.step", 20, 80), ("denoiser", 20, 40),
             ("kernel.k2", 30, 35), ("sampler.step", 80, 90),
             ("unknown", 0, 120), ("denoiser", 200, 300)]
    got = spansmod.idle_by_layer(ev, spans)
    # idle: [3, 50), [70, 95); outside the batch: [3, 10) and [90, 95)
    assert got["outside"] * 1e9 == pytest.approx(12)
    assert got["kernel_call"] * 1e9 == pytest.approx(5)
    # the step and the denoiser that start together: the shorter is innermost
    assert got["dispatch"] * 1e9 == pytest.approx(15)
    # [10, 20), [40, 50) and [70, 90); a span of no known name is no layer's
    assert got["sampler"] * 1e9 == pytest.approx(40)
    run = types.SimpleNamespace(events=ev)
    idle = reader_of("device_idle_share")(run) / 100.0 * (ev.end - ev.start) / 1e9
    assert sum(got.values()) == pytest.approx(idle, rel=1e-12)


def test_the_readers_take_the_programs_spans_and_sum_to_the_idle_share():
    with profile(activities=[ProfilerActivity.CPU]):
        start = time.time_ns()
        with profiling.span("sampler.batch", request=True):
            with profiling.span("sampler.step"):
                with profiling.span("denoiser"):
                    with profiling.span("kernel.k1"):
                        time.sleep(0.002)
                    time.sleep(0.002)
        end = time.time_ns()
    ev = chain([(start + 10, start + 20)], start, end)
    run = types.SimpleNamespace(events=ev)
    got = {name: reader_of(name)(run) for name in READERS}
    assert all(v is not None and v > 0 for v in got.values()), got
    assert {name: reader_of(name + ".host_bound")(run) for name in READERS} == got
    idle = reader_of("device_idle_share")(run)
    assert idle - 1.0 < sum(got.values()) <= idle
    profiling.clear_spans()


def test_the_readers_find_nothing_without_spans(monkeypatch):
    profiling.clear_spans()
    run = types.SimpleNamespace(events=chain([(10, 20)]))
    assert all(reader_of(name)(run) is None for name in READERS)
    assert all(reader_of(name)(types.SimpleNamespace(events=None)) is None for name in READERS)
    # a program from before the spans, without the accessor
    monkeypatch.delattr(profiling, "spans")
    assert all(reader_of(name)(run) is None for name in READERS)
