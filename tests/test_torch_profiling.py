"""The port's profiling helpers against the JAX package's: the meters and
``time_since`` give the same numbers and text; ``device_trace`` writes a
``torch.profiler`` Chrome trace of the region (here the CPU's events) with
the port's spans in it. The spans: recorded only while a profiler
records, as one tree a batch of ``sample_pharmacophores`` on every engine
the CPU runs, kept in a bounded buffer."""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cmdgen_tpu.utils import profiling as jprofiling
from cmdgen_tpu_torch.diffusion.cddpm import ConditionalDDPM, DDPMConfig
from cmdgen_tpu_torch.diffusion.joint import JointDDPM
from cmdgen_tpu_torch.models.dynamics import DynamicsConfig, EGNNDynamics, make_fused_apply
from cmdgen_tpu_torch.models.egnn import EGNNConfig
from cmdgen_tpu_torch.pipeline.sample_phars import sample_pharmacophores
from cmdgen_tpu_torch.utils import profiling

torch.set_num_threads(1)

T = 3  # reverse steps of a chain
BATCHES = 2
ENGINES = ["msgpass", "fused", "dense", "joint"]


@pytest.fixture(autouse=True)
def no_spans():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


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


def test_device_trace_writes_a_trace(tmp_path):
    with profiling.device_trace(tmp_path / "trace") as prof:
        torch.ones(32, 32) @ torch.ones(32, 32)
    trace = json.loads((tmp_path / "trace" / profiling.TRACE_FILE).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any(n and "mm" in n for n in names)
    assert any(e.key.startswith("aten::mm") for e in prof.key_averages())


def _model(engine):
    """A tiny sampler on ``engine``: K1's path (``msgpass``, neighbour list),
    K2's (``fused``), the dense pairs, or the joint model's inpainting."""
    torch.manual_seed(0)
    egnn = EGNNConfig(hidden_nf=16, n_layers=2, neighbor_k=None if engine == "dense" else 6)
    dyn = EGNNDynamics(DynamicsConfig(phar_nf=8, residue_nf=20, joint_nf=8, egnn=egnn,
                                      update_pocket_coords=engine == "joint")).eval()
    if engine == "joint":
        return JointDDPM(DDPMConfig(timesteps=T), dyn)
    return ConditionalDDPM(DDPMConfig(timesteps=T), dyn,
                           apply_fn=make_fused_apply(dyn) if engine == "fused" else None)


def _sample(model):
    rng = np.random.RandomState(0)
    coords = (rng.randn(12, 3) * 3.0).astype(np.float32)
    onehot = np.eye(20, dtype=np.float32)[rng.randint(0, 20, 12)]
    return sample_pharmacophores(model, coords, onehot, 3 * BATCHES, n_phar_max=5,
                                 batch_size=3, generator=torch.Generator().manual_seed(1))


def test_spans_follow_the_profilers_flag():
    """PyTorch's flag is set exactly while a profiler records (a PyTorch
    that moves it fails here), and a span is recorded only then."""
    from torch.autograd import profiler as autograd_profiler

    assert autograd_profiler._is_profiler_enabled is False
    with profiling.span("off"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
        with profiling.span("on"):
            pass
    assert autograd_profiler._is_profiler_enabled is False
    with profiling.span("off"):
        pass
    assert [s.name for s in profiling.spans()] == ["on"]


def test_a_chain_without_a_profiler_records_no_span():
    out = _sample(_model("msgpass"))
    assert len(out) == 3 * BATCHES and profiling.spans() == []


@pytest.mark.parametrize("engine", ENGINES)
def test_a_traced_chain_records_one_tree_a_batch(engine):
    with profile(activities=[ProfilerActivity.CPU]):
        _sample(_model(engine))
    got = profiling.spans()
    by_id = {s.id: s for s in got}
    assert len(by_id) == len(got)
    # the kernels' CPU paths open no kernel span
    assert {s.name for s in got} == {"sampler.batch", "sampler.step", "denoiser"}
    batches = [s for s in got if s.name == "sampler.batch"]
    assert len(batches) == BATCHES and all(b.parent is None for b in batches)
    assert len({b.request for b in batches}) == BATCHES and None not in {b.request
                                                                         for b in batches}
    for b in batches:
        steps = [s for s in got if s.parent == b.id]
        assert len(steps) == T + 1 and {s.name for s in steps} == {"sampler.step"}
        calls = [s for s in got if s.parent in {st.id for st in steps}]
        assert len(calls) == T + 1 and {s.name for s in calls} == {"denoiser"}
        assert {s.request for s in steps + calls} == {b.request}
    for s in got:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            outer = by_id[s.parent]
            assert outer.start_ns <= s.start_ns and s.end_ns <= outer.end_ns


def test_the_buffer_keeps_the_newest_spans_and_counts_the_rest(monkeypatch):
    monkeypatch.setattr(profiling, "_RECORDER", profiling._Recorder(4))
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(6):
            with profiling.span(f"s{i}"):
                pass
    assert [s.name for s in profiling.spans()] == ["s2", "s3", "s4", "s5"]
    assert profiling.dropped_spans() == 2
    profiling.clear_spans()
    assert profiling.spans() == [] and profiling.dropped_spans() == 0


def test_device_trace_puts_the_spans_on_the_ops_timeline(tmp_path):
    """Every ``aten::linear`` (the sampler itself has none) lies inside a
    ``denoiser`` span of the same trace; the buffer is drained."""
    with profiling.device_trace(tmp_path):
        _sample(_model("msgpass"))
    trace = json.loads((tmp_path / profiling.TRACE_FILE).read_text())
    events = trace["traceEvents"]
    spans = [e for e in events if e.get("cat") == "span"]
    assert sum(e["name"] == "sampler.batch" for e in spans) == BATCHES
    assert trace["spansDropped"] == 0
    calls = [(e["ts"], e["ts"] + e["dur"]) for e in spans if e["name"] == "denoiser"]
    assert len(calls) == BATCHES * (T + 1)
    linear = [e for e in events if e.get("ph") == "X" and e.get("name") == "aten::linear"]
    assert linear
    for e in linear:
        assert any(s <= e["ts"] and e["ts"] + e["dur"] <= t for s, t in calls), e
    assert profiling.spans() == []
