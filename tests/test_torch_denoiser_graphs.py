"""The denoiser's CUDA-graph replay (``models.dynamics.graphed_forward``)
on the CPU: which calls stay op by op and why, what the graph key reads,
and the graph cache's bookkeeping (one capture a key, the least recently
used dropped past ``GRAPH_CAPACITY``, a failed capture left op by op for
good, a deep copy of the module starting empty) with the capture itself
replaced by a stand-in, since a CUDA graph needs the card.
``tests/test_torch_kernels_cuda.py`` holds the replay against the
op-by-op pass on the card."""
import copy
import dataclasses

import pytest
import torch

from cmdgen_tpu_torch.config import ca_config
from cmdgen_tpu_torch.models import dynamics as dyn_module
from cmdgen_tpu_torch.models.dynamics import (
    GRAPH_CAPACITY, DenoiserGraphs, EGNNDynamics, graph_key, graph_refusal, graphed_forward)
from cmdgen_tpu_torch.ops.egnn_msgpass import gcl_message_agg

torch.set_num_threads(1)


def _model(neighbor_k=6, mode="egnn_dynamics", **egnn):
    cfg = ca_config().dynamics
    ecfg = dataclasses.replace(cfg.egnn, hidden_nf=16, n_layers=2, neighbor_k=neighbor_k,
                               **egnn)
    torch.manual_seed(0)
    return EGNNDynamics(dataclasses.replace(cfg, egnn=ecfg, mode=mode)).eval()


def _inputs(b=2, n_p=4, n_q=12, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, n_p, 3 + 8, generator=g), torch.randn(b, n_q, 3 + 20, generator=g) * 3,
            torch.rand(b, 1, generator=g), torch.ones(b, n_p), torch.ones(b, n_q))


def _counts():
    f = graphed_forward
    return (f.captures, f.replays, f.eager_calls, dict(f.eager_reasons))


def _delta(before):
    after = _counts()
    reasons = {k: v - before[3].get(k, 0) for k, v in after[3].items()
               if v != before[3].get(k, 0)}
    return tuple(a - b for a, b in zip(after[:3], before[:3])) + (reasons,)


@pytest.mark.parametrize("case,why", [
    ("cpu", "not on CUDA"),
    ("autograd", "autograd"),
    ("dense", "dense engine"),
    ("gnn", "gnn_dynamics"),
    ("mean aggregation", "torch message path"),
    ("sin_embedding", "torch message path"),
])
def test_calls_that_stay_op_by_op_are_counted_with_their_reason(case, why):
    """CPU inputs, grad mode, the dense engine, ``gnn_dynamics`` and GCLs
    off K1 run op by op: the call equals ``eager_forward`` exactly and
    counts one eager call under its reason, no capture and no replay."""
    kw = {"dense": dict(neighbor_k=None), "gnn": dict(mode="gnn_dynamics"),
          "mean aggregation": dict(aggregation_method="mean"),
          "sin_embedding": dict(sin_embedding=True)}.get(case, {})
    model = _model(**kw)
    inputs = _inputs()
    grad = case == "autograd"
    with torch.set_grad_enabled(grad):
        assert graph_refusal(model, inputs[0]) == why
        before = _counts()
        out = model(*inputs)
        assert _delta(before) == (0, 0, 1, {why: 1})
        ref = model.eager_forward(*inputs)
    for o, r in zip(out, ref):
        assert torch.equal(o, r)
    assert not model.graphs.graphs and not model.graphs.refused


def test_graph_key_follows_shapes_and_replaced_parameters_not_in_place_updates():
    """The key changes with an input's shape or dtype and with parameters
    replaced (``.to()``, ``load_state_dict`` into new tensors, a new
    ``Parameter``), and stays under in-place updates (an optimizer step,
    ``load_state_dict`` copying into the tensors)."""
    model = _model()
    inputs = _inputs()
    key = graph_key(model, inputs)
    assert graph_key(model, _inputs(seed=1)) == key  # values are not part of it
    for other in (_inputs(b=3), _inputs(n_p=5), _inputs(n_q=13),
                  inputs[:2] + (inputs[2].double(),) + inputs[3:]):
        assert graph_key(model, other) != key
    # in place: an optimizer step and a copying load_state_dict
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    model(*inputs)[0].sum().backward()
    opt.step()
    model.load_state_dict({k: v + 1 for k, v in model.state_dict().items()})
    assert graph_key(model, inputs) == key
    # replaced: into new tensors, one new Parameter, a conversion
    model.load_state_dict({k: v.clone() for k, v in model.state_dict().items()}, assign=True)
    assigned = graph_key(model, inputs)
    assert assigned != key
    layer = model.egnn.e_block_0.gcl_0.edge_out
    layer.weight = torch.nn.Parameter(layer.weight.detach().clone())
    replaced = graph_key(model, inputs)
    assert replaced not in (key, assigned)
    assert graph_key(model.double(), inputs) not in (key, assigned, replaced)


class _StandIn:
    """A captured graph's stand-in: replays ``eager_forward`` and counts
    two K1 launches a replay, as a two-layer graph does."""

    def __init__(self, model, inputs):
        self.model, self.shape = model, inputs[0].shape
        self.k1_launches = 2

    def replay(self, inputs):
        assert inputs[0].shape == self.shape
        gcl_message_agg.launches += self.k1_launches
        return self.model.eager_forward(*inputs)


@pytest.fixture
def stand_in(monkeypatch):
    """Graphs on the CPU: the gate lets every call through and the capture
    builds a ``_StandIn``; returns the list of captures made."""
    made = []

    def capture(self, model, inputs):
        made.append(inputs[0].shape)
        return _StandIn(model, inputs)

    monkeypatch.setattr(dyn_module, "graph_refusal", lambda model, xh: None)
    monkeypatch.setattr(DenoiserGraphs, "_capture", capture)
    return made


def test_one_capture_a_key_and_every_call_replays(stand_in):
    """The first call of a shape captures and replays, later calls replay;
    a new shape captures again; K1's counter gains the graph's launches
    at every replay; every result equals the op-by-op pass."""
    model = _model()
    before, launches = _counts(), gcl_message_agg.launches
    with torch.no_grad():
        for inputs in (_inputs(), _inputs(seed=1), _inputs(b=3), _inputs(seed=2)):
            for o, r in zip(model(*inputs), model.eager_forward(*inputs)):
                assert torch.equal(o, r)
    assert _delta(before) == (2, 4, 0, {})
    assert gcl_message_agg.launches - launches == 4 * 2
    assert stand_in == [torch.Size([2, 4, 11]), torch.Size([3, 4, 11])]


def test_least_recently_used_graph_goes_past_capacity(stand_in):
    """``GRAPH_CAPACITY`` graphs are kept; a new one drops the least
    recently replayed, which captures again when it comes back."""
    model = _model()
    with torch.no_grad():
        for b in range(1, GRAPH_CAPACITY + 1):
            model(*_inputs(b=b))
        model(*_inputs(b=1))  # b=2 is now the least recently used
        model(*_inputs(b=GRAPH_CAPACITY + 1))
        assert len(model.graphs.graphs) == GRAPH_CAPACITY
        before = _counts()
        model(*_inputs(b=1))
        assert _delta(before)[:2] == (0, 1)
        model(*_inputs(b=2))
        assert _delta(before)[:2] == (1, 2)


def test_new_parameters_capture_again_and_drop_the_old_graphs(stand_in):
    """Parameters replaced: the next call captures, and the graphs made
    for the old parameters go, with their pool and capture stream."""
    model = _model()
    with torch.no_grad():
        model(*_inputs())
        model(*_inputs(b=3))
        model.graphs.pool = model.graphs.stream = "the old parameters'"
        model.load_state_dict({k: v.clone() for k, v in model.state_dict().items()},
                              assign=True)
        before = _counts()
        model(*_inputs())
    assert _delta(before)[:2] == (1, 1)
    assert len(model.graphs.graphs) == 1
    # no graph of the old pool is left: the capture started a pool of its own
    assert model.graphs.pool is None and model.graphs.stream is None


def test_failed_capture_leaves_its_key_op_by_op_for_good(monkeypatch):
    """A capture that raises is counted and never raised: that key runs
    op by op from then on (one attempt), with its error kept; another
    key still captures."""
    model = _model()
    tries = []

    def capture(self, model, inputs):
        tries.append(inputs[0].shape)
        if inputs[0].shape[0] == 2:
            raise RuntimeError("operation not permitted when stream is capturing")
        return _StandIn(model, inputs)

    monkeypatch.setattr(dyn_module, "graph_refusal", lambda model, xh: None)
    monkeypatch.setattr(DenoiserGraphs, "_capture", capture)
    before = _counts()
    with torch.no_grad():
        for _ in range(3):
            out = model(*_inputs())
        model(*_inputs(b=3))
        ref = model.eager_forward(*_inputs())
    for o, r in zip(out, ref):
        assert torch.equal(o, r)
    assert _delta(before) == (1, 1, 3, {"capture failed": 3})
    assert tries == [torch.Size([2, 4, 11]), torch.Size([3, 4, 11])]
    (error,) = model.graphs.refused.values()
    assert "not permitted" in error


def test_a_deep_copy_of_the_module_starts_without_graphs(stand_in):
    """``copy.deepcopy`` (the training loop's evaluation copies) gives a
    module with an empty cache of its own."""
    model = _model()
    with torch.no_grad():
        model(*_inputs())
    assert len(model.graphs.graphs) == 1
    clone = copy.deepcopy(model)
    assert isinstance(clone.graphs, DenoiserGraphs) and clone.graphs is not model.graphs
    assert not clone.graphs.graphs and not clone.graphs.refused
