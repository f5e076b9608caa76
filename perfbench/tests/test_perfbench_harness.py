"""The harness's data, its result line and its work counts, on the CPU."""
import importlib
import io
import json
import re
import shutil
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from perfbench.harness import cell as cellmod, spec, work
from perfbench.harness.pockets import ca_pocket, full_atom_pocket

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
RESULT_KEYS = ("correct", "attempted", "failed", "metrics", "device", "breakdown", "checks")
CPU = torch.device("cpu")


def quiet(*_):
    pass


def test_every_cell_has_its_files():
    for w in BENCH["workloads"]:
        c = spec.load_cell(ROOT, w["name"])
        assert set(c.limits) == {"rerun_gap", "eps_gap", "step_gap", "x_gap", "type_gap",
                                 "mask_mismatch", "calls_mismatch"}
        for m in c.end_to_end + c.per_layer:
            assert callable(m.reader(c.root)), m.name
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("perfbench/")
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)


def test_names_units_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and all(NAME.match(k) for k in c["reduced"])
        assert LINE.match(c["why"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and NAME.match(w["config"]) and LINE.match(w["why"])
        assert w["chips"] in (1, 4)
        names.append(w["name"])
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
            names.append(m["name"])
            if kind == "per_layer":
                assert LINE.match(m["layer"]) and m["source"] in (
                    "device_trace", "program_span", "program_counter", "host_clock")
            else:
                assert m["source"] in ("device_trace", "host_clock")
                assert 0 < m["bound"] <= 0.25
    for n in names:
        assert NAME.match(n), n
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_cell_with_a_per_layer_metric_reports_clouds_per_s():
    """Each cell reports one throughput, ``clouds_per_s`` or, in the
    host-bound cell, ``clouds_per_s.host_bound``; every per-layer metric
    moves the one its cells report."""
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        assert m["moves"].split(".")[0] == "clouds_per_s"
        for name in m.get("workloads", cells):
            assert name in e2e[m["moves"]].get("workloads", cells)
    for name in cells:
        c = spec.load_cell(ROOT, name)
        rates = {m.name for m in c.end_to_end} - {"setup_s"}
        assert len(rates) == 1 and rates <= {"clouds_per_s", "clouds_per_s.host_bound"}
        assert "setup_s" in {m.name for m in c.end_to_end} and c.per_layer


def run_line(checkout, name, seed=2 ** 31 + 11, seconds=0.2):
    c = spec.load_cell(checkout, name, checkout / "perfbench")
    out = cellmod.run(c, seed, seconds, False, time.perf_counter(), CPU, quiet)
    buf = io.StringIO()
    with redirect_stdout(buf):
        cellmod.print_result(out, quiet)
    return json.loads(buf.getvalue().splitlines()[-1])


def test_a_cell_dropped_into_a_copy_is_found(tiny_checkout):
    co = tiny_checkout
    shutil.copy(co / "perfbench/traffic/ca-msgpass-b64.json",
                co / "perfbench/traffic/ca-msgpass-b2.json")
    t = json.loads((co / "perfbench/traffic/ca-msgpass-b2.json").read_text())
    t["batch"] = 2
    (co / "perfbench/traffic/ca-msgpass-b2.json").write_text(json.dumps(t))
    shutil.copy(co / "perfbench/limits/ca-msgpass-b64.json",
                co / "perfbench/limits/ca-msgpass-b2.json")
    bench = json.loads((co / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "ca-msgpass-b2", "config": "diffphar-ca",
                               "traffic": "ca-msgpass-b2", "chips": 1, "why": "a test cell"})
    (co / "BENCHMARK.json").write_text(json.dumps(bench))
    line = run_line(co, "ca-msgpass-b2")
    assert line["correct"] and line["attempted"] % 2 == 0


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_the_last_line_has_only_the_result_keys(tiny_checkout, name):
    line = run_line(tiny_checkout, name)
    assert set(line) <= set(RESULT_KEYS) and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) in ({"clouds_per_s", "setup_s"},
                                    {"clouds_per_s.host_bound", "setup_s"})
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())


def test_the_run_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    run = importlib.import_module("perfbench.run")
    assert run.main(["--workload", "ca-msgpass-b64", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def state(seed, atoms=40, npr=16, b=3, full_atom=False):
    rng = np.random.RandomState(seed)
    x, _ = (full_atom_pocket(rng, atoms) if full_atom else ca_pocket(rng, atoms))
    xq = torch.from_numpy(x).expand(b, *x.shape)
    xp = torch.randn(b, npr, 3, generator=torch.Generator().manual_seed(seed)) * 3.0
    mp = (torch.arange(npr)[None] < torch.tensor([[npr], [9], [3]])[:b]).float()
    return xp * mp[..., None], xq, mp, torch.ones(b, atoms)


def test_the_count_takes_no_engine():
    """Where K reaches every in-cutoff edge, K1's and K2's rule counts what
    the dense rule counts; the count has no engine to depend on."""
    xp, xq, mp, mq = state(3, atoms=60, full_atom=True)
    dense = work.graph(xp, xq, mp, mq, 6.0, None)
    assert work.graph(xp, xq, mp, mq, 6.0, 16 + 60) == dense
    cut = work.graph(xp, xq, mp, mq, 6.0, 4)
    assert cut.edges < dense.edges and cut.nodes == dense.nodes
    cfg = json.loads((ROOT / "perfbench/configs/diffphar-full-atom.json").read_text())
    assert work.denoiser_flops(dense, cfg) > work.denoiser_flops(cut, cfg) > 0


def test_the_count_is_below_every_slot_where_slots_are_masked():
    import chip_smoke

    xp, xq, mp, mq = state(4)
    b, n, k, h = xp.shape[0], xp.shape[1] + xq.shape[1], 12, 256
    g = work.graph(xp, xq, mp, mq, 6.0, k)
    slots_flops, _ = chip_smoke.k1_work(b, n, k, h, 4)
    flops, _ = work.k1(g, h, "float32")
    assert 0 < flops < slots_flops
    assert g.edges < b * n * k
    # with every slot real the two agree
    full = work.Graph(nodes=b * n, moving=0, pocket=b * n, edges=b * n * k, moving_edges=0)
    assert work.k1(full, h, "float32")[0] == slots_flops
