"""Tests of the benchmark: the reference against the port on the CPU, the
harness's data and result line, the work counts, and the comparison's
faults and control. Tests marked ``cuda`` need the card and skip here."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


def shrink(checkout: Path) -> None:
    """Make every configuration and traffic file of a copied checkout tiny
    (hidden 16, 2 layers, T=6, B=3, small pockets), for runs on the CPU."""
    import json

    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        path = checkout / c["file"]
        cfg = json.loads(path.read_text())
        cfg["dynamics"]["egnn"].update(hidden_nf=16, n_layers=2)
        cfg["ddpm"]["timesteps"] = 6
        path.write_text(json.dumps(cfg))
    for path in (checkout / "perfbench" / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t["batch"] = 3
        t["pocket"]["atoms"] = 24 if t["pocket"]["kind"] == "ca" else 60
        if t.get("neighbor_k"):
            t["neighbor_k"] = min(t["neighbor_k"], 80)
        path.write_text(json.dumps(t))


@pytest.fixture
def tiny_checkout(tmp_path):
    """A copy of BENCHMARK.json and perfbench/ with tiny files."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shrink(tmp_path)
    return tmp_path
