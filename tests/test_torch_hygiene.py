"""Hygiene of the port: it imports no JAX and nothing of ``cmdgen_tpu``,
every module imports with JAX blocked, nothing imports networkx (the
card's machine need not have it), and entry points called without a
device raise where CUDA is absent (no silent move to the CPU)."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cmdgen_tpu_torch.convert import load_port_checkpoint
from cmdgen_tpu_torch.device import resolve_device
from cmdgen_tpu_torch.parallel import check, launch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "cmdgen_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax")


def _package_files():
    """The package's Python sources (not the kernel build directory)."""
    return sorted(f for f in PKG.rglob("*.py") if "_build" not in f.relative_to(PKG).parts)


def _port_files():
    return _package_files() + [REPO / "chip_smoke.py"]


def _modules():
    out = []
    for f in _package_files():
        rel = f.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_source_scan_no_jax_and_no_cmdgen_tpu_imports():
    bad = []
    for f in _port_files():
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                top = name.split(".")[0]
                if top in FORBIDDEN or top == "cmdgen_tpu":
                    bad.append(f"{f.relative_to(REPO)}: {name}")
    assert not bad, bad


def test_every_module_imports_with_jax_blocked():
    blocked = "; ".join(f"sys.modules[{m!r}] = None" for m in FORBIDDEN)
    code = (
        f"import sys; {blocked}; sys.modules['cmdgen_tpu'] = None\n"
        "import importlib, importlib.util\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "assert not any(k.split('.')[0] in ('jax', 'flax') and sys.modules[k] is not None"
        " for k in sys.modules)\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr[-3000:]


def test_no_networkx_on_any_path():
    """No port file imports networkx; every module imports with it
    blocked, and the paths that reached it in the JAX package run: the
    kekulization fallback (forced by a zero budget), fragments, and the
    isomorphism RMSD."""
    bad = [f"{f.relative_to(REPO)}: {node.lineno}" for f in _port_files()
           for node in ast.walk(ast.parse(f.read_text()))
           if (isinstance(node, ast.Import)
               and any(a.name.split(".")[0] == "networkx" for a in node.names))
           or (isinstance(node, ast.ImportFrom) and (node.module or "").split(".")[0] == "networkx")]
    assert not bad, bad
    code = (
        "import sys; sys.modules['networkx'] = None\n"
        "import importlib\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "import numpy as np\n"
        "from cmdgen_tpu_torch.chem import mol, mol_build, rmsd\n"
        "real = mol._perfect_matching\n"
        "mol._perfect_matching = lambda need, adj, budget=0: real(need, adj, 0)\n"
        "assert mol.canonical_smiles('c1cc2ccc3cccc4ccc(c1)c2c34') is not None\n"
        "assert mol.canonical_smiles('c1ccc1') is None\n"
        "m = mol.mol_from_smiles('Cc1ccc(C)cc1')\n"
        "x = np.random.RandomState(0).randn(m.n_atoms, 3)\n"
        "assert rmsd.isomorphic_rmsd(m, x, m, x[::-1].copy()) is not None\n"
        "assert len(mol_build._fragments(m)) == 1\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr[-3000:]


def test_entry_points_without_device_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_port_checkpoint(PKG / "assets" / "qrun_aa")
    # the parallel runs: before any process, group or data is touched
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        check.steps({}, {}, [], [])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        check.train({}, "no-data", "no-out")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch.spawn(check.run_jobs, 2, [], init_method="file:///nonexistent/store")
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_fails_without_cuda():
    """chip_smoke.py exits non-zero and prints no result line without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


# public names of the JAX package with no counterpart of the same name in
# the same module of the port, each for its reason (ROADMAP C)
NOT_PORTED = {
    # flax module set-up and initialisation (the port's modules build in
    # __init__, models/init.py draws flax's initial weights)
    "models/gcpg.py": {"GCPG.setup"},
    "models/transformer.py": {"DecoderLayer.setup", "EncoderLayer.setup", "MHA.setup",
                              "TransformerDecoder.setup"},
    "diffusion/cddpm.py": {"ConditionalDDPM.init_extra_params",
                           # a method of the port's ConditionalDDPM
                           "sample_chain_given_pocket"},
    "train/diffphar_train.py": {"init_params"},
    # TPU dispatch: one-hot gathers, the Pallas engine's flax-tree apply,
    # resident multi-step plans and jax.sharding layouts
    "models/egnn.py": {"gather_nodes"},
    "models/dynamics.py": {"make_pallas_apply"},
    "data/dataset.py": {"DiffPharDataset.nbytes", "DiffPharDataset.stacked_arrays"},
    "train/state.py": {"make_diffusion_multistep", "make_diffusion_multistep_resident"},
    "train/gcpg_train.py": {"make_gcpg_multistep_resident"},
    "parallel/mesh.py": {"batch_sharding", "fsdp_sharding", "replicate", "replicated",
                         "shard_batch", "shard_params_fsdp", "shard_params_tp", "tp_sharding"},
    # a host clock without a synchronise times the enqueue on the card;
    # the port's spans (recorded while a profiler records) take its place
    "utils/profiling.py": {"StepTimer", "StepTimer.phase", "StepTimer.start", "StepTimer.stop",
                           "StepTimer.summary"},
}


def _public_names(path, port):
    """Top-level functions and classes and their methods not starting
    with ``_``; for the port also names assigned at top level or in a
    class body (``normalize = ConditionalDDPM.normalize``)."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        if isinstance(node, ast.ClassDef):
            for m in node.body:
                if isinstance(m, ast.FunctionDef):
                    out.add(f"{node.name}.{m.name}")
                elif port and isinstance(m, ast.Assign):
                    out.update(f"{node.name}.{t.id}" for t in m.targets
                               if isinstance(t, ast.Name))
        elif port and isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return {n for n in out if not n.split(".")[-1].startswith("_")}


def test_every_public_name_has_a_counterpart():
    """Each public function, class and method of a JAX package module has
    one of the same name in the port's module of the same path, but for
    NOT_PORTED; and each NOT_PORTED name is still missing (a port of one
    takes it off the list)."""
    jax_pkg = REPO / "cmdgen_tpu"
    missing = {}
    for f in sorted(jax_pkg.rglob("*.py")):
        rel = f.relative_to(jax_pkg)
        port = PKG / rel
        gap = _public_names(f, False) - (_public_names(port, True) if port.exists() else set())
        if gap:
            missing[rel.as_posix()] = gap
    assert missing == NOT_PORTED
