"""The port's ``sample-phars`` CLI on the committed trained weights, on the
CPU, at a small T: writes the ``{Molecule_i: {family: [[x, y, z], ...]}}``
schema the consensus stage reads."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from cmdgen_tpu_torch.chem.constants import PHAR_DECODER
from cmdgen_tpu_torch.utils.synthetic import synthetic_pocket_pdb

REPO = Path(__file__).resolve().parent.parent
CKPT = REPO / "cmdgen_tpu_torch" / "assets" / "qrun_aa"


@pytest.mark.parametrize("engine", ["msgpass", "fused"])
def test_cli_sample_phars_cpu(tmp_path, engine):
    pdb = tmp_path / "pocket.pdb"
    pdb.write_text(synthetic_pocket_pdb(np.random.RandomState(0)))
    out = tmp_path / "phars.json"
    cmd = [sys.executable, "-m", "cmdgen_tpu_torch.cli", "sample-phars", str(CKPT),
           str(pdb), str(out), "--ref-ligand", "L:1", "--n-samples", "3",
           "--timesteps", "4", "--clamp-x", "8", "--device", "cpu", "--engine", engine]
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-3000:]
    mols = json.loads(out.read_text())
    assert list(mols) == ["Molecule_0", "Molecule_1", "Molecule_2"]
    for mol in mols.values():
        assert set(mol) <= set(PHAR_DECODER)
        pts = [p for fam in mol.values() for p in fam]
        assert len(pts) == 5  # no size prior: 5 nodes per cloud
        assert all(len(p) == 3 and all(np.isfinite(p)) for p in pts)

