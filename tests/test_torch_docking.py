"""The port's docking preparation (``chem/gasteiger.py``,
``pipeline/docking.py``) against the JAX package's: Gasteiger charges over
the SMILES of ``tests/test_docking_prep.py`` (atol 1e-12), the ligand and
receptor PDBQT text (identical), rotatable bonds, and the smina and qvina
wrappers against stub binaries, as ``tests/test_docking.py`` runs them."""
import os
import stat
from pathlib import Path

import numpy as np
import pytest

from cmdgen_tpu.chem.gasteiger import gasteiger_charges as jgasteiger_charges
from cmdgen_tpu.chem.gasteiger import heavy_charges_ad4 as jheavy_charges_ad4
from cmdgen_tpu.chem.mol import mol_from_smiles as jmol_from_smiles
from cmdgen_tpu.pipeline import docking as jdocking
from cmdgen_tpu_torch.chem.gasteiger import gasteiger_charges, heavy_charges_ad4
from cmdgen_tpu_torch.chem.mol import mol_from_smiles
from cmdgen_tpu_torch.pipeline import docking
from test_docking_prep import _dipeptide_pdb

SMILES = ["C", "CO", "c1ccccc1", "C[N+](C)(C)C", "CCCC", "CCO", "c1ccccc1c1ccccc1",
          "CC(=O)NC", "C1CCCCC1", "CC(C)Cc1ccc(cc1)C(C)C(=O)O", "c1ccccc1O"]


@pytest.mark.parametrize("smiles", SMILES)
def test_gasteiger_charges_match_jax(smiles):
    """Heavy-atom charges and each atom's hydrogen charges, raw and AD4-merged."""
    mol, jmol = mol_from_smiles(smiles), jmol_from_smiles(smiles)
    for fn, jfn in ((gasteiger_charges, jgasteiger_charges),
                    (heavy_charges_ad4, jheavy_charges_ad4)):
        (heavy, hs), (jheavy, jhs) = fn(mol), jfn(jmol)
        np.testing.assert_allclose(heavy, jheavy, atol=1e-12, rtol=0)
        assert [len(h) for h in hs] == [len(h) for h in jhs]
        for h, jh in zip(hs, jhs):
            np.testing.assert_allclose(h, jh, atol=1e-12, rtol=0)
    assert docking.rotatable_bonds(mol) == jdocking.rotatable_bonds(jmol)


@pytest.mark.parametrize("smiles", ["CCO", "c1ccccc1O", "CC(C)Cc1ccc(cc1)C(C)C(=O)O",
                                    "C[N+](C)(C)C"])
@pytest.mark.parametrize("flexible", [True, False], ids=["flexible", "rigid"])
def test_write_pdbqt_text_matches_jax(tmp_path, smiles, flexible):
    mol, jmol = mol_from_smiles(smiles), jmol_from_smiles(smiles)
    coords = np.random.RandomState(0).randn(mol.n_atoms, 3) * 3.0
    docking.write_pdbqt(tmp_path / "port.pdbqt", mol, coords, flexible=flexible)
    jdocking.write_pdbqt(tmp_path / "jax.pdbqt", jmol, coords, flexible=flexible)
    assert (tmp_path / "port.pdbqt").read_text() == (tmp_path / "jax.pdbqt").read_text()


def test_prepare_receptor_pdbqt_text_matches_jax(tmp_path):
    docking.prepare_receptor_pdbqt(_dipeptide_pdb(), tmp_path / "port.pdbqt")
    jdocking.prepare_receptor_pdbqt(_dipeptide_pdb(), tmp_path / "jax.pdbqt")
    text = (tmp_path / "port.pdbqt").read_text()
    assert text == (tmp_path / "jax.pdbqt").read_text() and len(text.splitlines()) == 17


def _make_stub(path: Path, body: str) -> str:
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


@pytest.fixture
def ligand(tmp_path):
    mol = mol_from_smiles("CCO")
    coords = np.random.RandomState(0).randn(mol.n_atoms, 3) * 2.0 + 10.0
    lig = tmp_path / "lig.pdbqt"
    docking.write_pdbqt(lig, mol, coords)
    rec = tmp_path / "rec.pdbqt"
    rec.write_text("ATOM      1 C    REC A   1       0.000   0.000   0.000\n")
    return mol, coords, lig, rec


def test_smina_score_only_with_stub(tmp_path, ligand):
    _, _, lig, rec = ligand
    stub = _make_stub(tmp_path / "smina", 'echo "args: $@" > "%s"\n'
                      'echo "Affinity: -7.31 (kcal/mol)"\n' % (tmp_path / "argv.txt"))
    assert docking.smina_score_only(rec, lig, binary=stub) == pytest.approx(-7.31)
    argv = (tmp_path / "argv.txt").read_text()
    assert "--score_only" in argv and str(lig) in argv and str(rec) in argv


def test_qvina_dock_with_stub(tmp_path, ligand):
    _, _, lig, rec = ligand
    stub = _make_stub(
        tmp_path / "qvina2",
        'echo "args: $@" > "%s"\n'
        "cat <<'EOF'\n"
        "mode |   affinity | dist from best mode\n"
        "-----+------------+----------+----------\n"
        "   1       -8.1      0.000      0.000\n"
        "   2       -7.5      1.233      2.310\n"
        "EOF\n" % (tmp_path / "argv.txt"))
    scores = docking.qvina_dock(rec, lig, center=(1.0, 2.0, 3.0),
                                out_path=tmp_path / "out.pdbqt", binary=stub)
    assert scores == [pytest.approx(-8.1), pytest.approx(-7.5)]
    argv = (tmp_path / "argv.txt").read_text()
    assert "--center_x 1.0" in argv and "--center_z 3.0" in argv and "--size_x 20.0" in argv


def test_calculate_qvina2_score_finds_the_binary_on_path(tmp_path, ligand, monkeypatch):
    mol, coords, _, rec = ligand
    bindir = tmp_path / "bin"
    bindir.mkdir()
    _make_stub(bindir / "qvina2.1", 'echo "args: $@" > "%s"\n'
               'echo "   1       -9.4      0.000      0.000"\n' % (tmp_path / "argv.txt"))
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    assert docking.docking_available() and jdocking.docking_available()
    assert docking.calculate_qvina2_score(rec, mol, coords, tmp_path / "wd") == \
        pytest.approx(-9.4)
    assert f"--center_x {coords.mean(axis=0)[0]}" in (tmp_path / "argv.txt").read_text()
    assert (tmp_path / "wd" / "ligand.pdbqt").exists()


def test_docking_unavailable_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    assert not docking.docking_available() and not jdocking.docking_available()
    with pytest.raises(RuntimeError):
        docking.smina_score_only("r", "l")
    with pytest.raises(RuntimeError):
        docking.qvina_dock("r", "l", (0.0, 0.0, 0.0), "o")
