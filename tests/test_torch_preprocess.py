"""The port's CrossDocked preprocessing (``data/crossdocked.py``, ``cli
preprocess``) against the JAX package's on the tiny (pocket PDB, ligand
SDF) pairs of ``tests/test_data_training.py``, one of them broken: every
npz array, ``size_distribution.npy``, the type histograms and the counts
must be equal; the port's trainer must read the output."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from cmdgen_tpu import cli as jcli
from cmdgen_tpu.data import crossdocked as jcrossdocked
from cmdgen_tpu_torch import cli
from cmdgen_tpu_torch import config as cfgmod
from cmdgen_tpu_torch.data import crossdocked

torch.set_num_threads(1)

ETHANOL_SDF = """ethanol
  test

  3  2  0  0  0  0  0  0  0  0999 V2000
    0.0000    0.0000    0.0000 C   0  0  0  0  0  0  0  0  0  0  0  0
    1.5000    0.0000    0.0000 C   0  0  0  0  0  0  0  0  0  0  0  0
    2.1000    1.3000    0.0000 O   0  0  0  0  0  0  0  0  0  0  0  0
  1  2  1  0  0  0  0
  2  3  1  0  0  0  0
M  END
"""


def _pdb_line(serial, name, res, chain, resid, x, y, z, element):
    return (
        f"ATOM  {serial:>5} {name:<4} {res:<3} {chain}{resid:>4}    "
        f"{x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}{0.0:6.2f}          {element:>2}"
    )


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """Six complexes of a 4-residue pocket around ethanol (five train, one
    test) and one whose ligand file is empty."""
    tmp = tmp_path_factory.mktemp("cd")
    rng = np.random.RandomState(0)
    out = []
    for n in range(6):
        lines, serial = [], 1
        for ri, res in enumerate(["ALA", "SER", "GLY", "LYS"], start=1):
            base = rng.randn(3) * 2.0
            for name, el in [("N", "N"), ("CA", "C"), ("C", "C"), ("O", "O")]:
                x, y, z = base + rng.randn(3) * 0.4
                lines.append(_pdb_line(serial, name, res, "A", ri, x, y, z, el))
                serial += 1
        pdb = tmp / f"pocket_{n}.pdb"
        pdb.write_text("\n".join(lines))
        sdf = tmp / f"lig_{n}.sdf"
        sdf.write_text(ETHANOL_SDF)
        out.append(("test" if n >= 5 else "train", str(pdb), str(sdf)))
    (tmp / "empty.sdf").write_text("")
    out.append(("train", str(tmp / "pocket_0.pdb"), str(tmp / "empty.sdf")))
    tsv = tmp / "pairs.tsv"
    tsv.write_text("\n".join("\t".join(p) for p in out))
    return out, tsv


def _same_output(got, want):
    files = sorted(p.name for p in want.iterdir())
    assert sorted(p.name for p in got.iterdir()) == files
    assert {"train.npz", "val.npz", "test.npz", "size_distribution.npy",
            "type_histograms.json"} <= set(files)
    for f in files:
        if f.endswith(".npz"):
            with np.load(got / f) as g, np.load(want / f) as w:
                assert sorted(g.files) == sorted(w.files)
                for k in w.files:
                    assert g[k].dtype == w[k].dtype, (f, k)
                    np.testing.assert_array_equal(g[k], w[k], err_msg=f"{f} {k}")
        elif f.endswith(".npy"):
            np.testing.assert_array_equal(np.load(got / f), np.load(want / f))
        else:
            assert (got / f).read_text() == (want / f).read_text()


@pytest.mark.parametrize("representation", ["full-atom", "CA"])
def test_process_dataset_matches_jax(pairs, tmp_path, representation):
    ps, _ = pairs
    got = crossdocked.process_dataset(ps, tmp_path / "port", representation=representation,
                                      val_fraction_from_train=2)
    want = jcrossdocked.process_dataset(ps, tmp_path / "jax", representation=representation,
                                        val_fraction_from_train=2)
    assert got == want and got["n_failed"] == 1
    _same_output(tmp_path / "port", tmp_path / "jax")


def test_cli_preprocess_matches_jax_and_trains(pairs, tmp_path, capsys):
    _, tsv = pairs
    stats = cli.main(["preprocess", str(tsv), str(tmp_path / "port")])
    assert json.loads(capsys.readouterr().out) == stats
    jcli.main(["preprocess", str(tsv), str(tmp_path / "jax")])
    _same_output(tmp_path / "port", tmp_path / "jax")
    # the port's trainer reads what preprocess wrote
    from cmdgen_tpu_torch.train.diffphar_train import train_diffphar

    cfg = cfgmod.full_atom_config()
    cfg = dataclasses.replace(
        cfg, dynamics=dataclasses.replace(cfg.dynamics, egnn=dataclasses.replace(
            cfg.dynamics.egnn, hidden_nf=16, n_layers=1)),
        ddpm=dataclasses.replace(cfg.ddpm, timesteps=5),
        train=dataclasses.replace(cfg.train, batch_size=2, n_epochs=1, eval_epochs=1,
                                  n_eval_samples=2))
    st = train_diffphar(cfg, tmp_path / "port", tmp_path / "ck", device="cpu")
    assert st.step == 2  # 5 train complexes (val is drawn from them), batches of 2
    assert (tmp_path / "ck" / "last" / "params.npz").exists()
