"""The port's CLI on the CPU: ``sample-phars`` on the committed trained
weights at a small T (the ``{Molecule_i: {family: [[x, y, z], ...]}}``
schema the consensus stage reads, and ``--chain-gif``), ``get-phar``
in every method and mode on synthetic clouds of four known sites,
``generate`` on the committed trained GCPG (``assets/grun_r5cn``),
``align`` with ``--tolerance 1``, and ``run-all`` on both committed
checkpoints at T=4."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cmdgen_tpu_torch import cli
from cmdgen_tpu_torch.chem.constants import PHAR_DECODER
from cmdgen_tpu_torch.chem.posp import PHAR2IDX
from cmdgen_tpu_torch.utils.synthetic import synthetic_pocket_pdb

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CKPT = REPO / "cmdgen_tpu_torch" / "assets" / "qrun_aa"
GRUN = REPO / "cmdgen_tpu_torch" / "assets" / "grun_r5cn"


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



def test_cli_sample_phars_chain_gif_cpu(tmp_path):
    pdb = tmp_path / "pocket.pdb"
    pdb.write_text(synthetic_pocket_pdb(np.random.RandomState(0)))
    out, gif = tmp_path / "phars.json", tmp_path / "chain.gif"
    cli.main(["sample-phars", str(CKPT), str(pdb), str(out), "--ref-ligand", "L:1",
              "--n-samples", "2", "--timesteps", "3", "--clamp-x", "8", "--device", "cpu",
              "--chain-gif", str(gif)])
    assert len(json.loads(out.read_text())) == 2
    assert gif.read_bytes()[:6] in (b"GIF87a", b"GIF89a") and gif.stat().st_size > 1000


SITES = np.array([[0, 0, 0], [6, 0, 0], [0, 6, 0], [3, 3, 5]])
FAMS = ["Aromatic", "Acceptor", "Donor", "Hydrophobe"]


def _cloud_json(path, points, n_mol=30):
    """A sampling-stage JSON: molecule i holds one point of every site."""
    data = {f"Molecule_{i}": {fam: [points[s * n_mol + i].tolist()]
                              for s, fam in enumerate(FAMS)} for i in range(n_mol)}
    path.write_text(json.dumps(data))


def _read_posp(path):
    lines = [ln.split() for ln in path.read_text().strip().splitlines()]
    return [ln[0] for ln in lines], np.array([[float(v) for v in ln[1:]] for ln in lines])


@pytest.fixture
def clouds(tmp_path):
    """Target 1, target 2 (target 1 moved by a known rigid motion) and an
    anti-target that covers only the first two sites."""
    rng = np.random.RandomState(0)
    pts = np.concatenate([s + rng.randn(30, 3) * 0.3 for s in SITES]) + 20.0
    q, r = np.linalg.qr(rng.randn(3, 3))
    rot = q @ np.diag(np.sign(np.diag(r)))
    rot[:, 0] *= np.sign(np.linalg.det(rot))
    paths = {name: tmp_path / f"{name}.json" for name in ("t1", "t2", "anti")}
    _cloud_json(paths["t1"], pts)
    _cloud_json(paths["t2"], pts @ rot.T + np.array([4.0, -2.0, 1.0]))
    anti = pts.copy()
    anti[60:] += 50.0  # sites 3 and 4 far away
    _cloud_json(paths["anti"], anti)
    return paths


@pytest.mark.parametrize("args,n_points", [
    (["--method", "gmm", "--n-clusters", "4"], 4),
    (["--method", "kmeans", "--n-clusters", "4"], 4),
    (["--method", "dbscan", "--eps", "1.0", "--min-samples", "8"], 4),
])
def test_cli_get_phar_methods_cpu(tmp_path, clouds, args, n_points):
    out = tmp_path / "hyp.posp"
    cli.main(["get-phar", str(clouds["t1"]), str(out), "--device", "cpu", *args])
    types, centers = _read_posp(out)
    assert sorted(types) == ["AROM", "HACC", "HDON", "HYBL"] and len(types) == n_points
    d = np.sqrt(((centers[:, None] - (SITES[None] + 20.0)) ** 2).sum(-1)).min(1)
    assert d.max() < 0.3


@pytest.mark.parametrize("mode,suffixes", [("gmm", [".dual1.posp", ".dual2.posp"]),
                                           ("dbscan", [".dual1.posp", ".dual2.posp"]),
                                           ("indiv", [".dual_indiv.posp"])])
def test_cli_get_phar_dual_target_cpu(tmp_path, clouds, mode, suffixes):
    out = tmp_path / "hyp.posp"
    cli.main(["get-phar", str(clouds["t1"]), str(out), "--dual-json", str(clouds["t2"]),
              "--dual-mode", mode, "--n-clusters", "4", "--device", "cpu"])
    for suffix in suffixes:
        types, centers = _read_posp(out.with_suffix(suffix))
        assert set(types) <= set(PHAR2IDX) and len(types) >= 4
        assert np.isfinite(centers).all()
    if mode != "indiv":  # frame 1 holds the sites where target 1 has them
        _, centers = _read_posp(out.with_suffix(".dual1.posp"))
        d = np.sqrt(((centers[:, None] - (SITES[None] + 20.0)) ** 2).sum(-1)).min(1)
        assert d.max() < 0.5


def test_cli_get_phar_selectivity_cpu(tmp_path, clouds):
    out = tmp_path / "sel.posp"
    cli.main(["get-phar", str(clouds["t1"]), str(out), "--select-json", str(clouds["anti"]),
              "--eps", "1.0", "--min-samples", "8", "--device", "cpu"])
    types, _ = _read_posp(out)
    assert sorted(types) == ["HDON", "HYBL"]  # the sites the anti-target lacks


def test_cli_get_phar_defaults_to_cuda(tmp_path, clouds):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["get-phar", str(clouds["t1"]), str(tmp_path / "x.posp")])


POSP = "AROM 1.00 0.50 -0.20\nHACC 4.10 1.20 0.30\nHDON -2.00 3.10 1.00\nHYBL 0.50 -3.60 2.20\n"


@pytest.mark.parametrize("args", [["--constrain-decode", "--constrain-valence"], []],
                         ids=["valence", "free"])
def test_cli_generate_cpu(tmp_path, args):
    """One SMILES per line, each valid, canonical and unique."""
    from cmdgen_tpu_torch.chem.mol import canonical_smiles

    posp = tmp_path / "hyp.posp"
    posp.write_text(POSP)
    out = cli.main(["generate", str(posp), str(tmp_path / "out"), str(GRUN), "--n", "6",
                    "--seed", "1", "--device", "cpu", *args])
    assert out == tmp_path / "out" / "hyp_result.txt"
    lines = out.read_text().splitlines()
    assert len(lines) == len(set(lines)) >= 1
    assert all(canonical_smiles(s) == s for s in lines)


def test_cli_generate_no_filter_writes_n_lines(tmp_path):
    posp = tmp_path / "hyp.posp"
    posp.write_text(POSP)
    out = cli.main(["generate", str(posp), str(tmp_path), str(GRUN), "--n", "5",
                    "--no-filter", "--temperature", "0.8", "--device", "cpu"])
    lines = out.read_text().split("\n")
    assert len(lines) == 6 and lines[-1] == ""  # 5 lines, newline-terminated


def test_cli_generate_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    posp = tmp_path / "hyp.posp"
    posp.write_text(POSP)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["generate", str(posp), str(tmp_path), str(GRUN)])


ALIGN_POSP = "AROM 0.0 0.0 0.0\nHACC 4.5 0.0 0.0\nHDON 1.0 4.0 0.5\n"


def test_cli_align_cpu(tmp_path):
    """Posed SDFs (num_keep conformers each) and rmsd_values.npy; a
    molecule that matches no subset, and an invalid line, write nothing."""
    from cmdgen_tpu_torch.chem.sdf import read_sdf

    posp, smi = tmp_path / "hyp.posp", tmp_path / "smiles.txt"
    posp.write_text(ALIGN_POSP)
    smi.write_text("Oc1ccc(cc1)CCNC(=O)c1ccccc1O\nCOc1ccccc1\nnot_a_smiles\nCCCC\n")
    best = cli.main(["align", str(smi), str(posp), str(tmp_path / "out"), "--n-conformers",
                     "3", "--num-keep", "2", "--tolerance", "1", "--device", "cpu"])
    assert set(best) == {"Oc1ccc(cc1)CCNC(=O)c1ccccc1O", "COc1ccccc1"}
    assert np.load(tmp_path / "out" / "rmsd_values.npy").shape == (2,)
    for i in (0, 1):
        back = read_sdf(tmp_path / "out" / f"mol_{i}.sdf")
        assert len(back) == 2 and all(np.isfinite(x).all() for _, x in back)


def test_cli_run_all_cpu(tmp_path):
    """run-all on the committed qrun_aa and grun_r5cn weights at T=4: the
    stats JSON's counters and results.json's SDFs."""
    from cmdgen_tpu_torch.chem.sdf import read_sdf

    pdbs = []
    for i in range(2):
        pdbs.append(tmp_path / f"pocket_{i}.pdb")
        pdbs[-1].write_text(synthetic_pocket_pdb(np.random.RandomState(i)))
    out = tmp_path / "out"
    results, stats = cli.main([
        "run-all", str(CKPT), str(GRUN), str(out), *map(str, pdbs), "--ref-ligand", "L:1",
        "--n-clouds", "8", "--timesteps", "4", "--clamp-x", "8", "--neighbor-k", "16",
        "--cluster-counts", "4", "--smiles-per-hypothesis", "16", "--n-conformers", "2",
        "--constrain-decode", "--constrain-valence", "--decode-temperature", "0.7",
        "--contact-filter", "0", "--device", "cpu"])
    assert stats["pockets"] == 2 and stats["hypotheses"] == 2
    assert stats["raw_smiles"] == 32 >= stats["valid_smiles"] >= stats["unique_smiles"]
    assert stats["unique_smiles"] >= stats["matched"] >= stats["aligned"] == len(results)
    index = json.loads((out / "results.json").read_text())
    assert len(index) == len(results)
    for entry in index:
        assert np.isfinite(entry["rmsd"])
        back = read_sdf(out / entry["file"])
        assert 1 <= len(back) <= 3 and all(np.isfinite(x).all() for _, x in back)


def test_cli_align_and_run_all_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    posp, smi = tmp_path / "hyp.posp", tmp_path / "smiles.txt"
    posp.write_text(ALIGN_POSP)
    smi.write_text("COc1ccccc1\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["align", str(smi), str(posp), str(tmp_path / "out")])
    pdb = tmp_path / "pocket.pdb"
    pdb.write_text(synthetic_pocket_pdb(np.random.RandomState(0)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["run-all", str(CKPT), str(GRUN), str(tmp_path / "ra"), str(pdb),
                  "--ref-ligand", "L:1"])


# ------------------------------------------------ joint model and evaluation

def _joint_checkpoint(path):
    """A small joint port checkpoint (ca_config's families, hidden 32, 2
    layers, K=10, T=10) with seeded random weights, written by
    ``write_port_checkpoint``; read back, it is the same model."""
    import dataclasses

    from cmdgen_tpu_torch.config import ca_config
    from cmdgen_tpu_torch.convert import (build_model, load_port_checkpoint, model_leaves,
                                          write_port_checkpoint)
    from cmdgen_tpu_torch.diffusion.joint import JointDDPM
    from cmdgen_tpu_torch.models.dynamics import EGNNDynamics

    cfg = ca_config()
    egnn = dataclasses.replace(cfg.dynamics.egnn, hidden_nf=32, n_layers=2, neighbor_k=10)
    cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, mode="joint"),
        ddpm=dataclasses.replace(cfg.ddpm, timesteps=10),
        dynamics=dataclasses.replace(cfg.dynamics, update_pocket_coords=True, egnn=egnn))
    torch.manual_seed(0)
    model = build_model(cfg, model_leaves(EGNNDynamics(cfg.dynamics)), "cpu")
    write_port_checkpoint(path, cfg, model)
    back, cfg_back = load_port_checkpoint(path, "cpu")
    assert isinstance(back, JointDDPM) and cfg_back == cfg
    for (k, a), b in zip(model.dynamics.state_dict().items(), back.dynamics.state_dict().values()):
        assert torch.equal(a, b), k
    return path


@pytest.mark.parametrize("engine", ["msgpass", "fused"])
def test_cli_sample_phars_joint_checkpoint_cpu(tmp_path, engine):
    """sample-phars on a joint checkpoint: RePaint inpainting with the
    pocket fixed; clouds in the pocket's frame, as the conditional path
    writes them."""
    ckpt = _joint_checkpoint(tmp_path / "joint")
    pdb = tmp_path / "pocket.pdb"
    pdb.write_text(synthetic_pocket_pdb(np.random.RandomState(0)))
    out = tmp_path / "phars.json"
    cli.main(["sample-phars", str(ckpt), str(pdb), str(out), "--ref-ligand", "L:1",
              "--n-samples", "3", "--timesteps", "4", "--device", "cpu", "--engine", engine])
    mols = json.loads(out.read_text())
    assert list(mols) == ["Molecule_0", "Molecule_1", "Molecule_2"]
    for mol in mols.values():
        assert set(mol) <= set(PHAR_DECODER)
        pts = np.array([p for fam in mol.values() for p in fam])
        assert pts.shape == (5, 3) and np.isfinite(pts).all()
    with pytest.raises(ValueError, match="joint checkpoint"):
        cli.main(["sample-phars", str(ckpt), str(pdb), str(out), "--ref-ligand", "L:1",
                  "--device", "cpu", "--chain-gif", str(tmp_path / "c.gif")])


def test_cli_eval_diffphar_cpu(tmp_path):
    """eval-diffphar on the trained qrun_aa (T=100) and a synthetic test
    set in DiffPharDataset's format: finite metrics, 4 samples a pocket."""
    from cmdgen_tpu_torch.utils.synthetic import synthetic_diffphar_npz

    npz = tmp_path / "test.npz"
    synthetic_diffphar_npz(npz, np.random.RandomState(0), n_complexes=3, n_pocket=(20, 30))
    out = cli.main(["eval-diffphar", str(CKPT), str(npz), "--n-pockets", "2", "--device", "cpu",
                    "--engine", "fused"])
    assert set(out) == {"com_dist_mean", "spread_gen_mean", "spread_ref_mean", "kl_types",
                        "n_sampled"}
    assert all(np.isfinite(v) for v in out.values()) and out["spread_gen_mean"] > 0
    with np.load(npz) as f:
        sizes = np.bincount(f["phar_mask"])
    assert out["n_sampled"] == 4 * sizes[:2].sum()


def test_cli_eval_gcpg_cpu(tmp_path):
    """eval-gcpg on the trained grun_r5cn: the metric chain over n decodes."""
    smi = tmp_path / "test.smi"
    smi.write_text("CC(=O)Oc1ccccc1C(=O)O\nOc1ccc(cc1)CCNC(=O)c1ccccc1O\nCOc1ccccc1\n"
                   "not a smiles\nCC(C)Cc1ccc(cc1)C(C)C(=O)O\n")
    out = cli.main(["eval-gcpg", str(GRUN), str(smi), "--n", "3", "--device", "cpu"])
    assert out["n_eval"] == 3
    assert 0.0 <= out["validity"] <= 1.0 and -1.0 <= out["match_score"] <= 1.0
    assert out["match_timeout_rate"] == 0.0


def test_cli_align_pose_pdbs_cpu(tmp_path):
    """align --pose-pdbs on a directory of pose PDBs: the RMSD summary and
    rmsd_values.npy; a pose that matches no subset counts as failed."""
    from cmdgen_tpu_torch.chem.mol import mol_from_smiles
    from cmdgen_tpu_torch.ops.dgeom import embed_conformers
    from cmdgen_tpu_torch.utils.synthetic import ligand_pdb

    posp, poses = tmp_path / "hyp.posp", tmp_path / "poses"
    posp.write_text(ALIGN_POSP)
    poses.mkdir()
    for i, s in enumerate(["Oc1ccc(cc1)CCNC(=O)c1ccccc1O", "CCCC"]):
        mol = mol_from_smiles(s)
        conf = embed_conformers(mol, 1, refine_steps=200, device="cpu",
                                generator=torch.Generator().manual_seed(i))[0].numpy()
        (poses / f"pose_{i}.pdb").write_text(ligand_pdb([a.symbol for a in mol.atoms], conf))
    out = cli.main(["align", str(poses), str(posp), str(tmp_path / "out"), "--pose-pdbs",
                    "--n-conformers", "3", "--tolerance", "1", "--device", "cpu"])
    assert (out["n_aligned"], out["n_failed"]) == (1, 1)
    assert np.isfinite(out["rmsd_mean"]) and out["rmsd_mean"] > 0
    np.testing.assert_allclose(np.load(tmp_path / "out" / "rmsd_values.npy"),
                               [out["rmsd_mean"]], rtol=1e-6)
    one = cli.main(["align", str(poses / "pose_0.pdb"), str(posp), str(tmp_path / "one"),
                    "--pose-pdbs", "--ref-ligand", "L:1", "--n-conformers", "3",
                    "--tolerance", "1", "--device", "cpu"])
    assert (one["n_aligned"], one["n_failed"]) == (1, 0)


def test_cli_evaluation_and_joint_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from cmdgen_tpu_torch.utils.synthetic import synthetic_diffphar_npz

    npz, smi, posp = tmp_path / "test.npz", tmp_path / "t.smi", tmp_path / "hyp.posp"
    synthetic_diffphar_npz(npz, np.random.RandomState(0), n_complexes=2)
    smi.write_text("COc1ccccc1\n")
    posp.write_text(ALIGN_POSP)
    pdb = tmp_path / "pocket.pdb"
    pdb.write_text(synthetic_pocket_pdb(np.random.RandomState(0)))
    ckpt = _joint_checkpoint(tmp_path / "joint")
    for argv in (["eval-diffphar", str(CKPT), str(npz)],
                 ["eval-gcpg", str(GRUN), str(smi)],
                 ["align", str(tmp_path), str(posp), str(tmp_path / "out"), "--pose-pdbs"],
                 ["sample-phars", str(ckpt), str(pdb), str(tmp_path / "o.json"),
                  "--ref-ligand", "L:1"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(argv)


def test_cli_train_diffphar_cpu(tmp_path):
    """train-diffphar at ca_config's width on a tiny synthetic set: one
    epoch of two steps, best/ and last/ written with the config and the
    optimizer state, and its metrics log."""
    from cmdgen_tpu_torch.utils.synthetic import synthetic_diffphar_npz

    data = tmp_path / "data"
    data.mkdir()
    synthetic_diffphar_npz(data / "train.npz", np.random.RandomState(0), 4, n_pocket=(10, 20))
    synthetic_diffphar_npz(data / "val.npz", np.random.RandomState(1), 2, n_pocket=(10, 20))
    out = tmp_path / "run"
    state = cli.main(["train-diffphar", str(data), str(out), "--config", "ca",
                      "--batch-size", "2", "--epochs", "1", "--neighbor-k", "12",
                      "--seed", "3", "--device", "cpu"])
    assert state.step == 2
    cfg = json.loads((out / "best" / "config.json").read_text())
    assert cfg["dynamics"]["egnn"]["neighbor_k"] == 12 and cfg["train"]["seed"] == 3
    assert cfg["dynamics"]["egnn"]["hidden_nf"] == 256
    with np.load(out / "last" / "opt_state.npz") as npz:
        assert int(npz["count"]) == 2
    lines = (out / "crossdocked_ca_cond.metrics.jsonl").read_text().strip().split("\n")
    assert np.isfinite(json.loads(lines[-1])["loss/val"])


def test_cli_train_diffphar_fsdp_cpu(tmp_path):
    """train-diffphar --fsdp outside torchrun: a world of one (gloo) that
    the command makes and takes down again; its checkpoint holds the
    plain run's arrays (weights atol 1e-5, tests/test_torch_parallel.py's
    tolerance) and records the layout in its config."""
    import torch.distributed as dist

    from cmdgen_tpu_torch.utils.synthetic import synthetic_diffphar_npz

    data = tmp_path / "data"
    data.mkdir()
    synthetic_diffphar_npz(data / "train.npz", np.random.RandomState(0), 4, n_pocket=(10, 20))
    synthetic_diffphar_npz(data / "val.npz", np.random.RandomState(1), 2, n_pocket=(10, 20))
    argv = ["--config", "ca", "--batch-size", "2", "--epochs", "1", "--neighbor-k", "12",
            "--device", "cpu"]
    cli.main(["train-diffphar", str(data), str(tmp_path / "plain"), *argv])
    state = cli.main(["train-diffphar", str(data), str(tmp_path / "fsdp"), *argv, "--fsdp"])
    assert state.step == 2 and not dist.is_initialized()
    assert json.loads((tmp_path / "fsdp" / "best" / "config.json").read_text())["train"]["fsdp"]
    for f in ("params", "opt_state"):
        with np.load(tmp_path / "fsdp" / "last" / f"{f}.npz") as got, \
                np.load(tmp_path / "plain" / "last" / f"{f}.npz") as want:
            assert sorted(got.files) == sorted(want.files)
            for k in want.files:
                np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0, err_msg=k)


def test_cli_train_gcpg_cpu(tmp_path):
    """train-gcpg at the default width, one step, then generate from the
    run's directory (its best/)."""
    smiles = tmp_path / "smiles.txt"
    smiles.write_text("\n".join(["CCO", "CC(=O)O", "c1ccccc1", "CC(C)CO", "CCN", "CCOC"]))
    out = tmp_path / "run"
    model, tok = cli.main(["train-gcpg", str(smiles), str(out), "--batch-size", "4",
                           "--max-steps", "1", "--epochs", "1", "--device", "cpu"])
    assert model.cfg.hidden_dim == 384 and not model.training
    meta = json.loads((out / "best.json").read_text())
    assert meta["step"] == 1 and meta["config"]["tokenizer"] == tok.to_list()
    posp = tmp_path / "hyp.posp"
    posp.write_text(ALIGN_POSP)
    cli.main(["generate", str(posp), str(tmp_path / "gen"), str(out), "--n", "2",
              "--no-filter", "--device", "cpu"])
    assert len((tmp_path / "gen" / "hyp_result.txt").read_text().strip().split("\n")) == 2


def test_cli_training_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from cmdgen_tpu_torch.utils.synthetic import synthetic_diffphar_npz

    synthetic_diffphar_npz(tmp_path / "train.npz", np.random.RandomState(0), 2)
    synthetic_diffphar_npz(tmp_path / "val.npz", np.random.RandomState(1), 2)
    smiles = tmp_path / "smiles.txt"
    smiles.write_text("CCO\nCCN\n")
    for argv in (["train-diffphar", str(tmp_path), str(tmp_path / "d")],
                 ["train-gcpg", str(smiles), str(tmp_path / "g"), "--batch-size", "2"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(argv)
