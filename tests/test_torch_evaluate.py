"""Evaluation parity: the port's copies of the host chemistry the
evaluation harnesses read (``chem/metrics.py``, ``chem/descriptors.py``,
``chem/mol_build.py``, ``chem/rmsd.py``, ``data/dataset.py``, and
``chem/mol.py``'s kekulization without networkx) and the four functions of
``pipeline/evaluate.py``, against the JAX package on the CPU.

Host functions must agree exactly (floats to 1e-9). The harnesses are fed
the JAX package's own draws (its key splits, reproduced here):
``eval_diffphar``'s metrics agree within 1e-4 at T = 8; ``eval_gcpg``'s
tokens are equal on the same prior z and Gumbel noise;
``eval_alignment_rmsd_posed``'s RMSDs agree within 1e-3 Å on the same
embedding draws, with the same molecules failing.
"""
import jax
import jax.numpy as jnp
import networkx.algorithms.isomorphism as nxiso
import numpy as np
import pytest
import torch

import cmdgen_tpu.chem.mol as jmol
import cmdgen_tpu.models.gcpg as jgcpg
import cmdgen_tpu.pipeline.align as jalign
import cmdgen_tpu_torch.chem.mol as tmol
import cmdgen_tpu_torch.models.gcpg as tgcpg
import cmdgen_tpu_torch.ops.dgeom as tdgeom
import cmdgen_tpu_torch.pipeline.align as tevaluate_align
from cmdgen_tpu.chem import descriptors as jdesc
from cmdgen_tpu.chem import metrics as jmetrics
from cmdgen_tpu.chem import mol_build as jbuild
from cmdgen_tpu.chem import rmsd as jrmsd
from cmdgen_tpu.chem.tokenizer import Tokenizer as JTokenizer
from cmdgen_tpu.chem.tokenizer import gen_vocabs as jgen_vocabs
from cmdgen_tpu.config import GCPGModelConfig as JGCPGModelConfig
from cmdgen_tpu.config import to_dict
from cmdgen_tpu.data import dataset as jdataset
from cmdgen_tpu.diffusion.cddpm import ConditionalDDPM as JConditionalDDPM
from cmdgen_tpu.diffusion.cddpm import DDPMConfig as JDDPMConfig
from cmdgen_tpu.models.dynamics import DynamicsConfig, EGNNDynamics
from cmdgen_tpu.models.egnn import EGNNConfig
from cmdgen_tpu.pipeline import evaluate as jevaluate
from cmdgen_tpu_torch.chem import descriptors as tdesc
from cmdgen_tpu_torch.chem import metrics as tmetrics
from cmdgen_tpu_torch.chem import mol_build as tbuild
from cmdgen_tpu_torch.chem import rmsd as trmsd
from cmdgen_tpu_torch.chem.features import get_features
from cmdgen_tpu_torch.chem.posp import save_posp
from cmdgen_tpu_torch.chem.tokenizer import Tokenizer, gen_vocabs
from cmdgen_tpu_torch.config import GCPGModelConfig, from_dict
from cmdgen_tpu_torch.convert import build_gcpg, load_flax_params
from cmdgen_tpu_torch.data import dataset as tdataset
from cmdgen_tpu_torch.diffusion.cddpm import ConditionalDDPM, DDPMConfig
from cmdgen_tpu_torch.models.dynamics import DynamicsConfig as TDynamicsConfig
from cmdgen_tpu_torch.models.dynamics import EGNNDynamics as TEGNNDynamics
from cmdgen_tpu_torch.pipeline import evaluate as tevaluate
from cmdgen_tpu_torch.utils.synthetic import ligand_pdb, synthetic_diffphar_npz
from test_gcpg import VALENCE_CORPUS

torch.set_num_threads(1)

SMILES = ["CC(C)Cc1ccc(cc1)C(C)C(=O)O", "CC(=O)Oc1ccccc1C(=O)O", "Cn1cnc2c1c(=O)n(C)c(=O)n2C",
          "CC(C)(C)NCC(O)c1ccc(O)c(CO)c1", "c1ccc(cc1)S(=O)(=O)N", "OCCN1CCNCC1",
          "CC(=O)Oc1ccccc1C(=O)O", "C1CC1C(=O)Nc1ccncc1", "not a smiles", "C1CC"]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _conformer(smiles, seed):
    """An embedded conformer of ``smiles`` (the port's embedding, CPU)."""
    mol = tmol.mol_from_smiles(smiles)
    conf = tdgeom.embed_conformers(mol, 1, refine_steps=300, device="cpu",
                                   generator=torch.Generator().manual_seed(seed))[0]
    return mol, conf.numpy().astype(np.float64)


# ------------------------------------------------------------ host chemistry

def test_evaluate_set_kl_and_properties_equal_jax():
    train = {tmol.canonical_smiles(SMILES[1])}
    out, ref = tmetrics.evaluate_set(SMILES, train), jmetrics.evaluate_set(SMILES, train)
    assert out.keys() == ref.keys() and "novelty" in out
    for k in ref:
        assert out[k] == pytest.approx(ref[k], rel=1e-12, abs=1e-12), k
    hist = np.array([5, 0, 3, 1, 9, 2, 0, 1])
    ref_hist = np.array([2.0, 1, 4, 1, 3, 3, 1, 2])
    assert tmetrics.categorical_kl(hist, ref_hist) == jmetrics.categorical_kl(hist, ref_hist)
    np.testing.assert_array_equal(tmetrics.type_histogram([0, 3, 3, 7], 8),
                                  jmetrics.type_histogram([0, 3, 3, 7], 8))
    for s in SMILES + VALENCE_CORPUS[:12]:
        assert tdesc.all_properties(s) == jdesc.all_properties(s), s


def test_build_molecule_from_poses_equal_jax():
    """Bond perception from 3-D heavy-atom poses: the same bonds, orders
    and aromatic flags, and the same canonical SMILES, on both build paths;
    the largest fragment (union-find) as networkx finds it."""
    for i, s in enumerate(SMILES[:6] + ["C1CC1C(=O)Nc1ccncc1"]):
        mol, conf = _conformer(s, i)
        symbols = [a.symbol for a in mol.atoms]
        for obabel in (True, False):
            out = tbuild.build_molecule(symbols, conf, use_openbabel=obabel)
            ref = jbuild.build_molecule(symbols, conf, use_openbabel=obabel)
            assert ([(b.a1, b.a2, b.order, b.aromatic) for b in out.bonds]
                    == [(b.a1, b.a2, b.order, b.aromatic) for b in ref.bonds]), (s, obabel)
            assert tmol.write_smiles(out, canonical=True) == jmol.write_smiles(ref, canonical=True)
        # two fragments: the molecule and a far ion
        sym2 = symbols + ["Cl"]
        conf2 = np.concatenate([conf, conf[:1] + 20.0])
        out = tbuild.process_molecule(sym2, conf2)
        ref = jbuild.process_molecule(sym2, conf2)
        assert (out is None) == (ref is None)
        if ref is not None:
            assert out[2] == ref[2]
            np.testing.assert_array_equal(out[1], ref[1])
        assert tbuild._fragments(tbuild.build_molecule(sym2, conf2)) == \
            jbuild._fragments(jbuild.build_molecule(sym2, conf2))


@pytest.mark.parametrize("smiles", ["c1ccccc1", "Cc1ccc(C)cc1", "CC(C)(C)C", "OC(=O)c1ccc(cc1)C(=O)O",
                                    "C1CCCCC1"])
@pytest.mark.parametrize("align", [False, True])
def test_isomorphic_rmsd_equal_jax(smiles, align):
    """Symmetric molecules: the minimum over the graph's automorphisms is
    networkx's, with the atoms of the second conformer permuted."""
    mol, c1 = _conformer(smiles, 1)
    _, c2 = _conformer(smiles, 2)
    out = trmsd.isomorphic_rmsd(mol, c1, mol, c2, align=align)
    jm = jmol.mol_from_smiles(smiles)
    ref = jrmsd.isomorphic_rmsd(jm, c1, jm, c2, align=align)
    assert out == pytest.approx(ref, abs=1e-5)
    n_auto = sum(1 for _ in trmsd.isomorphisms(mol, mol))
    g = jrmsd._to_nx(jm)
    gm = nxiso.GraphMatcher(g, g, node_match=nxiso.categorical_node_match("symbol", None),
                            edge_match=nxiso.categorical_edge_match("order", None))
    assert n_auto == sum(1 for _ in gm.isomorphisms_iter())
    assert trmsd.isomorphic_rmsd(mol, c1, tmol.mol_from_smiles("CCO"), c2[:3]) is None


def test_datasets_equal_jax(tmp_path):
    synthetic_diffphar_npz(tmp_path / "t.npz", np.random.RandomState(0), n_complexes=5)
    out, ref = tdataset.DiffPharDataset(tmp_path / "t.npz"), jdataset.DiffPharDataset(tmp_path / "t.npz")
    assert (out.n_phar_max, out.n_pocket_max) == (ref.n_phar_max, ref.n_pocket_max)
    for idx in ([0, 1, 2, 3, 4], [3, 3]):
        b, rb = out.padded_batch(idx), ref.padded_batch(idx)
        assert b.keys() == rb.keys()
        for k in rb:
            np.testing.assert_array_equal(b[k], rb[k])
    vocab = jgen_vocabs(VALENCE_CORPUS)
    props = {"MW": list(range(len(VALENCE_CORPUS)))}
    kw = dict(max_len=64, use_random_input_smiles=True, corrupt=True, seed=3, consensus_noise=0.5)
    tds = tdataset.GCPGSmilesDataset(VALENCE_CORPUS, props, Tokenizer(gen_vocabs(VALENCE_CORPUS)),
                                     **kw)
    jds = jdataset.GCPGSmilesDataset(VALENCE_CORPUS, props, JTokenizer(vocab), **kw)
    for i in range(len(VALENCE_CORPUS)):
        a, r = tds.get_item(i), jds.get_item(i)
        assert (a is None) == (r is None)
        if r is not None:
            assert a.keys() == r.keys()
            for k in r:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(r[k]), err_msg=k)


@pytest.mark.parametrize("smiles,verdict", [
    ("c1ccc2ccccc2c1", True),               # naphthalene
    ("c1ccc2cccc2cc1", True),               # azulene
    ("c1cc2ccc3cccc4ccc(c1)c2c34", True),   # pyrene
    ("c1ccc2cc3ccccc3cc2c1", True),         # anthracene
    ("c1ccc1", False),                      # no perfect matching (4 pi, fails Hückel)
    ("c1cccc1", False),                     # five aromatic carbons: odd, none
    ("c1ccc2c(c1)c1ccccc1c1ccccc21", True),  # triphenylene
])
def test_kekulization_fallback_without_networkx(monkeypatch, smiles, verdict):
    """The budget-exhaustion fallback (forced with budget 0) reaches the
    JAX package's verdict and canonical SMILES, whose fallback is
    networkx's blossom matching; its matching is the budgeted search's."""
    want = jmol.canonical_smiles(smiles)
    normal = tmol.mol_from_smiles(smiles)
    real_t, real_j = tmol._perfect_matching, jmol._perfect_matching
    calls = []

    def t_budget0(need, adj, budget=0):
        calls.append(len(need))
        return real_t(need, adj, 0)

    monkeypatch.setattr(tmol, "_perfect_matching", t_budget0)
    monkeypatch.setattr(jmol, "_perfect_matching", lambda need, adj, budget=0: real_j(need, adj, 0))
    assert tmol.canonical_smiles(smiles) == jmol.canonical_smiles(smiles) == want
    assert calls, "the fallback was not reached"
    assert (want is not None) == verdict
    forced = tmol.mol_from_smiles(smiles)
    assert (forced is None) == (normal is None)
    if normal is not None:
        assert [b.order for b in forced.bonds] == [b.order for b in normal.bonds]


def test_exact_matching_on_graphs_without_one():
    """Two even components that cannot be matched (a star, and two
    triangles joined by an edge's far ends) are refuted; a ring is
    matched."""
    star = {0: [1, 2, 3], 1: [0], 2: [0], 3: [0]}
    assert tmol._perfect_matching_exact(set(star), star) == ()
    ring = {i: [(i - 1) % 6, (i + 1) % 6] for i in range(6)}
    pairs = tmol._perfect_matching_exact(set(ring), ring)
    assert sorted(i for p in pairs for i in p) == list(range(6))


# ------------------------------------------------------------ eval_diffphar

RES_NF, N_STEPS = 20, 8


def _jax_noise(rng, b, n_p, s_steps):
    """sample_given_pocket's draws from its key (cddpm.py's splits)."""
    k_init, k_scan, k_final = jax.random.split(rng, 3)
    shape = (b, n_p, 11)
    return tuple(_t(np.array(v)) for v in (
        jax.random.normal(k_init, shape), jax.random.normal(k_scan, (s_steps, *shape)),
        jax.random.normal(k_final, shape)))


def test_eval_diffphar_matches_jax(tmp_path):
    cfg = DynamicsConfig(phar_nf=8, residue_nf=RES_NF, joint_nf=8, edge_cutoff=6.0,
                         egnn=EGNNConfig(hidden_nf=32, n_layers=2, inv_sublayers=1))
    dcfg = JDDPMConfig(timesteps=N_STEPS)
    jdyn = EGNNDynamics(cfg)
    params = jdyn.init(jax.random.PRNGKey(4), jnp.zeros((2, 4, 11)), jnp.zeros((2, 9, 23)),
                       jnp.zeros((2, 1)), jnp.ones((2, 4)), jnp.ones((2, 9)))
    tdyn = TEGNNDynamics(from_dict(TDynamicsConfig, to_dict(cfg)))
    load_flax_params(tdyn, jax.tree_util.tree_map(np.asarray, params["params"]))
    tmodel = ConditionalDDPM(from_dict(DDPMConfig, to_dict(dcfg)), tdyn.eval())
    synthetic_diffphar_npz(tmp_path / "t.npz", np.random.RandomState(1), n_complexes=3,
                           n_pocket=(12, 20))
    jds = jdataset.DiffPharDataset(tmp_path / "t.npz")
    n_pockets, per = 2, 2
    rng = jax.random.PRNGKey(7)
    ref = jevaluate.eval_diffphar(JConditionalDDPM(dcfg, jdyn), params, rng, jds,
                                  n_pockets, per)
    noise, key = [], rng
    for _ in range(n_pockets):
        key, sub = jax.random.split(key)
        noise.append(_jax_noise(sub, per, jds.n_phar_max, N_STEPS))
    out = tevaluate.eval_diffphar(tmodel, tdataset.DiffPharDataset(tmp_path / "t.npz"),
                                  n_pockets, per, noise=noise)
    assert out.keys() == ref.keys() and out["n_sampled"] == ref["n_sampled"] > 0
    for k in ref:
        assert out[k] == pytest.approx(ref[k], abs=1e-4), k


# ------------------------------------------------------------ eval_gcpg

def test_eval_gcpg_tokens_and_metrics_equal_jax(monkeypatch):
    jcfg = JGCPGModelConfig(max_len=24, hidden_dim=32, n_layers=2, ff_dim=64, n_head=4,
                            pp_encoder_n_layer=2, dropout=0.0)
    tok = JTokenizer(jgen_vocabs(VALENCE_CORPUS))
    vocab = len(tok)
    b, s = 2, 8
    data = (np.ones((b, s), np.int32) * 4, np.ones((b, s), np.float32),
            np.zeros((b, 8, 8), np.float32), np.zeros((b, 8, 8, 1), np.float32),
            np.ones((b, 8), np.float32), np.ones((b, s), np.int32) * 4,
            np.zeros((b, 7), np.float32))
    jmodel = jgcpg.GCPG(jcfg, vocab_size=vocab)
    params = jmodel.init(jax.random.PRNGKey(0), jax.random.PRNGKey(1), *map(jnp.asarray, data))
    tmodel = build_gcpg(from_dict(GCPGModelConfig, to_dict(jcfg)),
                        jax.tree_util.tree_map(np.asarray, params["params"]), vocab, "cpu")
    tests = SMILES[:6]
    toks = {}

    def recorder(mod, name):
        real = mod.generate

        def wrapped(*a, **kw):
            toks[name] = np.asarray(real(*a, **kw))
            return toks[name] if name == "jax" else torch.from_numpy(toks[name])
        monkeypatch.setattr(mod, "generate", wrapped)

    recorder(jgcpg, "jax")
    recorder(tgcpg, "port")
    rng = jax.random.PRNGKey(13)
    ref = jevaluate.eval_gcpg(jmodel, params, tok, rng, tests, n_molecules=5, match_workers=1)
    # eval_gcpg's draws: generate's key is split(rng)[1]; generate splits
    # it into k_z (the prior z) and k_scan (the Gumbel noise, one split a step)
    _, sub = jax.random.split(rng)
    k_z, k_scan = jax.random.split(sub)
    n = toks["jax"].shape[0]
    z = jax.random.normal(k_z, (n, jcfg.hidden_dim))
    subs, key = [], k_scan
    for _ in range(jcfg.max_len - 1):
        key, k = jax.random.split(key)
        subs.append(k)
    g = jnp.stack([jax.random.gumbel(k, (n, vocab)) for k in subs])
    out = tevaluate.eval_gcpg(tmodel, Tokenizer(gen_vocabs(VALENCE_CORPUS)), tests, n_molecules=5, match_workers=1, z=_t(np.array(z)),
                              gumbel=_t(np.array(g)))
    np.testing.assert_array_equal(toks["port"], toks["jax"])
    assert out.keys() == ref.keys() and out["n_eval"] == ref["n_eval"] == 5
    for k in ref:
        assert out[k] == pytest.approx(ref[k], abs=1e-9), k
    np.testing.assert_array_equal(tevaluate.true_conditions(tests[:3])[:, :5],
                                  np.asarray([[p["MW"], p["logP"], p["QED"], p["SAS"],
                                               p["RotaNumBonds"]]
                                              for p in map(jdesc.all_properties, tests[:3])],
                                             np.float32))


# ------------------------------------------------------------ posed RMSD

C_POSE = 3


def _jax_embed_draws(key, n):
    """JAX's (u, jitter, v0) for C_POSE conformers of n atoms, [1, C, ...]."""
    def one(k):
        k1, k2, k3 = jax.random.split(k, 3)
        return (jax.random.uniform(k1, (n, n)), jax.random.normal(k2, (n, 3)),
                jax.random.normal(k3, (n, 3)))

    return tuple(_t(np.array(a))[None] for a in jax.vmap(one)(jax.random.split(key, C_POSE)))


def test_eval_alignment_rmsd_posed_matches_jax(tmp_path, monkeypatch):
    """Four pose PDBs aligned onto a hypothesis built from the first
    molecule's features: two align, one matches no feature set and one
    holds no ligand atoms; both count those two as failed."""
    mol, conf = _conformer("CC(=O)Oc1ccccc1C(=O)O", 5)
    feats = get_features(mol)
    pick = [next(a for f, a in feats if f == fam) for fam in ("Aromatic", "Acceptor", "Donor")]
    save_posp(tmp_path / "hyp.posp", ["AROM", "HACC", "HDON"],
              np.stack([conf[list(a)].mean(0) for a in pick]))
    paths = []
    for i, s in enumerate(["CC(=O)Oc1ccccc1C(=O)O", "OC(=O)c1ccccc1O", "CCCC"]):
        m, c = _conformer(s, 10 + i)
        paths.append(tmp_path / f"pose_{i}.pdb")
        paths[-1].write_text(ligand_pdb([a.symbol for a in m.atoms], c))
    paths.append(tmp_path / "empty.pdb")
    paths[-1].write_text("END\n")

    keys = []
    real_embed = jalign.embed_conformers

    def record(mol_, n_conf, rng, **kw):
        keys.append((rng, mol_.n_atoms))
        return real_embed(mol_, n_conf, rng, **kw)

    monkeypatch.setattr(jalign, "embed_conformers", record)
    ref = jevaluate.eval_alignment_rmsd_posed(paths, tmp_path / "hyp.posp",
                                              rng=jax.random.PRNGKey(21),
                                              n_conformers=C_POSE, tolerance=1)
    draws = [_jax_embed_draws(k, n) for k, n in keys]

    def fixed(m, c, nb, generator=None, device=None):
        d = draws.pop(0)
        assert tuple(d[0].shape) == (m, c, nb, nb)
        return d

    monkeypatch.setattr(tdgeom, "embed_draws", fixed)
    out = tevaluate.eval_alignment_rmsd_posed(paths, tmp_path / "hyp.posp",
                                              n_conformers=C_POSE, tolerance=1,
                                              out_dir=tmp_path / "out", device="cpu")
    assert not draws, "the port embedded fewer molecules than JAX"
    assert (out["n_aligned"], out["n_failed"]) == (ref["n_aligned"], ref["n_failed"]) == (2, 2)
    np.testing.assert_allclose(out["rmsd_values"], ref["rmsd_values"], atol=1e-3, rtol=0)
    np.testing.assert_allclose(np.load(tmp_path / "out" / "rmsd_values.npy"),
                               out["rmsd_values"], rtol=1e-6)


@pytest.mark.parametrize("diverged", ["last", "all"])
def test_eval_alignment_rmsd_posed_with_diverged_conformers_matches_jax(tmp_path, monkeypatch,
                                                                        diverged):
    """``align_molecule`` keeps diverged (NaN) conformers, sorted last. As
    in the JAX package, the pose's RMSD is the best finite one when the
    first conformer is finite, and NaN (counted as aligned) when every
    conformer diverged; none raises."""
    mol, conf = _conformer("CC(=O)Oc1ccccc1C(=O)O", 5)
    path = tmp_path / "pose.pdb"
    path.write_text(ligand_pdb([a.symbol for a in mol.atoms], conf))
    (tmp_path / "hyp.posp").write_text("AROM 0.0 0.0 0.0\nHACC 4.5 0.0 0.0\n")
    rng = np.random.RandomState(0)
    confs = [conf + rng.randn(*conf.shape) * s for s in (0.3, 0.8, 0.5)]
    bad = np.full_like(conf, np.nan)
    confs = confs[:2] + [bad] if diverged == "last" else [bad, bad, bad]
    res = [(float(i), c.astype(np.float32), [0, 1]) for i, c in enumerate(confs)]
    monkeypatch.setattr(jalign, "align_molecule", lambda *a, **kw: [
        (e, jnp.asarray(c), k) for e, c, k in res])
    monkeypatch.setattr(tevaluate_align, "align_molecule", lambda *a, **kw: res)
    ref = jevaluate.eval_alignment_rmsd_posed([path], tmp_path / "hyp.posp",
                                              rng=jax.random.PRNGKey(0))
    out = tevaluate.eval_alignment_rmsd_posed([path], tmp_path / "hyp.posp", device="cpu")
    assert (out["n_aligned"], out["n_failed"]) == (ref["n_aligned"], ref["n_failed"]) == (1, 0)
    if diverged == "all":
        assert np.isnan(out["rmsd_values"][0]) and np.isnan(ref["rmsd_values"][0])
    else:
        np.testing.assert_allclose(out["rmsd_values"], ref["rmsd_values"], atol=1e-4)


def spread_at_full_t(n_complexes=8, seed=0):
    """One-off measurement (not a test): the trained qrun_aa's unclamped
    spread at its full T=100, ``eval_diffphar``'s ``spread_gen_mean`` in
    both packages on a synthetic test set of ``n_complexes`` complexes,
    the port fed the JAX package's draws. Prints both packages' metrics.

      JAX_PLATFORMS=cpu python -c "import sys; sys.path[:0] = ['tests']; \\
          import test_torch_evaluate as t; t.spread_at_full_t()"

    (from the repository root).
    """
    import json
    import tempfile
    from pathlib import Path

    from cmdgen_tpu import config as jconfig
    from cmdgen_tpu.train.diffphar_train import build_model as jbuild_model
    from cmdgen_tpu_torch.convert import load_port_checkpoint

    ckpt = Path(__file__).resolve().parent.parent / "cmdgen_tpu_torch" / "assets" / "qrun_aa"
    cfg = jconfig.from_dict(jconfig.DiffPharConfig,
                            json.loads((ckpt / "config.json").read_text()))
    tree = {}
    with np.load(ckpt / "params.npz") as npz:
        for k in npz.files:
            node = tree
            *mods, leaf = k.split("/")
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = jnp.asarray(npz[k])
    jmodel = jbuild_model(cfg)
    tmodel, _ = load_port_checkpoint(ckpt, "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        npz_path = Path(tmp) / "test.npz"
        synthetic_diffphar_npz(npz_path, np.random.RandomState(seed), n_complexes=n_complexes)
        jds = jdataset.DiffPharDataset(npz_path)
        rng = jax.random.PRNGKey(0)
        ref = jevaluate.eval_diffphar(jmodel, {"params": tree}, rng, jds, n_complexes, 4)
        noise, key = [], rng
        for _ in range(n_complexes):
            key, sub = jax.random.split(key)
            noise.append(_jax_noise(sub, 4, jds.n_phar_max, cfg.ddpm.timesteps))
        out = tevaluate.eval_diffphar(tmodel, tdataset.DiffPharDataset(npz_path), n_complexes, 4,
                                      noise=noise)
    print(json.dumps({"jax": ref, "port": out, "complexes": n_complexes,
                      "T": cfg.ddpm.timesteps}))
