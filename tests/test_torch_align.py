"""Stage 4 parity: the port's feature perception, SDF writer,
distance-geometry embedding (``ops/dgeom.py``) and alignment
(``pipeline/align.py``) against the JAX package on the CPU at float32.

One shape throughout: the four molecules of ``SMILES`` in one 32-atom
bucket (M = 4, Nb = 32), C = 4 conformers, the three points of
``POINTS``; the embedding compiles in JAX three times (refine_steps 0, 10
and 100; the alignment's call is the 100-step one). The draws are JAX's
own, split as ``embed_conformers_padded`` splits them (``dgeom.py:274-280,
310``). Tolerances:
- bounds, features and SDF bytes equal;
- ``_mds_top3`` within 1e-5 * max|x|, the closed-form gradient within
  1e-5 of max|grad| (float32 rounding of the same sums);
- the embedding on distinct groups within 1e-4 * max|x| through 100 steps
  (a trial read 3e-6: heavy-ball descent keeps rounding from growing);
- ``align_entries``: the same matched molecules, RMSDs within 1e-4 Å in
  the same order, posed coordinates within 1e-4 * max|x|; the three points
  are not collinear, so each conformer's rotation is unique (for two or
  collinear points the rotation about their axis is not unique in either
  package, and only the RMSD could be held).

With coincident groups (one atom set matched to two points, which
``match_features_to_points`` does when a point type runs out of
candidates) the two copies of one centroid sit at the distance floor
sqrt(1e-8), where the pair's weight (w + w^T)/dist is about 1e5. Its
force on the shared atoms cancels only if it is formed as JAX's autodiff
forms it, from the difference of the two copies (exactly zero); formed as
W.sum(-1) x - W @ x it is the difference of two products of size 1e5 * |x|,
whose rounding (~1e-2 Å a step) would decide a direction and part the
packages. The port forms it from the difference, so the coordinates are
held as on distinct groups, and so are the two quantities no direction
enters (each conformer's mean bounds violation and its centroid RMSD
after Kabsch), within ``COINCIDENT_TOL``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmdgen_tpu.chem import features as jfeatures
from cmdgen_tpu.chem import sdf as jsdf
from cmdgen_tpu.chem.mol import mol_from_smiles as jmol
from cmdgen_tpu.ops import dgeom as jd
from cmdgen_tpu.pipeline import align as ja
from cmdgen_tpu_torch.chem import features, sdf
from cmdgen_tpu_torch.chem.mol import mol_from_smiles
from cmdgen_tpu_torch.ops import dgeom as td
from cmdgen_tpu_torch.ops.kabsch import kabsch
from cmdgen_tpu_torch.pipeline import align as ta

torch.set_num_threads(1)

SMILES = [
    "OC(=O)c1ccccc1Nc1cccc(c1)C(F)(F)F",
    "Oc1ccc(cc1)CCNC(=O)c1ccccc1O",
    "COc1cc(ccc1O)C=CC(=O)NCc1ccccc1",
    "CN1CCN(CC1)c1ccc(cc1)NC(=O)c1ccc(O)cc1",
]
TYPES = ["AROM", "HACC", "HDON"]
POINTS = np.array([[0.0, 0.0, 0.0], [4.5, 0.0, 0.0], [1.0, 4.0, 0.5]], np.float32)
M, NB, C, K = 4, 32, 4, 3
KEY = jax.random.PRNGKey(5)
# coincident groups: bounds violation and centroid RMSD (Å) within this
# of JAX's, the RMSD tolerance of align_entries
COINCIDENT_TOL = 1e-4

FEATURE_SMILES = [
    "c1ccccc1", "Cc1ccncc1", "c1ccc2[nH]ccc2c1", "c1ccoc1", "CC(C)(C)c1ccccc1",
    "ClCCBr", "FC(F)(F)c1ccccc1", "CCCCI", "NCCN", "CN(C)C", "C[N+](C)(C)C",
    "NC(=N)N", "CC(=N)N", "CC(=O)O", "CC(=O)[O-]", "CS(=O)(=O)O", "CP(=O)(O)O",
    "c1nnn[nH]1", "CCOCC", "CC(=O)C", "CC(=O)NC", "NS(=O)(=O)c1ccccc1",
    "C[N+](=O)[O-]", "OCCO", "C1CCCCC1", "C1CCNCC1", "CC=CC#N", "OC1CCCC1",
    "CC(C)CC(=O)OC", "c1ccc2ccccc2c1",
]


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_draws(key):
    """JAX's (u, jitter, v0) for M x C conformers of NB atoms."""
    keys = jax.random.split(key, M * C).reshape(M, C, 2)

    def one(k):
        k1, k2, k3 = jax.random.split(k, 3)
        return (jax.random.uniform(k1, (NB, NB)), jax.random.normal(k2, (NB, 3)),
                jax.random.normal(k3, (NB, 3)))

    return tuple(_t(a) for a in jax.vmap(jax.vmap(one))(keys))


def _jax_embed(lo, up, amask, gmat, targets, steps, key):
    """JAX's embedding, called as its ``align_entries`` calls it."""
    return np.asarray(jd.embed_conformers_padded(
        jnp.asarray(lo), jnp.asarray(up), jnp.asarray(amask), C, key,
        refine_steps=steps, groups=jnp.asarray(gmat),
        targets=jnp.broadcast_to(jnp.asarray(targets), (M, K, K)),
        group_mask=jnp.ones((M, K)), centroid_weight=2.0))


def _port_embed(lo, up, amask, gmat, targets, steps, draws):
    return td.embed_conformers_padded(
        _t(lo), _t(up), _t(amask), C, steps, groups=_t(gmat),
        targets=_t(targets).expand(M, K, K), centroid_weight=2.0, draws=draws).numpy()


@pytest.fixture(scope="module")
def case():
    """Entries of both packages, the padded inputs of the one bucket, JAX's
    draws for it and JAX's align_entries on them."""
    jents = ja.prepare_align_entries(SMILES, TYPES)
    ents = ta.prepare_align_entries(SMILES, TYPES)
    assert [e[0] for e in jents] == [e[0] for e in ents] == [0, 1, 2, 3]
    assert [e[2] for e in jents] == [e[2] for e in ents]
    assert all(len(set(e[2])) == K for e in ents), "the groups must be distinct"
    lo, up, amask = td.padded_bounds([e[1] for e in ents], NB)
    gmat = np.stack([ta.group_matrix(e[2], NB) for e in ents])
    targets = np.sqrt(((POINTS[:, None] - POINTS[None]) ** 2).sum(-1)).astype(np.float32)
    _, sub = jax.random.split(KEY)  # align_entries' split for its one bucket
    jres = ja.align_entries(jents, POINTS, KEY, n_conformers=C, num_keep=3,
                            refine_steps=100, bucket=16)
    return dict(ents=ents, lo=lo, up=up, amask=amask, gmat=gmat, targets=targets,
                sub=sub, draws=_jax_draws(sub), jres=jres)


@pytest.fixture(scope="module")
def embeddings(case):
    """{steps: (JAX, port)} embeddings of the bucket on the same draws."""
    args = [case[k] for k in ("lo", "up", "amask", "gmat", "targets")]
    return {s: (_jax_embed(*args, s, case["sub"]), _port_embed(*args, s, case["draws"]))
            for s in (0, 10, 100)}


def test_features_equal_jax():
    fams = set()
    for s in FEATURE_SMILES:
        ref = jfeatures.get_features(s)
        assert features.get_features(s) == ref, s
        assert features.get_features(mol_from_smiles(s)) == ref, s
        assert features.features_to_gcpg_indices(ref) == jfeatures.features_to_gcpg_indices(ref)
        fams.update(f for f, _ in ref)
    assert fams == set(features.PHAR_FAMILIES) - {"others"}
    assert features.get_features("C1CC") is None


def test_bounds_equal_jax():
    for s in SMILES + FEATURE_SMILES:
        for a, b in zip(td.bounds_matrix(mol_from_smiles(s)), jd.bounds_matrix(jmol(s))):
            np.testing.assert_array_equal(a, b)
    mols = [mol_from_smiles(s) for s in SMILES]
    for n_pad in (None, 48):
        for a, b in zip(td.padded_bounds(mols, n_pad),
                        jd.padded_bounds([jmol(s) for s in SMILES], n_pad)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_mds_top3_and_classical_mds_match_jax(case):
    d = case["lo"] + case["draws"][0][:, 0].numpy() * (case["up"] - case["lo"])
    d = (d + d.transpose(0, 2, 1)) / 2 * (1 - np.eye(NB, dtype=np.float32))
    d2 = (d * d).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(9), M)
    v0 = np.stack([np.asarray(jax.random.normal(k, (NB, 3))) for k in keys])
    ref = np.asarray(jax.jit(jax.vmap(jd._mds_top3))(jnp.asarray(d2), keys))
    out = td._mds_top3(_t(d2), _t(v0)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)
    # the full eigh: eigenvectors' signs are free, so compare Gram matrices
    ref = np.stack([np.asarray(jd._classical_mds(jnp.asarray(a))) for a in d2])
    out = td._classical_mds(_t(d2)).numpy()
    gram = np.einsum("mid,mjd->mij", ref, ref)
    np.testing.assert_allclose(np.einsum("mid,mjd->mij", out, out), gram,
                               atol=1e-4 * np.abs(gram).max(), rtol=0)


def test_refine_grad_matches_jax_grad(case):
    """The closed-form gradient against jax.grad of JAX's loss (its
    ``one``/``loss`` at dgeom.py:284-301, verbatim), both terms, padded
    atoms, a masked-out group."""
    rng = np.random.RandomState(3)
    x = (rng.randn(M, NB, 3) * 3).astype(np.float32)
    gm = np.ones((M, K), np.float32)
    gm[2, 1] = 0.0
    am = case["amask"]
    pv = am[:, :, None] * am[:, None, :] * (1 - np.eye(NB, dtype=np.float32))[None]
    cw = 2.0

    def loss(x, lo_i, up_i, pv_i, g_i, t_i, gm_i):
        diff = x[:, None, :] - x[None, :, :]
        dist = jnp.sqrt(jnp.sum(diff**2, -1) + 1e-8)
        over = jnp.maximum(dist - up_i, 0.0)
        under = jnp.maximum(lo_i - dist, 0.0)
        l = jnp.sum((over**2 + under**2) * pv_i)
        cents = g_i @ x
        cd = jnp.sqrt(jnp.sum((cents[:, None, :] - cents[None, :, :]) ** 2, -1) + 1e-8)
        gm2 = gm_i[:, None] * gm_i[None, :]
        return l + cw * jnp.sum((cd - t_i) ** 2 * gm2 * (1.0 - jnp.eye(t_i.shape[0])))

    targets = np.broadcast_to(case["targets"], (M, K, K))
    ref = np.asarray(jax.jit(jax.vmap(jax.grad(loss)))(
        *[jnp.asarray(a) for a in (x, case["lo"], case["up"], pv, case["gmat"], targets, gm)]))
    gm2 = gm[:, :, None] * gm[:, None, :] * (1 - np.eye(K, dtype=np.float32))
    out = td.refine_grad(_t(x)[:, None], _t(case["lo"])[:, None], _t(case["up"])[:, None],
                         _t(pv)[:, None], _t(case["gmat"])[:, None], _t(targets)[:, None],
                         _t(cw * gm2)[:, None])[:, 0].numpy()
    assert np.abs(ref).max() > 1.0
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("steps", [0, 10, 100])
def test_embedding_matches_jax_on_distinct_groups(embeddings, steps):
    ref, out = embeddings[steps]
    assert np.isfinite(ref).all() and ref.shape == (M, C, NB, 3)
    np.testing.assert_allclose(out, ref, atol=1e-4 * np.abs(ref).max(), rtol=0)


def test_embedding_with_coincident_groups_matches_jax(case):
    """Molecule 0's first two points take one atom set: the coordinates,
    the bounds violation and the centroid RMSD agree with JAX's."""
    gmat = case["gmat"].copy()
    gmat[0, 1] = gmat[0, 0]
    args = [case[k] for k in ("lo", "up", "amask")] + [gmat, case["targets"]]
    ref = _jax_embed(*args, 100, case["sub"])
    out = _port_embed(*args, 100, case["draws"])
    np.testing.assert_allclose(out, ref, atol=1e-4 * np.abs(ref).max(), rtol=0)
    mol = case["ents"][0][1]
    n = mol.n_atoms
    for c in range(C):
        viol = [td.bounds_violation(mol, x[0, c, :n]) for x in (ref, out)]
        rms = [ta.pose_conformers(_t(x[0, c]), _t(gmat[0]), _t(POINTS))[1].item()
               for x in (ref, out)]
        assert abs(viol[0] - viol[1]) < COINCIDENT_TOL, (c, viol)
        assert abs(rms[0] - rms[1]) < COINCIDENT_TOL, (c, rms)


@pytest.mark.parametrize("scale", [2.0, 3.0])
def test_divergence_matches_jax(case, scale):
    """The points moved apart (9-20 Å) make the refinement diverge for
    some conformers (3 and 15 of 16 on these draws): the same ones in both
    packages, so the drop rule (not finite or RMSD >= 1e3 Å) drops the
    same conformers, and the others agree as before. The divergence is the
    reference algorithm's, not the port's."""
    args = [case[k] for k in ("lo", "up", "amask", "gmat")] + [case["targets"] * scale]
    errs = []
    for x in (_jax_embed(*args, 100, case["sub"]), _port_embed(*args, 100, case["draws"])):
        errs.append(ta.pose_conformers(_t(x), _t(case["gmat"])[:, None],
                                       _t(POINTS * scale))[1].numpy())
    kept = [np.isfinite(e) & (e < ta.MAX_RMSD) for e in errs]
    assert 0 < (~kept[0]).sum() < kept[0].size
    np.testing.assert_array_equal(kept[1], kept[0])
    np.testing.assert_allclose(errs[1][kept[0]], errs[0][kept[0]], atol=1e-4, rtol=0)


def _with_draws(monkeypatch, draws):
    """The embedding takes ``draws`` in place of its generator's."""
    def fixed(m, c, nb, generator=None, device=None):
        assert tuple(draws[0].shape) == (m, c, nb, nb)
        return draws

    monkeypatch.setattr(td, "embed_draws", fixed)


def test_align_entries_matches_jax(case, monkeypatch):
    _with_draws(monkeypatch, case["draws"])
    res = ta.align_entries(case["ents"], POINTS, n_conformers=C, num_keep=3,
                           refine_steps=100, bucket=16, device="cpu")
    jres = case["jres"]
    assert sorted(res) == sorted(jres) == [0, 1, 2, 3]
    for idx, ref in jres.items():
        out = res[idx]
        assert len(out) == len(ref) == 3
        np.testing.assert_allclose([e for e, _ in out], [e for e, _ in ref], atol=1e-4, rtol=0)
        for (_, x), (_, x_ref) in zip(out, ref):
            assert x.shape == x_ref.shape == (case["ents"][idx][1].n_atoms, 3)
            np.testing.assert_allclose(x, x_ref, atol=1e-4 * np.abs(x_ref).max(), rtol=0)


def test_non_finite_conformer_is_dropped_not_raised(case, monkeypatch):
    """A diverged conformer (NaN) is dropped and the chunk's other rows
    come back; a molecule whose every conformer diverged is dropped. The
    batched SVD itself raises on such a row, which the stand-in avoids."""
    real = td.embed_conformers_padded

    def diverged(*a, **kw):
        x = real(*a, **kw)
        x[1, 0] = float("nan")        # one conformer of molecule 1
        x[2] = float("inf")           # every conformer of molecule 2
        return x

    monkeypatch.setattr(ta, "embed_conformers_padded", diverged)
    _with_draws(monkeypatch, case["draws"])
    res = ta.align_entries(case["ents"], POINTS, n_conformers=C, num_keep=C,
                           refine_steps=10, device="cpu")
    assert sorted(res) == [0, 1, 3]
    assert [len(res[i]) for i in (0, 1, 3)] == [C, C - 1, C]
    assert all(np.isfinite(e) and np.isfinite(x).all() for r in res.values() for e, x in r)
    bad = torch.full((2, K, 3), float("nan"), dtype=torch.float64)
    with pytest.raises(RuntimeError):
        kabsch(bad, _t(POINTS).double().expand(2, K, 3))


def test_align_molecule_to_own_features():
    """A pharmacophore built from an embedded conformer of the molecule
    itself: the per-molecule path (``embed_conformers``) finds a pose of
    low RMSD, and its conformers are the padded path's on the same draws."""
    smiles = "CCOc1ccccc1"
    mol = mol_from_smiles(smiles)
    conf = td.embed_conformers(mol, 1, refine_steps=400,
                               generator=torch.Generator().manual_seed(1))[0].numpy()
    assert td.bounds_violation(mol, conf) < 0.3
    feats = features.get_features(mol)
    arom = next(a for f, a in feats if f == "Aromatic")
    acc = next(a for f, a in feats if f == "Acceptor")
    pp = np.stack([conf[list(arom)].mean(0), conf[list(acc)].mean(0)]).astype(np.float32)
    res = ta.align_molecule(smiles, pp, ["AROM", "HACC"], torch.Generator().manual_seed(2),
                            n_conformers=4, refine_steps=300)
    assert res is not None and res[0][0] < 1.0 and res[0][2] == [0, 1]
    assert [e for e, _, _ in res] == sorted(e for e, _, _ in res)
    n = mol.n_atoms
    lo, up = td.bounds_matrix(mol)
    draws = td.embed_draws(1, 2, n, torch.Generator().manual_seed(3))
    one = td.embed_conformers(mol, 2, refine_steps=20, draws=draws, device="cpu")
    padded = td.embed_conformers_padded(
        _t(lo[None].astype(np.float32)), _t(np.minimum(up, 100.0)[None].astype(np.float32)),
        torch.ones(1, n), 2, 20, draws=draws)[0]
    torch.testing.assert_close(one, padded, rtol=0, atol=0)


def test_write_sdf_bytes_equal_jax(tmp_path):
    rng = np.random.RandomState(0)
    mols, bonds = [], []
    for i, s in enumerate(["CCO", "c1ccccc1C(=O)[O-]", "C[N+](C)(C)CCl"]):
        m = mol_from_smiles(s)
        mols.append(([a.symbol for a in m.atoms],
                     (rng.randn(m.n_atoms, 3) * 5).astype(np.float32), f"{s} rmsd={i * 0.123:.3f}"))
        bonds.append([(b.a1, b.a2, b.order) for b in m.bonds])
    sdf.write_sdf(tmp_path / "port.sdf", mols, bonds_list=bonds)
    jsdf.write_sdf(tmp_path / "jax.sdf", mols, bonds_list=bonds)
    assert (tmp_path / "port.sdf").read_bytes() == (tmp_path / "jax.sdf").read_bytes()
    back = sdf.read_sdf(tmp_path / "port.sdf")
    assert [m.n_atoms for m, _ in back] == [len(s) for s, _, _ in mols]
    np.testing.assert_allclose(back[0][1], mols[0][1], atol=1e-4)


def test_align_smiles_list_writes_readable_sdfs(tmp_path):
    """--tolerance 1: a molecule without a donor aligns on the two other
    points; each posed SDF reads back with its num_keep conformers."""
    posp = tmp_path / "hyp.posp"
    posp.write_text("".join(f"{t} {x:.3f} {y:.3f} {z:.3f}\n" for t, (x, y, z) in zip(TYPES, POINTS)))
    smiles = [SMILES[1], "COc1ccccc1", "not_a_smiles", "CCCC"]
    best = ta.align_smiles_list(smiles, posp, tmp_path / "out", n_conformers=3, num_keep=2,
                                tolerance=1, device="cpu")
    assert set(best) == {SMILES[1], "COc1ccccc1"}
    vals = np.load(tmp_path / "out" / "rmsd_values.npy")
    assert vals.shape == (2,) and np.isfinite(vals).all()
    for i, s in ((0, SMILES[1]), (1, "COc1ccccc1")):
        back = sdf.read_sdf(tmp_path / "out" / f"mol_{i}.sdf")
        assert len(back) == 2
        assert all(m.n_atoms == mol_from_smiles(s).n_atoms and np.isfinite(x).all()
                   for m, x in back)
