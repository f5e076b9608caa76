"""The consensus stage of the port (``ops/kabsch.py``, ``ops/clustering.py``,
``pipeline/get_phar.py``, ``chem/posp.py``) against the JAX package on the
CPU at f32, and the JAX package's own consensus tests
(``tests/test_clustering_kabsch.py``, ``tests/test_dual_target.py``)
mirrored on the port.

JAX's PRNG stream cannot be reproduced in torch, so parity is held two
ways: the fitting functions are started from the JAX package's own
initialisation (``kmeans(key, x, k, iters=0).centers`` as ``init``,
``gmm_fit(key, x, k, iters=0).means`` as ``init_means``), and the
``get_phar`` functions are run on well-separated, tie-free clouds whose
fits do not depend on the draw. Tolerances: atol 2e-4 / rtol 1e-4 on
fitted values; ``.posp`` centres matched by type and nearest centre within
1e-3 Å; DBSCAN labels and DBSCAN consensus output exactly equal."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmdgen_tpu.ops import clustering as jcl
from cmdgen_tpu.ops import kabsch as jkb
from cmdgen_tpu.pipeline import get_phar as jgp
from cmdgen_tpu_torch.chem.posp import load_phar_file
from cmdgen_tpu_torch.ops import clustering as cl
from cmdgen_tpu_torch.ops.kabsch import aligned_rmsd, apply_rigid, kabsch, rmsd
from cmdgen_tpu_torch.pipeline import get_phar as gp

torch.set_num_threads(1)

CPU = "cpu"
TOL = dict(atol=2e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rand_rot(rng):
    q, r = np.linalg.qr(rng.randn(3, 3))
    q = q @ np.diag(np.sign(np.diag(r)))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q.astype(np.float32)


def _blobs(rng, centers, n, sd):
    return np.concatenate([rng.randn(n, 3) * sd + c for c in centers]).astype(np.float32)


# ------------------------------------------------------------------ kabsch

@pytest.mark.parametrize("case", ["rigid", "noisy", "reflected", "weighted"])
def test_kabsch_matches_jax(case):
    rng = np.random.RandomState(0)
    p = rng.randn(12, 3).astype(np.float32)
    q = p @ _rand_rot(rng).T + np.array([1.0, -2.0, 3.0], np.float32)
    w = None
    if case == "noisy":
        q = q + rng.randn(12, 3).astype(np.float32) * 0.3
    elif case == "reflected":
        q = p.copy()
        q[:, 0] = -q[:, 0]  # no proper rotation matches it: d = -1
    elif case == "weighted":
        w = rng.rand(12).astype(np.float32)
    jr, jt = jkb.kabsch(jnp.asarray(p), jnp.asarray(q),
                        None if w is None else jnp.asarray(w))
    r, t = kabsch(_t(p), _t(q), None if w is None else _t(w))
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), **TOL)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), **TOL)
    assert float(torch.linalg.det(r)) == pytest.approx(1.0, abs=1e-4)
    np.testing.assert_allclose(aligned_rmsd(_t(p), _t(q)).numpy(),
                               np.asarray(jkb.aligned_rmsd(jnp.asarray(p), jnp.asarray(q))),
                               **TOL)
    np.testing.assert_allclose(apply_rigid(r, t, _t(p)).numpy(),
                               np.asarray(jkb.apply_rigid(jr, jt, jnp.asarray(p))), **TOL)


def test_kabsch_batched_matches_jax():
    rng = np.random.RandomState(1)
    p = rng.randn(16, 9, 3).astype(np.float32)
    rots = np.stack([_rand_rot(rng) for _ in range(16)])
    q = np.einsum("bij,bnj->bni", rots, p) + rng.randn(16, 1, 3).astype(np.float32)
    q[::2] += rng.randn(8, 9, 3).astype(np.float32) * 0.2
    q[1, :, 2] *= -1  # one reflected pair
    jr, jt = jkb.kabsch_batch(jnp.asarray(p), jnp.asarray(q))
    r, t = kabsch(_t(p), _t(q))
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), **TOL)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), **TOL)
    np.testing.assert_allclose(
        aligned_rmsd(_t(p), _t(q)).numpy(),
        np.asarray(jkb.aligned_rmsd_batch(jnp.asarray(p), jnp.asarray(q))), **TOL)
    mask = (rng.rand(16, 9) > 0.3).astype(np.float32)
    np.testing.assert_allclose(
        rmsd(_t(p), _t(q), _t(mask)).numpy(),
        np.asarray(jkb.rmsd(jnp.asarray(p), jnp.asarray(q), jnp.asarray(mask))), **TOL)


# -------------------------------------------------------------- clustering

def _overlapping(seed=0):
    rng = np.random.RandomState(seed)
    return _blobs(rng, [[0, 0, 0], [3, 0, 0], [0, 3, 0], [1.5, 1.5, 2.5]], 75, 0.8)


@pytest.mark.parametrize("k", [3, 5])
def test_kmeans_from_jax_init_matches_jax(k):
    x = _overlapping()
    key = jax.random.PRNGKey(k)
    init = np.asarray(jcl.kmeans(key, jnp.asarray(x), k, iters=0, n_init=1).centers)
    ref = jcl.kmeans(key, jnp.asarray(x), k, iters=50, n_init=1)
    out = cl.kmeans(_t(x), k, iters=50, n_init=1, init=_t(init)[None])
    np.testing.assert_allclose(out.centers.numpy(), np.asarray(ref.centers), **TOL)
    np.testing.assert_array_equal(out.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_allclose(float(out.inertia), float(ref.inertia), **TOL)
    # best of n_init: a second start far from the data ends as one cluster
    # and loses to JAX's start
    bad = init + 100.0 * np.arange(1, k + 1, dtype=np.float32)[:, None]
    best = cl.kmeans(_t(x), k, iters=50, n_init=2, init=_t(np.stack([bad, init])))
    np.testing.assert_allclose(best.centers.numpy(), np.asarray(ref.centers), **TOL)


@pytest.fixture(scope="module")
def jax_gmm():
    """(cloud, JAX's init means, JAX's 100-round fit from them): one JAX
    fit shared by the GMM tests."""
    x = _overlapping(1)
    key = jax.random.PRNGKey(3)
    init = np.asarray(jcl.gmm_fit(key, jnp.asarray(x), 4, iters=0).means)
    return x, init, jcl.gmm_fit(key, jnp.asarray(x), 4, iters=100)


def test_gmm_fit_from_jax_init_matches_jax(jax_gmm):
    x, init, ref = jax_gmm
    out = cl.gmm_fit(_t(x), 4, iters=100, init_means=_t(init))
    for name in ("means", "covs", "weights", "log_likelihood"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)), **TOL, err_msg=name)
    np.testing.assert_allclose(cl.gmm_predict_proba(out, _t(x)).numpy(),
                               np.asarray(jcl.gmm_predict_proba(ref, jnp.asarray(x))), **TOL)


def test_gmm_predict_proba_on_one_shared_gmm(jax_gmm):
    _, _, g = jax_gmm
    x = _overlapping(2)  # other points than the fit's
    tg = cl.GMMResult(*[_t(np.asarray(v)) for v in g])
    proba = cl.gmm_predict_proba(tg, _t(x)).numpy()
    np.testing.assert_allclose(proba, np.asarray(jcl.gmm_predict_proba(g, jnp.asarray(x))),
                               **TOL)
    np.testing.assert_allclose(proba.sum(1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(cl.gmm_predict(tg, _t(x)).numpy(),
                                  np.asarray(jcl.gmm_predict(g, jnp.asarray(x))))


def _dbscan_cloud(seed=4):
    """Two dense blobs, a bridge of border points, scattered noise."""
    rng = np.random.RandomState(seed)
    return np.concatenate([
        _blobs(rng, [[0, 0, 0], [4, 4, 4]], 40, 0.25),
        np.linspace([0.9, 0.9, 0.9], [3.1, 3.1, 3.1], 7).astype(np.float32),
        (rng.rand(15, 3) * 12 - 4).astype(np.float32),
        np.array([[20.0, 20.0, 20.0]], np.float32),
    ])


@pytest.mark.parametrize("eps,min_samples", [(0.6, 5), (1.0, 8), (0.3, 3)])
def test_dbscan_labels_equal_jax(eps, min_samples, monkeypatch):
    monkeypatch.setattr(cl, "DBSCAN_ROW_CHUNK", 37)  # cross the row chunks' seams
    x = _dbscan_cloud()
    ref = np.asarray(jcl.dbscan(jnp.asarray(x), eps, min_samples))
    out = cl.dbscan(_t(x), eps, min_samples).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (out == -1).any() and len(set(out.tolist()) - {-1}) >= 2


# ------------------------------------------------------ consensus functions

SITES = np.array([[0, 0, 0], [6, 0, 0], [0, 6, 0], [3, 3, 5]], np.float32)
FAMS = ["Aromatic", "Acceptor", "Donor", "Hydrophobe"]


def _site_cloud(seed, n=60, sd=0.4):
    """Well-separated sites, each 80% its own family (tie-free)."""
    rng = np.random.RandomState(seed)
    pts, fams = [], []
    for s, fam in zip(SITES, FAMS):
        pts.append(s + rng.randn(n, 3).astype(np.float32) * sd)
        fams += [fam if i % 5 else FAMS[(FAMS.index(fam) + 1) % 4] for i in range(n)]
    return np.concatenate(pts), fams


def _match_consensus(out, ref, atol=1e-3):
    """Same multiset of (type, centre): each JAX point matched by type to
    the port's nearest centre within atol Å."""
    assert sorted(t for t, _ in out) == sorted(t for t, _ in ref)
    left = list(out)
    for t, c in ref:
        cands = [i for i, (tt, _) in enumerate(left) if tt == t]
        i = min(cands, key=lambda i: np.abs(left[i][1] - c).max())
        np.testing.assert_allclose(left[i][1], c, atol=atol)
        left.pop(i)


def test_consensus_gmm_kmeans_and_report_match_jax():
    x, fams = _site_cloud(0)
    _match_consensus(gp.consensus_gmm(x, fams, 4, seed=1, device=CPU),
                     jgp.consensus_gmm(x, fams, 4, seed=1))
    _match_consensus(gp.consensus_kmeans(x, fams, 4, seed=1, device=CPU),
                     jgp.consensus_kmeans(x, fams, 4, seed=1))
    out = sorted(gp.cluster_report(x, fams, 4, seed=1, device=CPU),
                 key=lambda r: r["center"])
    ref = sorted(jgp.cluster_report(x, fams, 4, seed=1), key=lambda r: r["center"])
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o["center"], r["center"], atol=1e-3)
        assert o["counts"] == r["counts"] and o["top_family"] == r["top_family"]
        for f in r["probs"]:
            np.testing.assert_allclose(o["probs"][f], r["probs"][f], atol=1e-3)


@pytest.mark.parametrize("standardize,eps", [(False, 0.8), (True, 0.2)])
def test_consensus_dbscan_exactly_equal_jax(standardize, eps):
    x, fams = _site_cloud(1)
    out = gp.consensus_dbscan(x, fams, eps=eps, min_samples=6, standardize=standardize,
                              device=CPU)
    ref = jgp.consensus_dbscan(x, fams, eps=eps, min_samples=6, standardize=standardize)
    assert len(out) == len(ref) >= 4
    for (t, c), (rt, rc) in zip(out, ref):
        assert t == rt
        np.testing.assert_array_equal(c, rc)


def test_nn_distances_and_align_pharmacophores_match_jax():
    rng = np.random.RandomState(2)
    a = rng.randn(30, 3).astype(np.float32) * 3
    b = rng.randn(45, 3).astype(np.float32) * 3
    np.testing.assert_allclose(gp.nn_distances(a, b, device=CPU), jgp.nn_distances(a, b),
                               **TOL)
    probe = a[:10] @ _rand_rot(rng).T + 2.0 + rng.randn(10, 3).astype(np.float32) * 0.1
    out = gp.align_pharmacophores(a[:10], probe, device=CPU)
    ref = jgp.align_pharmacophores(a[:10], probe)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o, r, **TOL)


def _two_target(seed, n_per_site=40, noise=0.15):
    """Cloud 2 on four sites; cloud 1 the same points rotated, moved and
    jittered (as tests/test_dual_target.py builds them)."""
    rng = np.random.RandomState(seed)
    c2, f2 = _site_cloud(seed, n_per_site, noise)
    r = _rand_rot(rng)
    t = np.array([5.0, -3.0, 2.0], np.float32)
    c1 = c2 @ r.T + t + rng.randn(len(c2), 3).astype(np.float32) * 0.02
    return c1, list(f2), c2, list(f2), r, t


@pytest.mark.parametrize("mode", ["positional", "icp"])
def test_register_clouds_matches_jax(mode):
    c1, _, c2, _, _, _ = _two_target(3, n_per_site=20, noise=0.1)
    if mode == "icp":
        c1 = c1[np.random.RandomState(0).permutation(len(c1))[: 3 * len(c1) // 4]]
    moved, r, t = gp.register_clouds(c1, c2, mode=mode, device=CPU)
    jmoved, jr, jt = jgp.register_clouds(c1, c2, mode=mode)
    np.testing.assert_allclose(moved, jmoved, atol=1e-3)
    np.testing.assert_allclose(r, jr, atol=1e-4)
    np.testing.assert_allclose(t, jt, atol=1e-3)
    np.testing.assert_allclose(gp.inverse_transform(moved, r, t),
                               jgp.inverse_transform(jmoved, jr, jt), atol=2e-3)


@pytest.mark.parametrize("method", ["gmm", "dbscan"])
def test_dual_target_consensus_matches_jax(method):
    c1, f1, c2, f2, _, _ = _two_target(4, n_per_site=50, noise=0.2)
    kw = dict(n_clusters=4, seed=1, method=method, dbscan_eps=0.2, dbscan_min_samples=12)
    cons2, cons1 = gp.dual_target_consensus(c1, f1, c2, f2, device=CPU, **kw)
    ref2, ref1 = jgp.dual_target_consensus(c1, f1, c2, f2, **kw)
    assert len(cons2) >= 4
    _match_consensus(cons2, ref2)
    _match_consensus(cons1, ref1)


def test_dual_target_indiv_and_cluster_info_match_jax():
    c1, f1, c2, f2, _, _ = _two_target(5)
    out = gp.dual_target_consensus_indiv(c1, f1, c2, f2, n_clusters=4, seed=1, device=CPU)
    ref = jgp.dual_target_consensus_indiv(c1, f1, c2, f2, n_clusters=4, seed=1)
    _match_consensus(out, ref)
    info = sorted(gp.cluster_info_gmm(c2, f2, 4, seed=2, device=CPU),
                  key=lambda i: tuple(i["center"]))
    jinfo = sorted(jgp.cluster_info_gmm(c2, f2, 4, seed=2), key=lambda i: tuple(i["center"]))
    for o, r in zip(info, jinfo):
        np.testing.assert_allclose(o["center"], r["center"], atol=1e-3)
        assert o["top_family"] == r["top_family"]
        for f in r["probs"]:
            np.testing.assert_allclose(o["probs"][f], r["probs"][f], atol=1e-3)


def test_selective_consensus_exactly_equal_jax():
    x, fams = _site_cloud(6)
    anti = x[: len(x) // 2]  # the anti-target shares the first two sites
    out = gp.selective_consensus(x, fams, anti, eps=0.8, min_samples=5, device=CPU)
    ref = jgp.selective_consensus(x, fams, anti, eps=0.8, min_samples=5)
    assert len(out) == len(ref) >= 2
    for (t, c), (rt, rc) in zip(out, ref):
        assert t == rt
        np.testing.assert_array_equal(c, rc)
    assert gp.selective_consensus(x, fams, x, device=CPU) == []


def test_json_posp_round_trip_equals_jax(tmp_path):
    x, fams = _site_cloud(7, n=10)
    data = {f"Molecule_{i}": {} for i in range(len(x) // 4)}
    for i, (p, f) in enumerate(zip(x, fams)):
        data[f"Molecule_{i % len(data)}"].setdefault(f, []).append(p.tolist())
    path = tmp_path / "cloud.json"
    path.write_text(json.dumps(data))
    coords, families = gp.load_point_cloud_json(path)
    jcoords, jfamilies = jgp.load_point_cloud_json(path)
    np.testing.assert_array_equal(coords, jcoords)
    assert families == jfamilies
    cons = jgp.consensus_dbscan(coords, families, eps=0.8, min_samples=4)
    gp.write_consensus(tmp_path / "a.posp", cons)
    jgp.write_consensus(tmp_path / "b.posp", cons)
    assert (tmp_path / "a.posp").read_text() == (tmp_path / "b.posp").read_text()


# ----------------------- the JAX package's consensus tests, on the port

def test_port_kabsch_recovers_rigid_transform():
    rng = np.random.RandomState(0)
    p = rng.randn(20, 3).astype(np.float32)
    r_true = _rand_rot(rng)
    t_true = np.array([1.0, -2.0, 3.0], dtype=np.float32)
    r, t = kabsch(_t(p), _t(p @ r_true.T + t_true))
    np.testing.assert_allclose(r.numpy(), r_true, atol=1e-4)
    np.testing.assert_allclose(t.numpy(), t_true, atol=1e-4)
    assert float(aligned_rmsd(_t(p), _t(p @ r_true.T + t_true))) < 1e-4


def test_port_kmeans_gmm_dbscan_on_blobs():
    rng = np.random.RandomState(2)
    blobs = _blobs(rng, [[0, 0, 0], [5, 0, 0], [0, 5, 0]], 50, 0.2)
    gen = torch.Generator().manual_seed(0)
    res = cl.kmeans(_t(blobs), 3, generator=gen)
    np.testing.assert_allclose(np.sort(res.centers.numpy(), axis=0),
                               np.sort([[0, 0, 0], [5, 0, 0], [0, 5, 0]], axis=0), atol=0.3)
    two = _blobs(np.random.RandomState(3), [[0, 0, 0], [6, 0, 0]], 80, 0.3)
    g = cl.gmm_fit(_t(two), 2, iters=50, generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(np.sort(g.means.numpy()[:, 0]), [0, 6], atol=0.3)
    proba = cl.gmm_predict_proba(g, _t(two)).numpy()
    assert proba.shape == (160, 2)
    np.testing.assert_allclose(proba.sum(1), 1.0, atol=1e-4)
    pts = np.concatenate([_blobs(np.random.RandomState(4), [[0, 0, 0], [5, 5, 5]], 30, 0.1),
                          [[20.0, 20.0, 20.0]]]).astype(np.float32)
    labels = cl.dbscan(_t(pts), eps=1.0, min_samples=5).numpy()
    assert labels[-1] == -1
    assert len(set(labels[:30])) == 1 and len(set(labels[30:60])) == 1
    assert labels[0] != labels[30]


def test_port_consensus_pipeline_posp(tmp_path):
    rng = np.random.RandomState(5)
    data = {f"Molecule_{i}": {"Aromatic": [(rng.randn(3) * 0.3).tolist()],
                              "Acceptor": [(rng.randn(3) * 0.3 + [6, 0, 0]).tolist()]}
            for i in range(40)}
    p = tmp_path / "cloud.json"
    p.write_text(json.dumps(data))
    coords, fams = gp.load_point_cloud_json(p)
    assert coords.shape == (80, 3)
    cons = gp.consensus_gmm(coords, fams, n_clusters=2, seed=0, device=CPU)
    assert {t for t, _ in cons} == {"AROM", "HACC"}
    gp.write_consensus(tmp_path / "out.posp", cons)
    _, _, mask = load_phar_file(tmp_path / "out.posp")
    assert int(mask.sum()) == 2


def test_port_register_and_align_guards():
    rng = np.random.RandomState(0)
    with pytest.raises(ValueError, match="equal cloud sizes"):
        gp.register_clouds(rng.randn(20, 3), rng.randn(25, 3), mode="positional", device=CPU)
    with pytest.raises(ValueError, match="unknown registration mode"):
        gp.register_clouds(rng.randn(5, 3), rng.randn(5, 3), mode="svd", device=CPU)
    ref = rng.randn(10, 3).astype(np.float32)
    probe = (ref - ref.mean(0)) @ _rand_rot(rng) + ref.mean(0) + 1.0
    assert gp.align_pharmacophores(ref, probe, device=CPU)[0] < 1e-4
    with pytest.raises(ValueError):
        gp.align_pharmacophores(ref, probe[:5], device=CPU)
    c1, f1, c2, f2, _, _ = _two_target(5, n_per_site=10)
    with pytest.raises(ValueError, match="unknown dual-target method"):
        gp.dual_target_consensus(c1, f1, c2, f2, method="spectral", device=CPU)


def test_port_merge_clusters_rules():
    def info(center, top, probs=None):
        return {"center": np.asarray(center, np.float32),
                "probs": probs or {top: 0.9, "Donor": 0.1}, "top_family": top}

    merged = gp.merge_clusters([info([0, 0, 0], "Acceptor")],
                               [info([0.5, 0, 0], "Donor", {"Donor": 0.8, "Acceptor": 0.3})])
    assert len(merged) == 1
    np.testing.assert_allclose(merged[0]["center"], [0.25, 0, 0])
    assert merged[0]["probs"] == {"Acceptor": 0.9, "Donor": 0.8}
    # tolerant merge at 3 Å: the midpoint is 1.5 Å from both parents, so
    # both are appended again (the reference's quirk)
    merged = gp.merge_clusters([info([0, 0, 0], "Hydrophobe")],
                               [info([3.0, 0, 0], "Aromatic", {"Aromatic": 0.95})])
    assert len(merged) == 3 and merged[0]["top_family"] == "Aromatic"
    assert len(gp.merge_clusters([info([0, 0, 0], "Acceptor")],
                                 [info([3.0, 0, 0], "Donor")])) == 2
    assert len(gp.merge_clusters([info([0, 0, 0], "Acceptor")],
                                 [info([10.0, 0, 0], "Aromatic")])) == 2


def test_port_dual_target_modes_find_the_sites(tmp_path):
    c1, f1, c2, f2, _, _ = _two_target(3)
    cons = gp.dual_target_consensus_indiv(c1, f1, c2, f2, n_clusters=4, device=CPU)
    centers = np.stack([c for _, c in cons])
    assert np.sqrt(((SITES[:, None] - centers[None]) ** 2).sum(-1)).min(1).max() < 1.0
    gp.write_consensus(tmp_path / "indiv.posp", cons)
    assert len((tmp_path / "indiv.posp").read_text().strip().splitlines()) == len(cons)
    cons2, cons1 = gp.dual_target_consensus(c1, f1, c2, f2, method="dbscan", device=CPU)
    assert len(cons2) >= 3 and len(cons1) == len(cons2)
    centers = np.stack([c for _, c in cons2])
    assert np.sqrt(((centers[:, None] - SITES[None]) ** 2).sum(-1)).min(1).max() < 1.0


def test_port_dual_target_gmm_and_selectivity():
    rng = np.random.RandomState(6)
    shared = rng.randn(60, 3).astype(np.float32) * 0.3
    extra1 = rng.randn(25, 3).astype(np.float32) * 0.3 + np.array([8, 0, 0], np.float32)
    c1 = np.concatenate([shared, extra1])
    f1 = ["Aromatic"] * 60 + ["Donor"] * 25
    c2 = shared @ _rand_rot(rng).T + np.array([2.0, 1.0, -1.0], np.float32)
    cons2, cons1 = gp.dual_target_consensus(c1[:60], f1[:60], c2, ["Aromatic"] * 60,
                                            n_clusters=1, seed=0, device=CPU)
    assert cons2[0][0] == cons1[0][0] == "AROM"
    sel = gp.selective_consensus(c1, f1, shared, eps=1.0, min_samples=5, device=CPU)
    assert any(t == "HDON" for t, _ in sel)
    # ICP on unequal clouds lands cloud 1 on cloud 2
    c1, _, c2, _, _, _ = _two_target(1, n_per_site=20, noise=0.1)
    c1 = c1[rng.permutation(len(c1))[: 3 * len(c1) // 4]]
    moved, _, _ = gp.register_clouds(c1, c2, mode="icp", device=CPU)
    assert float(np.median(gp.nn_distances(moved, c2, device=CPU))) < 0.2
