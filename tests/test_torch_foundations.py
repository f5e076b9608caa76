"""Foundations of the port against the JAX package: masked ops,
mask_from_sizes, the schedule algebra, the neighbor list and the PDB pocket
featurization, on the same numpy-seeded inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmdgen_tpu.chem import pdb as jpdb
from cmdgen_tpu.containers import mask_from_sizes as jmask_from_sizes
from cmdgen_tpu.models.egnn import build_neighbor_list as jbuild_neighbor_list
from cmdgen_tpu.ops import masked as jmasked
from cmdgen_tpu.ops import schedules as jsch
from cmdgen_tpu_torch.chem import pdb as tpdb
from cmdgen_tpu_torch.containers import PointCloud, mask_from_sizes
from cmdgen_tpu_torch.models.egnn import build_neighbor_list
from cmdgen_tpu_torch.ops import masked as tmasked
from cmdgen_tpu_torch.ops import schedules as tsch
from cmdgen_tpu_torch.utils.synthetic import synthetic_pocket_pdb

torch.set_num_threads(1)


def _clouds(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(3, 7, 3).astype(np.float32)
    y = rng.randn(3, 5, 3).astype(np.float32)
    ma = (np.arange(7)[None] < np.array([[7], [3], [0]])).astype(np.float32)
    mb = (np.arange(5)[None] < np.array([[5], [4], [2]])).astype(np.float32)
    return x, y, ma, mb


def test_mask_from_sizes_matches():
    sizes = np.array([0, 3, 8, 5])
    np.testing.assert_array_equal(
        mask_from_sizes(torch.from_numpy(sizes), 8).numpy(),
        np.asarray(jmask_from_sizes(jnp.asarray(sizes), 8)))


def test_masked_ops_match():
    x, y, ma, mb = _clouds()
    tx, ty, tma, tmb = (torch.from_numpy(v) for v in (x, y, ma, mb))
    np.testing.assert_allclose(tmasked.masked_mean(tx, tma).numpy(),
                               np.asarray(jmasked.masked_mean(x, ma)), atol=1e-6)
    np.testing.assert_allclose(tmasked.remove_mean(tx, tma).numpy(),
                               np.asarray(jmasked.remove_mean(x, ma)), atol=1e-6)
    for u, v in zip(tmasked.remove_mean_conditional(tx, ty, tma, tmb),
                    jmasked.remove_mean_conditional(x, y, ma, mb)):
        np.testing.assert_allclose(u.numpy(), np.asarray(v), atol=1e-6)
    np.testing.assert_array_equal(tmasked.pair_mask(tma, tmb).numpy(),
                                  np.asarray(jmasked.pair_mask(ma, mb)))
    # padding holds garbage: results must not see it
    tx2 = tx.clone()
    tx2[1, 3:] = 1e6
    np.testing.assert_allclose(tmasked.masked_mean(tx2, tma).numpy(),
                               tmasked.masked_mean(tx, tma).numpy())


def test_point_cloud_container():
    x, _, ma, _ = _clouds()
    h = np.random.RandomState(1).rand(3, 7, 4).astype(np.float32)
    pc = PointCloud(x=torch.from_numpy(x), h=torch.from_numpy(h), mask=torch.from_numpy(ma))
    assert pc.batch == 3 and pc.n_max == 7 and pc.n_features == 4
    np.testing.assert_array_equal(pc.size.numpy(), [7, 3, 0])
    assert torch.equal(pc.with_xh(pc.xh).x, pc.x)


def test_schedule_algebra_matches():
    g = jsch.gamma_table("polynomial_2", 100, 1e-5)
    tg = tsch.gamma_table("polynomial_2", 100, 1e-5)
    t = np.linspace(0, 1, 23).astype(np.float32)
    np.testing.assert_array_equal(tsch.gamma_at(tg, torch.from_numpy(t)).numpy(),
                                  np.asarray(jsch.gamma_at(g, t)))
    gs, gt = np.array(g[3:50]), np.array(g[4:51])
    for f in ("alpha", "sigma", "snr"):
        np.testing.assert_allclose(getattr(tsch, f)(torch.from_numpy(gt)).numpy(),
                                   np.asarray(getattr(jsch, f)(gt)), rtol=1e-6)
    for u, v in zip(tsch.sigma_and_alpha_t_given_s(torch.from_numpy(gt), torch.from_numpy(gs)),
                    jsch.sigma_and_alpha_t_given_s(gt, gs)):
        np.testing.assert_allclose(u.numpy(), np.asarray(v), rtol=2e-5, atol=1e-7)
    with pytest.raises(ValueError):
        tsch.gamma_table("linear", 10)


@pytest.mark.parametrize("k", [4, 12])
def test_neighbor_list_sets_match(k):
    """Tie-free gaussian geometry: the selected neighbor SETS agree (order
    within K may differ) and so do the validity masks."""
    rng = np.random.RandomState(2)
    b, n = 2, 12
    x = rng.randn(b, n, 3).astype(np.float32) * 2
    m = (np.arange(n)[None] < np.array([[n], [9]])).astype(np.float32)
    em = m[:, :, None] * m[:, None, :]
    d2 = ((x[:, :, None] - x[:, None]) ** 2).sum(-1)
    em = em * (d2 <= 9.0)
    _, jkm, jidx = jbuild_neighbor_list(jnp.asarray(x), jnp.asarray(em), k)
    tkm, tidx = build_neighbor_list(torch.from_numpy(x), torch.from_numpy(em), k)
    jkm, jidx = np.asarray(jkm), np.asarray(jidx)
    for bi in range(b):
        for i in range(n):
            want = set(jidx[bi, i][jkm[bi, i] > 0])
            got = set(tidx[bi, i].numpy()[tkm[bi, i].numpy() > 0])
            assert got == want, (bi, i)


@pytest.mark.parametrize("rep,selector", [("CA", {"ref_ligand": "L:1"}),
                                          ("full-atom", {"ref_ligand": "L:1"}),
                                          ("CA", {"resi_list": ["A:3", "A:7", "A:11"]})])
def test_featurize_pocket_matches(tmp_path, rep, selector):
    path = tmp_path / "pocket.pdb"
    path.write_text(synthetic_pocket_pdb(np.random.RandomState(5)))
    dataset = "crossdock" if rep == "CA" else "crossdock_full"
    outs = []
    for mod in (jpdb, tpdb):
        res = mod.parse_pdb(path)
        if "ref_ligand" in selector:
            lig = np.stack([a.coord for a in mod.ligand_atoms(res, selector["ref_ligand"])])
            pocket = mod.pocket_from_ligand(res, lig, 8.0)
        else:
            pocket = mod.pocket_by_ids(res, selector["resi_list"])
        outs.append(mod.featurize_pocket(pocket, rep, dataset))
    (jc, jh), (tc, th) = outs
    assert len(tc) > 0
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(th, jh)
