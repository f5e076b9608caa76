"""Joint model parity: the port's JointDDPM (``cmdgen_tpu_torch/diffusion/
joint.py``) and the joint branch of ``sample_pharmacophores`` against the
JAX package at f32, fed the JAX package's own draws (its key splits:
``k_init, k_scan, k_final = split(rng, 3)``; ``sample`` splits
``key, sub = split(key)`` per step, ``inpaint`` ``key, k1, k2 =
split(key, 3)`` per op, k1 for the denoise or renoise draw and k2 for the
known part's noise; each draw is ``_sample_joint_noise`` of its key).

Tolerance: atol 2e-4 / rtol 1e-4 on one step, on the noise projection and
on whole chains at T <= 8; argmax types equal. The JAX package's
``_sample_joint_noise`` draws x_p, x_q, h_p from ``split(rng, 3)`` and h_q
from ``fold_in(k3, 1)``. Both engines: msgpass (the module, K1 per GCL:
its plain version here) and fused (K2's plain version), every row moving.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmdgen_tpu.config import to_dict
from cmdgen_tpu.containers import PointCloud as JPointCloud
from cmdgen_tpu.containers import mask_from_sizes as jmask_from_sizes
from cmdgen_tpu.diffusion import joint as jjoint
from cmdgen_tpu.diffusion.cddpm import DDPMConfig as JDDPMConfig
from cmdgen_tpu.models.dynamics import DynamicsConfig, EGNNDynamics
from cmdgen_tpu.models.egnn import EGNNConfig
from cmdgen_tpu.pipeline.sample_phars import (
    sample_pharmacophores as jsample_pharmacophores,
)
from cmdgen_tpu.utils.synthetic import realistic_ca_pocket
from cmdgen_tpu_torch.config import from_dict
from cmdgen_tpu_torch.containers import PointCloud
from cmdgen_tpu_torch.convert import load_flax_params
from cmdgen_tpu_torch.diffusion import joint as tjoint
from cmdgen_tpu_torch.diffusion.cddpm import DDPMConfig
from cmdgen_tpu_torch.models.dynamics import DynamicsConfig as TDynamicsConfig
from cmdgen_tpu_torch.models.dynamics import EGNNDynamics as TEGNNDynamics
from cmdgen_tpu_torch.models.dynamics import make_fused_apply
from cmdgen_tpu_torch.pipeline.sample_phars import sample_pharmacophores

torch.set_num_threads(1)

TOL = dict(atol=2e-4, rtol=1e-4)
N_P, N_Q, RES_NF, T_MODEL = 6, 16, 20, 8
DCFG = DynamicsConfig(
    phar_nf=8, residue_nf=RES_NF, joint_nf=8, edge_cutoff=6.0, update_pocket_coords=True,
    egnn=EGNNConfig(hidden_nf=32, n_layers=2, inv_sublayers=1, neighbor_k=10),
)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def setup():
    """The JAX model and params; the port's dynamics with them loaded."""
    jdyn = EGNNDynamics(DCFG)
    b = 2
    params = jdyn.init(jax.random.PRNGKey(4), jnp.zeros((b, N_P, 11)),
                       jnp.zeros((b, N_Q, 3 + RES_NF)), jnp.zeros((b, 1)),
                       jnp.ones((b, N_P)), jnp.ones((b, N_Q)))
    tdyn = TEGNNDynamics(from_dict(TDynamicsConfig, to_dict(DCFG)))
    load_flax_params(tdyn, jax.tree_util.tree_map(np.asarray, params["params"]))
    return jdyn, params, tdyn.eval()


def _models(setup, engine="msgpass", ddim_eta=None):
    jdyn, params, tdyn = setup
    dcfg = JDDPMConfig(timesteps=T_MODEL, ddim_eta=ddim_eta)
    apply_fn = make_fused_apply(tdyn) if engine == "fused" else None
    tmodel = tjoint.JointDDPM(from_dict(DDPMConfig, to_dict(dcfg)), tdyn, apply_fn=apply_fn)
    return jjoint.JointDDPM(dcfg, jdyn), params, tmodel


def _clouds(seed=0):
    """Two complexes, the second with padded rows in both clouds."""
    rng = np.random.RandomState(seed)
    mp = np.array(jmask_from_sizes(jnp.asarray([N_P, N_P - 2]), N_P))
    mq = np.array(jmask_from_sizes(jnp.asarray([N_Q, N_Q - 3]), N_Q))
    xq = np.stack([realistic_ca_pocket(rng, N_Q) for _ in range(2)]).astype(np.float32)
    xp = (xq[:, :N_P] + rng.randn(2, N_P, 3)).astype(np.float32)
    hp = np.eye(8, dtype=np.float32)[rng.randint(0, 8, (2, N_P))] * mp[..., None]
    hq = np.eye(RES_NF, dtype=np.float32)[rng.randint(0, RES_NF, (2, N_Q))] * mq[..., None]
    return xp * mp[..., None], hp, mp, xq * mq[..., None], hq, mq


def _pair(jmodel, key, mp, mq):
    return tuple(_t(v) for v in jmodel._sample_joint_noise(key, jnp.asarray(mp), jnp.asarray(mq)))


def _sample_draws(jmodel, rng, mp, mq, steps):
    k_init, k_scan, k_final = jax.random.split(rng, 3)
    chain, key = [], k_scan
    for _ in range(steps):
        key, sub = jax.random.split(key)
        chain.append((_pair(jmodel, sub, mp, mq),))
    return _pair(jmodel, k_init, mp, mq), chain, _pair(jmodel, k_final, mp, mq)


def _inpaint_draws(jmodel, rng, mp, mq, resamplings, jump_length, timesteps):
    kinds, _ = jjoint.repaint_ops(resamplings, jump_length, timesteps)
    k_init, k_scan, k_final = jax.random.split(rng, 3)
    ops, key = [], k_scan
    for kind in kinds:
        key, k1, k2 = jax.random.split(key, 3)
        pair1 = _pair(jmodel, k1, mp, mq)
        ops.append((pair1, _pair(jmodel, k2, mp, mq)) if kind == 0 else (pair1,))
    return _pair(jmodel, k_init, mp, mq), ops, _pair(jmodel, k_final, mp, mq)


@pytest.mark.parametrize("resamplings,jump_length,timesteps",
                         [(1, 1, 10), (3, 2, 10), (2, 1, 8), (2, 3, 20), (5, 1, 3)])
def test_repaint_schedule_and_ops_equal(resamplings, jump_length, timesteps):
    assert (tjoint.get_repaint_schedule(resamplings, jump_length, timesteps)
            == jjoint.get_repaint_schedule(resamplings, jump_length, timesteps))
    for out, ref in zip(tjoint.repaint_ops(resamplings, jump_length, timesteps),
                        jjoint.repaint_ops(resamplings, jump_length, timesteps)):
        np.testing.assert_array_equal(out, ref)


def test_joint_noise_projection(setup):
    jmodel, _, tmodel = _models(setup)
    _, _, mp, _, _, mq = _clouds()
    key = jax.random.PRNGKey(5)
    k1, k2, k3 = jax.random.split(key, 3)
    raw = [jax.random.normal(k1, (2, N_P, 3)), jax.random.normal(k2, (2, N_Q, 3)),
           jax.random.normal(k3, (2, N_P, 8)),
           jax.random.normal(jax.random.fold_in(k3, 1), (2, N_Q, RES_NF))]
    out = tmodel.project_joint_noise(*map(_t, raw), _t(mp), _t(mq))
    ref = _pair(jmodel, key, mp, mq)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), r.numpy(), atol=1e-6, rtol=1e-6)
    # the combined cloud's x is CoM-free; padded rows are zero
    com = out[0][..., :3].sum(1) + out[1][..., :3].sum(1)
    np.testing.assert_allclose(com.numpy(), 0.0, atol=1e-5)
    assert (out[0][1, -2:] == 0).all() and (out[1][1, -3:] == 0).all()


@pytest.mark.parametrize("ddim_eta", [None, 0.0])
def test_one_denoise_and_one_renoise_step(setup, ddim_eta):
    jmodel, params, tmodel = _models(setup, ddim_eta=ddim_eta)
    xp, hp, mp, xq, hq, mq = _clouds(1)
    z_p = np.concatenate([xp, hp], -1)
    z_q = np.concatenate([xq, hq], -1)
    noise = _pair(jmodel, jax.random.PRNGKey(6), mp, mq)
    jn = tuple(jnp.asarray(v.numpy()) for v in noise)
    for step in ("_denoise_step", "_renoise_step"):
        s, t = (4.0, 5.0) if step == "_denoise_step" else (3.0, 5.0)
        ref = getattr(jmodel, step)(params, None, z_p, z_q, s, t, mp, mq, noise=jn)
        with torch.no_grad():
            out = getattr(tmodel, step)(_t(z_p), _t(z_q), s, t, _t(mp), _t(mq), noise=noise)
        for o, r in zip(out, ref):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)


def _check_clouds(out, ref):
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.mask.numpy(), np.asarray(r.mask))
        np.testing.assert_array_equal(o.h.numpy(), np.asarray(r.h))
        np.testing.assert_allclose(o.x.numpy(), np.asarray(r.x), **TOL)
        assert np.isfinite(o.x.numpy()).all()


@pytest.mark.parametrize("engine", ["msgpass", "fused"])
def test_sample_chain_matches_jax(setup, engine):
    jmodel, params, tmodel = _models(setup, engine)
    nn_p, nn_q = np.array([N_P, N_P - 2]), np.array([N_Q, N_Q - 3])
    rng = jax.random.PRNGKey(11)
    steps = 5  # a respaced chain of 5 of the model's 8 steps
    ref = jmodel.sample(params, rng, jnp.asarray(nn_p), jnp.asarray(nn_q), N_P, N_Q,
                        timesteps=steps)
    _, _, mp, _, _, mq = _clouds()
    out = tmodel.sample(_t(nn_p), _t(nn_q), N_P, N_Q, timesteps=steps,
                        noise=_sample_draws(jmodel, rng, mp, mq, steps))
    _check_clouds(out, ref)


@pytest.mark.parametrize("engine,resamplings,timesteps",
                         [("msgpass", 1, None), ("msgpass", 2, 5), ("fused", 2, 5)])
def test_inpaint_chain_matches_jax(setup, engine, resamplings, timesteps):
    """RePaint with the pocket fixed; at resamplings 2 the chain takes
    renoise jumps. timesteps 5 < T = 8 reads gamma at s / 8 (the JAX
    package's behaviour, reproduced)."""
    jmodel, params, tmodel = _models(setup, engine)
    xp, hp, mp, xq, hq, mq = _clouds(2)
    rng = jax.random.PRNGKey(12)
    kw = dict(resamplings=resamplings, jump_length=1, timesteps=timesteps)
    ref = jmodel.inpaint(params, rng, JPointCloud(x=xp, h=hp, mask=mp),
                         JPointCloud(x=xq, h=hq, mask=mq), jnp.zeros_like(mp),
                         jnp.ones_like(mq), **kw)
    kinds, _ = jjoint.repaint_ops(resamplings, 1, timesteps or T_MODEL)
    assert (kinds == 1).any() == (resamplings > 1)
    out = tmodel.inpaint(
        PointCloud(x=_t(xp), h=_t(hp), mask=_t(mp)), PointCloud(x=_t(xq), h=_t(hq), mask=_t(mq)),
        torch.zeros(2, N_P), torch.ones(2, N_Q),
        noise=_inpaint_draws(jmodel, rng, mp, mq, resamplings, 1, timesteps or T_MODEL), **kw)
    _check_clouds(out, ref)


@pytest.mark.parametrize("engine", ["msgpass", "fused"])
def test_sample_pharmacophores_joint_branch_with_pad_bucket(setup, engine):
    jmodel, params, tmodel = _models(setup, engine)
    rng = np.random.RandomState(3)
    n_atoms = 13
    coords = (realistic_ca_pocket(rng, n_atoms) + 5.0).astype(np.float32)
    onehot = np.eye(RES_NF, dtype=np.float32)[rng.randint(0, RES_NF, n_atoms)]
    seed = jax.random.PRNGKey(3)
    kwargs = dict(n_phar_max=N_P, batch_size=3, timesteps=4, pocket_pad_bucket=8)
    ref = jsample_pharmacophores(jmodel, params, seed, coords, onehot, 5, **kwargs)
    # the JAX stage splits (rng, k_size, k_samp) per batch of 3 and 2; the
    # pocket is padded to 16 rows, the pharmacophore has 5 of 6 nodes
    noise, key = [], seed
    for b in (3, 2):
        key, _, k_samp = jax.random.split(key, 3)
        mp = np.array(jmask_from_sizes(jnp.full((b,), 5), N_P))
        mq = np.broadcast_to((np.arange(16) < n_atoms).astype(np.float32), (b, 16))
        noise.append(_inpaint_draws(jmodel, k_samp, mp, mq, 1, 1, 4))
    out = sample_pharmacophores(tmodel, coords, onehot, 5, noise=noise, **kwargs)
    assert list(out) == list(ref) == [f"Molecule_{i}" for i in range(5)]
    for name in ref:
        assert set(out[name]) == set(ref[name]), name
        for fam in ref[name]:
            np.testing.assert_allclose(np.array(out[name][fam]), np.array(ref[name][fam]),
                                       atol=2e-4, rtol=1e-4)


def test_generator_draws_and_joint_invariants(setup):
    """With a generator (no given draws): the inpainted pocket keeps its
    types and its shape up to a translation, every sample is finite, and
    the same seed gives the same sample."""
    _, _, tmodel = _models(setup)
    xp, hp, mp, xq, hq, mq = _clouds(4)
    args = (PointCloud(x=_t(xp), h=_t(hp), mask=_t(mp)),
            PointCloud(x=_t(xq), h=_t(hq), mask=_t(mq)), torch.zeros(2, N_P), torch.ones(2, N_Q))
    runs = [tmodel.inpaint(*args, timesteps=4, generator=torch.Generator().manual_seed(9))
            for _ in range(2)]
    for a, b in zip(*runs):
        torch.testing.assert_close(a.x, b.x, rtol=0, atol=0)
    phar, pocket = runs[0]
    assert torch.isfinite(phar.x).all() and torch.isfinite(pocket.x).all()
    torch.testing.assert_close(pocket.h, torch.from_numpy(hq))
    # the pocket comes back as given (to the noise of the last splice,
    # sigma_0 ~ 1e-2 at this schedule), translated
    moved = pocket.x - torch.from_numpy(xq)
    spread = (moved - moved[:, :1]) * torch.from_numpy(mq)[..., None]
    assert spread.abs().max() < 0.1
    # sampling with a model whose dynamics keep the pocket fixed is refused
    cond = TEGNNDynamics(dataclasses.replace(from_dict(TDynamicsConfig, to_dict(DCFG)),
                                             update_pocket_coords=False))
    with pytest.raises(ValueError, match="update_pocket_coords"):
        tjoint.JointDDPM(DDPMConfig(timesteps=T_MODEL), cond)
