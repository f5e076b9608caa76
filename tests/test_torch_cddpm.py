"""Sampling parity: the port's ConditionalDDPM and sample_pharmacophores
against the JAX package at f32, fed the JAX package's own noise draws
(split exactly as cddpm.py:604-620 and sample_phars.py:128 split them).

Tolerances: one reverse step and the reverse scalars agree to f32
rounding (atol 2e-5). A whole chain divides by alpha_ts at every step, so
f32 differences of the denoiser (~1e-6) grow along it; at T <= 10 the
stated tolerance is atol 2e-3 / rtol 1e-3 on coordinates, and the argmax
types must be equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmdgen_tpu.config import to_dict
from cmdgen_tpu.containers import PointCloud as JPointCloud
from cmdgen_tpu.containers import mask_from_sizes as jmask_from_sizes
from cmdgen_tpu.diffusion.cddpm import ConditionalDDPM as JConditionalDDPM
from cmdgen_tpu.diffusion.cddpm import DDPMConfig as JDDPMConfig
from cmdgen_tpu.models.dynamics import DynamicsConfig, EGNNDynamics
from cmdgen_tpu.models.egnn import EGNNConfig
from cmdgen_tpu.ops.schedules import gamma_table as jgamma_table
from cmdgen_tpu.pipeline.sample_phars import (
    sample_pharmacophores as jsample_pharmacophores,
)
from cmdgen_tpu.utils.synthetic import realistic_ca_pocket
from cmdgen_tpu_torch.config import from_dict
from cmdgen_tpu_torch.containers import PointCloud, mask_from_sizes
from cmdgen_tpu_torch.convert import load_flax_params
from cmdgen_tpu_torch.diffusion.cddpm import ConditionalDDPM, DDPMConfig
from cmdgen_tpu_torch.models.dynamics import DynamicsConfig as TDynamicsConfig
from cmdgen_tpu_torch.models.dynamics import EGNNDynamics as TEGNNDynamics
from cmdgen_tpu_torch.models.dynamics import make_fused_apply
from cmdgen_tpu_torch.ops import schedules as tsch
from cmdgen_tpu_torch.pipeline.sample_phars import sample_pharmacophores

torch.set_num_threads(1)

N_P, N_Q, RES_NF = 6, 20, 20


def _models(timesteps=10, clamp_x=None, ddim_eta=None, engine="msgpass"):
    cfg = DynamicsConfig(
        phar_nf=8, residue_nf=RES_NF, joint_nf=8, edge_cutoff=6.0,
        egnn=EGNNConfig(hidden_nf=32, n_layers=2, inv_sublayers=1, neighbor_k=10),
    )
    dcfg = JDDPMConfig(timesteps=timesteps, clamp_x=clamp_x, ddim_eta=ddim_eta)
    jdyn = EGNNDynamics(cfg)
    b = 2
    params = jdyn.init(jax.random.PRNGKey(4), jnp.zeros((b, N_P, 11)),
                       jnp.zeros((b, N_Q, 3 + RES_NF)), jnp.zeros((b, 1)),
                       jnp.ones((b, N_P)), jnp.ones((b, N_Q)))
    tdyn = TEGNNDynamics(from_dict(TDynamicsConfig, to_dict(cfg)))
    load_flax_params(tdyn, jax.tree_util.tree_map(np.asarray, params["params"]))
    tdyn.eval()
    apply_fn = make_fused_apply(tdyn) if engine == "fused" else None
    tmodel = ConditionalDDPM(from_dict(DDPMConfig, to_dict(dcfg)), tdyn,
                             apply_fn=apply_fn)
    return JConditionalDDPM(dcfg, jdyn), params, tmodel


def _pocket(b=2, seed=0):
    rng = np.random.RandomState(seed)
    x = np.stack([realistic_ca_pocket(rng, N_Q) for _ in range(b)])
    h = np.eye(RES_NF, dtype=np.float32)[rng.randint(0, RES_NF, (b, N_Q))]
    m = np.ones((b, N_Q), np.float32)
    m[1, -3:] = 0.0
    return x, h, m


def test_gamma_tables_equal_exactly():
    for sched, t in (("polynomial_2", 100), ("polynomial_2", 500), ("cosine", 50)):
        np.testing.assert_array_equal(
            tsch.gamma_table(sched, t, 1e-5).numpy(),
            np.asarray(jgamma_table(sched, t, 1e-5)))


@pytest.mark.parametrize("ddim_eta", [None, 0.0, 0.5, 1.0])
def test_reverse_scalars_match(ddim_eta):
    jmodel, params, tmodel = _models(timesteps=100, ddim_eta=ddim_eta)
    from cmdgen_tpu.diffusion.cddpm import respaced_st_pairs as jpairs
    from cmdgen_tpu_torch.diffusion.cddpm import respaced_st_pairs

    for steps in (100, 37):
        np.testing.assert_array_equal(respaced_st_pairs(100, steps).numpy(),
                                      np.asarray(jpairs(100, steps)))
        ref = jmodel._reverse_scalars(params, jpairs(100, steps))
        out = tmodel._reverse_scalars(respaced_st_pairs(100, steps))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("clamp_x", [None, 0.5])
def test_one_teacher_forced_reverse_step(clamp_x):
    jmodel, params, tmodel = _models(timesteps=10, clamp_x=clamp_x)
    rng = np.random.RandomState(1)
    px, ph, pm = _pocket()
    nn_ = np.array([N_P, N_P - 2])
    phar_mask = np.array(jmask_from_sizes(jnp.asarray(nn_), N_P))
    z = (rng.randn(2, N_P, 11) * phar_mask[..., None]).astype(np.float32)
    xh_pocket = np.concatenate([px, ph], -1).astype(np.float32)
    eps = rng.randn(2, N_P, 11).astype(np.float32)
    s, t = 6.0, 7.0
    ref_z, ref_q = jmodel._denoise_step(params, None, z, xh_pocket, s, t,
                                        phar_mask, pm, noise=eps)
    sc = tmodel._reverse_scalars(torch.tensor([[s, t]]))[0]
    with torch.no_grad():
        out_z, out_q = tmodel.reverse_step(
            torch.from_numpy(z), torch.from_numpy(xh_pocket), sc,
            torch.from_numpy(eps), torch.from_numpy(phar_mask), torch.from_numpy(pm))
    np.testing.assert_allclose(out_z.numpy(), np.asarray(ref_z), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out_q.numpy(), np.asarray(ref_q), atol=2e-5, rtol=2e-5)


def _jax_noise(rng, b, n_p, s_steps):
    k_init, k_scan, k_final = jax.random.split(rng, 3)
    shape = (b, n_p, 11)
    return tuple(torch.from_numpy(np.array(v)) for v in (
        jax.random.normal(k_init, shape),
        jax.random.normal(k_scan, (s_steps, *shape)),
        jax.random.normal(k_final, shape),
    ))


@pytest.mark.parametrize("engine,steps", [("msgpass", 10), ("msgpass", 4),
                                          ("fused", 10)])
def test_whole_chain_matches_jax_with_same_noise(engine, steps):
    jmodel, params, tmodel = _models(timesteps=10, engine=engine)
    px, ph, pm = _pocket()
    nn_ = np.array([N_P, N_P - 2])
    rng = jax.random.PRNGKey(11)
    jphar, jpocket = jmodel.sample_given_pocket(
        params, rng, JPointCloud(x=px, h=ph, mask=pm), jnp.asarray(nn_), N_P,
        timesteps=steps)
    tphar, tpocket = tmodel.sample_given_pocket(
        PointCloud(x=torch.from_numpy(px), h=torch.from_numpy(ph),
                   mask=torch.from_numpy(pm)),
        torch.from_numpy(nn_), N_P, timesteps=steps,
        noise=_jax_noise(rng, 2, N_P, steps))
    np.testing.assert_array_equal(tphar.mask.numpy(), np.asarray(jphar.mask))
    np.testing.assert_array_equal(tphar.h.numpy(), np.asarray(jphar.h))
    np.testing.assert_allclose(tphar.x.numpy(), np.asarray(jphar.x), atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(tpocket.x.numpy(), np.asarray(jpocket.x), atol=2e-3, rtol=1e-3)
    assert np.isfinite(tphar.x.numpy()).all()


def test_sample_pharmacophores_with_pad_bucket_matches_jax():
    jmodel, params, tmodel = _models(timesteps=10)
    rng = np.random.RandomState(2)
    coords = realistic_ca_pocket(rng, 17) + 5.0
    onehot = np.eye(RES_NF, dtype=np.float32)[rng.randint(0, RES_NF, 17)]
    seed = jax.random.PRNGKey(3)
    kwargs = dict(n_phar_max=N_P, batch_size=3, timesteps=6, pocket_pad_bucket=8)
    ref = jsample_pharmacophores(jmodel, params, seed, coords, onehot, 5, **kwargs)
    # the JAX stage splits (rng, k_size, k_samp) per batch of 3 and 2
    noise, key = [], seed
    for b in (3, 2):
        key, _, k_samp = jax.random.split(key, 3)
        noise.append(_jax_noise(k_samp, b, N_P, 6))
    out = sample_pharmacophores(tmodel, coords, onehot, 5, noise=noise, **kwargs)
    assert list(out) == list(ref) == [f"Molecule_{i}" for i in range(5)]
    for name in ref:
        assert set(out[name]) == set(ref[name]), name
        for fam in ref[name]:
            np.testing.assert_allclose(np.array(out[name][fam]),
                                       np.array(ref[name][fam]), atol=2e-3, rtol=1e-3)
