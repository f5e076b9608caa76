"""Stage 1's remaining sampling options in the port against the JAX package
on the CPU at f32: the size prior, the learned noise schedule
(``GammaNetwork``), ``sin_embedding``, the plain-GNN dynamics mode and the
chain sampler with its GIF renderer.

Tolerances: atol 2e-4 / rtol 1e-4 for single evaluations; a whole chain
divides by alpha_ts at every step, so at T <= 10 coordinates are held at
atol 2e-3 / rtol 1e-3 and argmax types exactly, as in
``tests/test_torch_cddpm.py`` (whose ``_jax_noise`` split is reused). Size
prior draws: within 0.01 of the table's probabilities over 20,000 draws.
``torch.nn.functional.softplus`` is linear above 20 and ``jax.nn.softplus``
is not; they differ there by log1p(exp(-x)) < 2.1e-9, below float32
resolution at 20. The gamma network's own float32 arithmetic is
ill-conditioned: its endpoint normalisation subtracts values near 65 that
differ by about 1 and scales the difference by gamma_1 - gamma_0 ~ 15, so
rounding alone moves the JAX package's float32 gamma by up to 8e-4 from
its float64 value on random inits. So the port's module is held against a
float64 evaluation of the same algebra at 1e-9, and its float32 gamma
against the JAX package's at atol 1e-3 (``GAMMA_TOL``)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmdgen_tpu.config import DataConfig, DiffPharConfig, to_dict
from cmdgen_tpu.containers import PointCloud as JPointCloud
from cmdgen_tpu.containers import mask_from_sizes as jmask_from_sizes
from cmdgen_tpu.diffusion.cddpm import ConditionalDDPM as JConditionalDDPM
from cmdgen_tpu.diffusion.cddpm import DDPMConfig
from cmdgen_tpu.diffusion.cddpm import sample_chain_given_pocket as jsample_chain
from cmdgen_tpu.diffusion.gamma_net import GammaNetwork as JGammaNetwork
from cmdgen_tpu.diffusion.size_prior import SizePrior as JSizePrior
from cmdgen_tpu.diffusion.size_prior import smoothed_size_histogram as jsmoothed
from cmdgen_tpu.models.dynamics import DynamicsConfig, EGNNDynamics
from cmdgen_tpu.models.egnn import EGNN, EGNNConfig
from cmdgen_tpu.models.egnn import sinusoids_embedding as jsinusoids
from cmdgen_tpu.ops.masked import pair_mask
from cmdgen_tpu_torch import models
from cmdgen_tpu_torch.config import DiffPharConfig as TDiffPharConfig
from cmdgen_tpu_torch.config import from_dict
from cmdgen_tpu_torch.containers import PointCloud
from cmdgen_tpu_torch.convert import build_model, dynamics_state_dict, load_flax_params
from cmdgen_tpu_torch.diffusion.gamma_net import GammaNetwork
from cmdgen_tpu_torch.diffusion.size_prior import SizePrior, smoothed_size_histogram
from cmdgen_tpu_torch.models.egnn import EGNN as TEGNN
from cmdgen_tpu_torch.models.egnn import EGNNConfig as TEGNNConfig
from cmdgen_tpu_torch.models.egnn import sinusoids_embedding
from cmdgen_tpu_torch.pipeline.sample_phars import sample_pharmacophores
from cmdgen_tpu_torch.utils.synthetic import realistic_ca_pocket
from cmdgen_tpu_torch.utils.visualization import render_chain, render_chain_for_pocket
from test_torch_cddpm import _jax_noise

torch.set_num_threads(1)

TOL = dict(atol=2e-4, rtol=1e-4)
CHAIN_TOL = dict(atol=2e-3, rtol=1e-3)
GAMMA_TOL = dict(atol=1e-3, rtol=0)
N_P, N_Q, RES_NF = 6, 20, 20


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _config(egnn=None, mode="egnn_dynamics", timesteps=10, schedule="polynomial_2",
            **ddpm_kw):
    egnn = egnn or EGNNConfig(hidden_nf=16, n_layers=1, neighbor_k=10)
    loss = "vlb" if schedule == "learned" else "l2"
    return DiffPharConfig(
        data=DataConfig(dataset="crossdock", pocket_representation="CA"),
        dynamics=DynamicsConfig(phar_nf=8, residue_nf=RES_NF, joint_nf=8, edge_cutoff=6.0,
                                mode=mode, egnn=egnn),
        ddpm=DDPMConfig(timesteps=timesteps, noise_schedule=schedule, loss_type=loss,
                        **ddpm_kw))


@functools.lru_cache(maxsize=None)
def _dynamics_params(dynamics_cfg, seed):
    """The flax dynamics' initial variables, initialised once per
    configuration and seed."""
    b = 2
    return EGNNDynamics(dynamics_cfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((b, N_P, 11)), jnp.zeros((b, N_Q, 3 + RES_NF)),
        jnp.zeros((b, 1)), jnp.ones((b, N_P)), jnp.ones((b, N_Q)))


def _pair(*args, size_histogram=None, seed=4, **kwargs):
    """(JAX model, its params, the port's model from ``build_model``) for
    one small DiffPhar configuration (``_config``); params hold the gamma
    network's subtree for the learned schedule."""
    cfg = _config(*args, **kwargs)
    schedule = cfg.ddpm.noise_schedule
    prior = None if size_histogram is None else JSizePrior(size_histogram)
    jmodel = JConditionalDDPM(cfg.ddpm, EGNNDynamics(cfg.dynamics), prior)
    params = _dynamics_params(cfg.dynamics, seed)
    params = jmodel.init_extra_params(jax.random.PRNGKey(seed + 1), params)
    if schedule == "learned":  # move the endpoints off their initial values
        gp = dict(params["params"]["gamma_net"])
        gp["gamma_0"], gp["gamma_1"] = jnp.asarray([-6.5]), jnp.asarray([9.0])
        params = {"params": {**params["params"], "gamma_net": gp}}
    tcfg = from_dict(TDiffPharConfig, to_dict(cfg))
    tmodel = build_model(tcfg, _np(params["params"]), "cpu", size_histogram=size_histogram)
    return jmodel, params, tmodel


def _pocket(b=2, seed=0):
    rng = np.random.RandomState(seed)
    x = np.stack([realistic_ca_pocket(rng, N_Q) for _ in range(b)])
    h = np.eye(RES_NF, dtype=np.float32)[rng.randint(0, RES_NF, (b, N_Q))]
    m = np.ones((b, N_Q), np.float32)
    m[1, -3:] = 0.0
    return x, h, m


def _histogram():
    rng = np.random.RandomState(0)
    n2 = rng.randint(10, 40, 500)
    n1 = np.clip(n2 // 5 + rng.randint(-2, 3, 500), 1, None)
    return smoothed_size_histogram(n1, n2)


# -------------------------------------------------------------- size prior

def test_size_prior_tables_equal_jax():
    rng = np.random.RandomState(0)
    n2 = rng.randint(10, 40, 500)
    n1 = np.clip(n2 // 5 + rng.randint(-2, 3, 500), 1, None)
    hist = smoothed_size_histogram(n1, n2)
    np.testing.assert_array_equal(hist, jsmoothed(n1, n2))
    prior, jprior = SizePrior(hist, "cpu"), JSizePrior(hist)
    for name in ("prob", "log_prob_joint", "log_prob_n1_g_n2", "log_prob_n2_g_n1"):
        np.testing.assert_array_equal(getattr(prior, name).numpy(),
                                      np.asarray(getattr(jprior, name)), err_msg=name)
    assert (prior.n1_max, prior.n2_max) == (jprior.n1_max, jprior.n2_max)
    q1, q2 = np.array([0, 3, 7, 50, -1]), np.array([12, 0, 33, 20, 99])
    np.testing.assert_array_equal(prior.log_prob(torch.tensor(q1), torch.tensor(q2)).numpy(),
                                  np.asarray(jprior.log_prob(jnp.asarray(q1), jnp.asarray(q2))))
    np.testing.assert_array_equal(
        prior.log_prob_n1_given_n2(torch.tensor(q1), torch.tensor(q2)).numpy(),
        np.asarray(jprior.log_prob_n1_given_n2(jnp.asarray(q1), jnp.asarray(q2))))


def test_size_prior_draws_follow_the_tables():
    prior = SizePrior(_histogram(), "cpu")
    gen = torch.Generator().manual_seed(0)
    for n2 in (12, 30):
        draws = prior.sample_conditional_n1(torch.full((20000,), n2), gen).numpy()
        freq = np.bincount(draws, minlength=prior.n1_max + 1) / draws.size
        want = np.exp(prior.log_prob_n1_g_n2[:, n2].numpy())
        assert np.abs(freq - want).max() < 0.01, (n2, np.abs(freq - want).max())
    n1, n2 = prior.sample(20000, gen)
    freq = np.zeros(prior.prob.shape)
    np.add.at(freq, (n1.numpy(), n2.numpy()), 1.0 / 20000)
    assert np.abs(freq - prior.prob.numpy()).max() < 0.01


def test_sample_pharmacophores_draws_node_counts_from_the_size_prior():
    """A prior that puts all but ~1e-6 of p(n1 | n2) on n1 = 3: the stage
    draws 3 nodes per cloud, and with the same noise gives the clouds it
    gives for explicit counts of 3."""
    hist = np.zeros((8, N_Q + 1))
    hist[3] = 1000.0
    _, _, tmodel = _pair(size_histogram=hist)
    rng = np.random.RandomState(2)
    coords = realistic_ca_pocket(rng, N_Q) + 5.0
    onehot = np.eye(RES_NF, dtype=np.float32)[rng.randint(0, RES_NF, N_Q)]
    noise = [tuple(torch.randn(shape, generator=torch.Generator().manual_seed(i))
                   for i, shape in enumerate(((3, N_P, 11), (4, 3, N_P, 11), (3, N_P, 11))))]
    kwargs = dict(n_phar_max=N_P, batch_size=3, timesteps=4, noise=noise)
    out = sample_pharmacophores(tmodel, coords, onehot, 3,
                                generator=torch.Generator().manual_seed(0), **kwargs)
    ref = sample_pharmacophores(tmodel, coords, onehot, 3, num_nodes=np.full(3, 3), **kwargs)
    assert out == ref
    assert all(sum(len(v) for v in mol.values()) == 3 for mol in out.values())
    tmodel.size_prior = None  # without a prior: 5 nodes
    out = sample_pharmacophores(tmodel, coords, onehot, 3, **kwargs)
    assert all(sum(len(v) for v in mol.values()) == 5 for mol in out.values())


# --------------------------------------------------------- learned schedule

def test_gamma_network_matches_flax():
    net = JGammaNetwork()
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 1)))["params"]
    params = {**params, "gamma_0": jnp.asarray([-4.0]), "gamma_1": jnp.asarray([11.5])}
    port = GammaNetwork()
    load_flax_params(port, _np(params), scalars=("gamma_0", "gamma_1"))
    t = np.linspace(0.0, 1.0, 101, dtype=np.float32)[:, None]
    ref = np.asarray(net.apply({"params": params}, jnp.asarray(t)))
    with torch.no_grad():
        out = port(torch.from_numpy(t)).numpy()
        out64 = port.double()(torch.from_numpy(t).double()).numpy()
    np.testing.assert_allclose(out, ref, **GAMMA_TOL)
    assert np.all(np.diff(out[:, 0]) >= -1e-6)
    np.testing.assert_allclose(out[[0, -1], 0], [-4.0, 11.5], atol=1e-4)

    def softplus(a):  # the flax kernels, [in, out], in float64
        return np.logaddexp(np.asarray(a, np.float64) - 2.0, 0.0)

    def gamma_tilde(u):
        p = {k: (softplus(params[k]["kernel"]), np.asarray(params[k]["bias"], np.float64))
             for k in ("l1", "l2", "l3")}
        l1 = u @ p["l1"][0] + p["l1"][1]
        return l1 + 1 / (1 + np.exp(-(l1 @ p["l2"][0] + p["l2"][1]))) @ p["l3"][0] + p["l3"][1]

    t64 = t.astype(np.float64)
    g0, g1 = gamma_tilde(np.zeros_like(t64)), gamma_tilde(np.ones_like(t64))
    np.testing.assert_allclose(out64, -4.0 + 15.5 * (gamma_tilde(t64) - g0) / (g1 - g0),
                               atol=1e-9, rtol=0)


def test_learned_schedule_gamma_and_reverse_step_match_jax():
    jmodel, params, tmodel = _pair(schedule="learned")
    assert tmodel.gamma is None and tmodel.gamma_net is not None
    t = np.linspace(0.0, 1.0, 101, dtype=np.float32)
    np.testing.assert_allclose(tmodel._gamma_t_norm(torch.from_numpy(t)).detach().numpy(),
                               np.asarray(jmodel._gamma_t_norm(params, jnp.asarray(t))),
                               **GAMMA_TOL)
    rng = np.random.RandomState(1)
    px, ph, pm = _pocket()
    phar_mask = np.array(jmask_from_sizes(jnp.asarray([N_P, N_P - 2]), N_P))
    z = (rng.randn(2, N_P, 11) * phar_mask[..., None]).astype(np.float32)
    xh_pocket = np.concatenate([px, ph], -1).astype(np.float32)
    eps = rng.randn(2, N_P, 11).astype(np.float32)
    ref_z, ref_q = jmodel._denoise_step(params, None, z, xh_pocket, 6.0, 7.0, phar_mask, pm,
                                        noise=eps)
    sc = tmodel._reverse_scalars(torch.tensor([[6.0, 7.0]]))[0]
    with torch.no_grad():
        out_z, out_q = tmodel.reverse_step(
            torch.from_numpy(z), torch.from_numpy(xh_pocket), sc, torch.from_numpy(eps),
            torch.from_numpy(phar_mask), torch.from_numpy(pm))
    np.testing.assert_allclose(out_z.numpy(), np.asarray(ref_z), **TOL)
    np.testing.assert_allclose(out_q.numpy(), np.asarray(ref_q), **TOL)


def test_check_norm_values_as_jax():
    for norm_h, schedule in ((4.0, "polynomial_2"), (100.0, "polynomial_2"),
                             (100.0, "learned")):
        jmodel, params, tmodel = _pair(schedule=schedule)
        jmodel.cfg = dataclasses.replace(jmodel.cfg, norm_h=norm_h)
        tmodel.cfg = dataclasses.replace(tmodel.cfg, norm_h=norm_h)
        try:
            jmodel.check_norm_values(params)
        except ValueError:
            with pytest.raises(ValueError, match="too large"):
                tmodel.check_norm_values()
        else:
            tmodel.check_norm_values()
    # a fixed schedule refuses a checkpoint that carries a gamma network
    _, params, _ = _pair(schedule="learned")
    with pytest.raises(KeyError, match="gamma_net"):
        build_model(from_dict(TDiffPharConfig, to_dict(_config())), _np(params["params"]), "cpu")


# -------------------------------------------- sin_embedding and the GNN mode

def test_sinusoids_embedding_values():
    d2 = np.concatenate([[0.0], np.random.RandomState(0).rand(49) * 40]).astype(np.float32)
    out = sinusoids_embedding(torch.from_numpy(d2[:, None])).numpy()
    assert out.shape == (50, 12)
    np.testing.assert_allclose(out, np.asarray(jsinusoids(jnp.asarray(d2[:, None]))), **TOL)


@pytest.mark.parametrize("neighbor_k", [None, 12])
def test_egnn_with_sin_embedding_matches_flax(neighbor_k, monkeypatch):
    """Both engines; the 24 edge features keep every GCL off K1's path, as
    the JAX package keeps them off its Pallas kernel."""
    cfg = EGNNConfig(hidden_nf=16, n_layers=2, sin_embedding=True, neighbor_k=neighbor_k)
    rng = np.random.RandomState(1)
    b, n, d = 2, 12, 6
    h = rng.randn(b, n, d).astype(np.float32)
    x = (rng.randn(b, n, 3) * 1.5).astype(np.float32)
    mask = (np.arange(n)[None, :] < np.array([8, 12])[:, None]).astype(np.float32)
    em = np.asarray(pair_mask(mask, mask))
    ucm = mask * (np.arange(n) < 5)
    params = EGNN(cfg, out_node_nf=d).init(jax.random.PRNGKey(0), h, x, em, mask, ucm, 5)
    ref = EGNN(cfg, out_node_nf=d).apply(params, h, x, em, mask, ucm, 5)
    egnn = TEGNN(from_dict(TEGNNConfig, to_dict(cfg)), d, d)
    egnn.load_state_dict(dynamics_state_dict(_np(params["params"])))

    def k1_refused(*args, **kwargs):
        raise AssertionError("a GCL with 24 edge features reached K1")

    monkeypatch.setattr(models.egnn, "gcl_message_agg", k1_refused)
    with torch.no_grad():
        out = egnn.eval()(*[torch.from_numpy(a) for a in (h, x, em, mask, ucm)], 5)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("condition_time", [True, False])
def test_gnn_dynamics_matches_flax(condition_time):
    cfg = DynamicsConfig(phar_nf=8, residue_nf=RES_NF, joint_nf=8, edge_cutoff=6.0,
                         mode="gnn_dynamics", condition_time=condition_time,
                         egnn=EGNNConfig(hidden_nf=32, n_layers=2, neighbor_k=10))
    rng = np.random.RandomState(3)
    px, ph, pm = _pocket()
    phar_mask = np.array(jmask_from_sizes(jnp.asarray([N_P, N_P - 2]), N_P))
    xh_p = np.concatenate([rng.randn(2, N_P, 3) + px.mean(1, keepdims=True),
                           np.eye(8)[rng.randint(0, 8, (2, N_P))]], -1).astype(np.float32)
    xh_p *= phar_mask[..., None]
    args = (xh_p, np.concatenate([px, ph], -1).astype(np.float32),
            rng.rand(2, 1).astype(np.float32), phar_mask, pm)
    params = EGNNDynamics(cfg).init(jax.random.PRNGKey(0), *args)
    ref = EGNNDynamics(cfg).apply(params, *args)
    from cmdgen_tpu_torch.models.dynamics import DynamicsConfig as TDynamicsConfig
    from cmdgen_tpu_torch.models.dynamics import EGNNDynamics as TEGNNDynamics

    dyn = TEGNNDynamics(from_dict(TDynamicsConfig, to_dict(cfg)))
    load_flax_params(dyn, _np(params["params"]))
    with torch.no_grad():
        out = dyn.eval()(*[torch.from_numpy(a) for a in args])
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("option", ["sin_embedding", "gnn_dynamics", "learned"])
def test_whole_chain_with_option_matches_jax(option):
    egnn = EGNNConfig(hidden_nf=16, n_layers=1, neighbor_k=10,
                      sin_embedding=option == "sin_embedding")
    jmodel, params, tmodel = _pair(
        egnn=egnn, mode="gnn_dynamics" if option == "gnn_dynamics" else "egnn_dynamics",
        schedule="learned" if option == "learned" else "polynomial_2")
    px, ph, pm = _pocket()
    nn_ = np.array([N_P, N_P - 2])
    rng = jax.random.PRNGKey(11)
    jphar, jpocket = jmodel.sample_given_pocket(
        params, rng, JPointCloud(x=px, h=ph, mask=pm), jnp.asarray(nn_), N_P, timesteps=6)
    tphar, tpocket = tmodel.sample_given_pocket(
        PointCloud(x=torch.from_numpy(px), h=torch.from_numpy(ph), mask=torch.from_numpy(pm)),
        torch.from_numpy(nn_), N_P, timesteps=6, noise=_jax_noise(rng, 2, N_P, 6))
    np.testing.assert_array_equal(tphar.h.numpy(), np.asarray(jphar.h))
    np.testing.assert_allclose(tphar.x.numpy(), np.asarray(jphar.x), **CHAIN_TOL)
    np.testing.assert_allclose(tpocket.x.numpy(), np.asarray(jpocket.x), **CHAIN_TOL)


# ------------------------------------------------------ chain and rendering

def _chain_noise(rng, b, n_p, steps):
    """The draws of the JAX package's sample_chain_given_pocket: one key
    split per reverse step from k_scan (cddpm.py:703-711)."""
    k_init, k_scan, k_final = jax.random.split(rng, 3)
    shape = (b, n_p, 11)
    chain, key = [], k_scan
    for _ in range(steps):
        key, sub = jax.random.split(key)
        chain.append(jax.random.normal(sub, shape))
    return tuple(torch.from_numpy(np.array(v)) for v in (
        jax.random.normal(k_init, shape), jnp.stack(chain), jax.random.normal(k_final, shape)))


@pytest.mark.parametrize("steps,keep_frames", [(10, 100), (10, 3), (6, 2)])
def test_sample_chain_matches_jax(steps, keep_frames):
    jmodel, params, tmodel = _pair()
    px, ph, pm = _pocket()
    nn_ = np.array([N_P, N_P - 2])
    rng = jax.random.PRNGKey(5)
    jphar, jpocket, jframes = jsample_chain(
        jmodel, params, rng, JPointCloud(x=px, h=ph, mask=pm), jnp.asarray(nn_), N_P,
        keep_frames=keep_frames, timesteps=steps)
    pocket = PointCloud(x=torch.from_numpy(px), h=torch.from_numpy(ph),
                        mask=torch.from_numpy(pm))
    noise = _chain_noise(rng, 2, N_P, steps)
    tphar, tpocket, frames = tmodel.sample_chain_given_pocket(
        pocket, torch.from_numpy(nn_), N_P, keep_frames=keep_frames, timesteps=steps,
        noise=noise)
    assert frames.shape == jframes.shape == (len(range(0, steps, max(steps // keep_frames, 1))),
                                             2, N_P, 3)
    np.testing.assert_allclose(frames.numpy(), np.asarray(jframes), **CHAIN_TOL)
    np.testing.assert_array_equal(tphar.h.numpy(), np.asarray(jphar.h))
    np.testing.assert_allclose(tphar.x.numpy(), np.asarray(jphar.x), **CHAIN_TOL)
    np.testing.assert_allclose(tpocket.x.numpy(), np.asarray(jpocket.x), **CHAIN_TOL)
    # with the default (ancestral, CoM-free) config the chain's sample is
    # sample_given_pocket's, less its final CoM projection (float rounding)
    phar, pocket_out = tmodel.sample_given_pocket(pocket, torch.from_numpy(nn_), N_P,
                                                  timesteps=steps, noise=noise)
    assert torch.equal(phar.h, tphar.h)
    torch.testing.assert_close(phar.x, tphar.x, atol=1e-5, rtol=0)
    torch.testing.assert_close(pocket_out.x, tpocket.x, atol=1e-5, rtol=0)


@pytest.mark.parametrize("ddpm_kw", [{"ddim_eta": 0.0}, {"ddim_eta": 0.5}, {"com_free": False}],
                         ids=["ddim_eta_0", "ddim_eta_0.5", "com_free_off"])
def test_sample_chain_options_match_jax(ddpm_kw):
    """The JAX package's chain is ancestral whatever ddim_eta is, and skips
    the pocket-CoM shift and the final projection: so is the port's, frames
    and sample within 1e-4."""
    steps = 6
    jmodel, params, tmodel = _pair(**ddpm_kw)
    px, ph, pm = _pocket()
    nn_ = np.array([N_P, N_P - 2])
    rng = jax.random.PRNGKey(5)
    jphar, jpocket, jframes = jsample_chain(
        jmodel, params, rng, JPointCloud(x=px, h=ph, mask=pm), jnp.asarray(nn_), N_P,
        keep_frames=3, timesteps=steps)
    pocket = PointCloud(x=torch.from_numpy(px), h=torch.from_numpy(ph),
                        mask=torch.from_numpy(pm))
    tphar, tpocket, frames = tmodel.sample_chain_given_pocket(
        pocket, torch.from_numpy(nn_), N_P, keep_frames=3, timesteps=steps,
        noise=_chain_noise(rng, 2, N_P, steps))
    chain_tol = dict(atol=1e-4, rtol=0)
    np.testing.assert_allclose(frames.numpy(), np.asarray(jframes), **chain_tol)
    np.testing.assert_array_equal(tphar.h.numpy(), np.asarray(jphar.h))
    np.testing.assert_allclose(tphar.x.numpy(), np.asarray(jphar.x), **chain_tol)
    np.testing.assert_allclose(tpocket.x.numpy(), np.asarray(jpocket.x), **chain_tol)


def test_render_chain_gif(tmp_path):
    rng = np.random.RandomState(0)
    f, n = 12, 6
    target = rng.randn(n, 3) * 3
    frames = np.stack([target + rng.randn(n, 3) * (1.0 - t / (f - 1)) * 5 for t in range(f)])
    out = tmp_path / "chain.gif"
    images = render_chain(out, frames, np.array([1, 1, 1, 1, 0, 0], np.float32),
                          types=np.array([0, 1, 4, 5, 0, 0]), pocket_coords=rng.randn(20, 3) * 6,
                          type_names=list("ABCDEFGH"), max_frames=4, hold_last=2,
                          save_pngs=True)
    assert out.exists() and out.stat().st_size > 1000
    assert (tmp_path / "chain_0000.png").exists()
    assert out.read_bytes()[:6] in (b"GIF87a", b"GIF89a")
    assert len(images) >= 4


def test_render_chain_for_pocket(tmp_path):
    _, _, tmodel = _pair(size_histogram=np.ones((5, N_Q + 1)))
    rng = np.random.RandomState(1)
    coords = realistic_ca_pocket(rng, N_Q)
    onehot = np.eye(RES_NF, dtype=np.float32)[rng.randint(0, RES_NF, N_Q)]
    out = tmp_path / "pocket_chain.gif"
    render_chain_for_pocket(tmodel, coords, onehot, out, n_phar_max=4, timesteps=4,
                            keep_frames=4, max_frames=4, hold_last=1,
                            generator=torch.Generator().manual_seed(0))
    assert out.exists() and out.stat().st_size > 1000
