"""DiffPhar training in the port against the JAX package on the CPU at f32:
the loss terms (``loss_given_noise``, conditional and joint), the gradient
of every flax leaf, the optimizer, the clip queue and the EMA against
optax, one whole train step, the kernel route under autograd, and the
trainer (``train_diffphar``: checkpoints, resume, EMA seeding,
``sample-phars`` on its ``best/``).

Both packages get the same numpy inputs and the same draws (the JAX
package's ``loss`` splits its key into k_t, k_eps, k_eps0; the test draws
those and hands them to the port's ``loss_given_noise``).

Tolerances: values atol 2e-4 / rtol 1e-4. Gradients: each leaf within
1e-3 of its own largest |g|, plus 1e-5 of the largest |g| over the whole
tree: a leaf whose true gradient cancels (the gamma network's output bias,
which its endpoint normalisation removes) carries float32 rounding of the
tree's scale in both packages. The learned schedule is held at gamma-net
weights that keep its float32 normalisation well conditioned (l1's kernel
4, l3's kernels shifted by -4); at the initial weights it subtracts values
near 65 that differ by about 1 and rounding alone moves gamma by up to
8e-4 (``tests/test_torch_sampling_options.py``). Optimizer states and
parameters after optax's steps: 1e-6 relative.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cmdgen_tpu.config import to_dict
from cmdgen_tpu.containers import PointCloud as JPointCloud
from cmdgen_tpu.diffusion import joint as jjoint
from cmdgen_tpu.diffusion.cddpm import ConditionalDDPM as JConditionalDDPM
from cmdgen_tpu.diffusion.cddpm import DDPMConfig as JDDPMConfig
from cmdgen_tpu.diffusion.cddpm import sample_t_int as jsample_t_int
from cmdgen_tpu.diffusion.size_prior import SizePrior as JSizePrior
from cmdgen_tpu.models.dynamics import DynamicsConfig, EGNNDynamics
from cmdgen_tpu.models.egnn import EGNNConfig
from cmdgen_tpu.train import state as jstate
from cmdgen_tpu.utils.synthetic import realistic_ca_pocket
from cmdgen_tpu_torch import convert
from cmdgen_tpu_torch.config import DiffPharConfig as TDiffPharConfig
from cmdgen_tpu_torch.config import from_dict
from cmdgen_tpu_torch.containers import PointCloud
from cmdgen_tpu_torch.diffusion.cddpm import DDPMConfig
from cmdgen_tpu_torch.models.dynamics import DynamicsConfig as TDynamicsConfig
from cmdgen_tpu_torch.train import state as tstate

torch.set_num_threads(1)

TOL = dict(atol=2e-4, rtol=1e-4)
OPT_TOL = dict(atol=0.0, rtol=1e-6)
B, N_P, N_Q, RES_NF, T = 3, 8, 24, 20, 10


def _dcfg(neighbor_k=None, joint=False):
    return DynamicsConfig(
        phar_nf=8, residue_nf=RES_NF, joint_nf=8, edge_cutoff=6.0,
        update_pocket_coords=joint,
        egnn=EGNNConfig(hidden_nf=32, n_layers=2, inv_sublayers=1, neighbor_k=neighbor_k))


def _batch(seed=0):
    """B complexes (padded rows in both clouds), as numpy."""
    rng = np.random.RandomState(seed)
    qx = np.stack([realistic_ca_pocket(rng, N_Q) for _ in range(B)]).astype(np.float32)
    qh = np.eye(RES_NF, dtype=np.float32)[rng.randint(0, RES_NF, (B, N_Q))]
    qm = np.ones((B, N_Q), np.float32)
    qm[1, -5:] = 0.0
    px = (rng.randn(B, N_P, 3) * 2.0).astype(np.float32)
    ph = np.eye(8, dtype=np.float32)[rng.randint(0, 8, (B, N_P))]
    pm = np.ones((B, N_P), np.float32)
    pm[0, -3:] = 0.0
    pm[2, -1:] = 0.0
    return [a * m[..., None] for a, m in ((px, pm), (ph, pm))] + [pm] + \
        [a * m[..., None] for a, m in ((qx, qm), (qh, qm))] + [qm]


def _clouds(arrays):
    px, ph, pm, qx, qh, qm = arrays
    jc = (JPointCloud(jnp.asarray(px), jnp.asarray(ph), jnp.asarray(pm)),
          JPointCloud(jnp.asarray(qx), jnp.asarray(qh), jnp.asarray(qm)))
    tc = (PointCloud(torch.from_numpy(px), torch.from_numpy(ph), torch.from_numpy(pm)),
          PointCloud(torch.from_numpy(qx), torch.from_numpy(qh), torch.from_numpy(qm)))
    return jc, tc


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


HIST = np.random.RandomState(3).rand(N_P + 1, N_Q + 1) * 5.0


@pytest.fixture(scope="module")
def dyn_params():
    """Flax params of the conditional dynamics (dense and K=10 share them,
    and the joint dynamics has the same tree) and a gamma-net subtree."""
    arrays = _batch()
    jdyn = EGNNDynamics(_dcfg())
    params = jax.jit(jdyn.init)(jax.random.PRNGKey(4),
                       jnp.asarray(np.concatenate(arrays[:2], -1)),
                       jnp.asarray(np.concatenate(arrays[3:5], -1)), jnp.zeros((B, 1)),
                       jnp.asarray(arrays[2]), jnp.asarray(arrays[5]))
    jm = JConditionalDDPM(JDDPMConfig(timesteps=T, noise_schedule="learned", loss_type="vlb"),
                          jdyn)
    gp = dict(jm.init_extra_params(jax.random.PRNGKey(1), params)["params"]["gamma_net"])
    gp["l1"] = {"kernel": jnp.full((1, 1), 4.0), "bias": jnp.zeros((1,))}
    gp["l3"] = {"kernel": gp["l3"]["kernel"] - 4.0, "bias": gp["l3"]["bias"]}
    return params, gp


def _pair(dyn_params, neighbor_k=None, schedule="polynomial_2", loss_type="l2",
          com_free=True, size_prior=False, joint=False):
    """(JAX model, its params, the port's model with them) of one variant."""
    params, gp = dyn_params
    dcfg = JDDPMConfig(timesteps=T, noise_schedule=schedule, loss_type=loss_type,
                       com_free=com_free)
    dyn = _dcfg(neighbor_k, joint)
    jdyn = EGNNDynamics(dyn)
    if schedule == "learned":
        params = {"params": {**params["params"], "gamma_net": gp}}
    jprior = JSizePrior(HIST) if size_prior else None
    jmodel = (jjoint.JointDDPM if joint else JConditionalDDPM)(dcfg, jdyn, jprior)
    cfg = TDiffPharConfig(dynamics=from_dict(TDynamicsConfig, to_dict(dyn)),
                          ddpm=from_dict(DDPMConfig, to_dict(dcfg)))
    if joint:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, mode="joint"))
    tmodel = convert.build_model(cfg, _np(params), "cpu",
                                 size_histogram=HIST if size_prior else None)
    return jmodel, params, tmodel


def _jax_draws(jmodel, jphar, jpocket, training, seed=7):
    """The draws of the JAX package's ``loss`` for one key."""
    k_t, k_eps, k_eps0 = jax.random.split(jax.random.PRNGKey(seed), 3)
    t_int = jsample_t_int(k_t, B, 0 if training else 1, T)
    if isinstance(jmodel, jjoint.JointDDPM):
        eps = jmodel._sample_joint_noise(k_eps, jphar.mask, jpocket.mask)
        eps0 = jmodel._sample_joint_noise(k_eps0, jphar.mask, jpocket.mask)
        return (t_int, *eps, *eps0)
    shape = (*jphar.mask.shape, 3 + 8)
    m = jphar.mask[..., None]
    return (t_int, jax.random.normal(k_eps, shape) * m, jax.random.normal(k_eps0, shape) * m)


def _terms_match(jmodel, params, tmodel, training, t_override=None):
    (jphar, jpocket), (tphar, tpocket) = _clouds(_batch())
    draws = _jax_draws(jmodel, jphar, jpocket, training)
    if t_override is not None:  # every branch of the assembly: t = 0 too
        draws = (jnp.asarray(t_override, jnp.float32),) + draws[1:]
    nll, info = jmodel.loss_given_noise(params, jphar, jpocket, *draws, training=training,
                                        return_terms=True)
    with torch.no_grad():
        tnll, tinfo = tmodel.loss_given_noise(tphar, tpocket, *(torch.from_numpy(np.array(d))
                                                              for d in draws),
                                              training=training, return_terms=True)
    np.testing.assert_allclose(tnll.numpy(), np.asarray(nll), **TOL)
    assert set(tinfo["terms"]) == set(info["terms"])
    for k, v in info["terms"].items():
        np.testing.assert_allclose(tinfo["terms"][k].numpy(), np.asarray(v), **TOL, err_msg=k)
    for k, v in info.items():
        if k != "terms":
            np.testing.assert_allclose(float(tinfo[k]), float(v), **TOL, err_msg=k)


VARIANTS = {
    "l2_train": dict(loss_type="l2"),
    "l2_eval": dict(loss_type="l2", training=False),
    "vlb_train": dict(loss_type="vlb"),
    "vlb_eval": dict(loss_type="vlb", training=False),
    "com_free_off": dict(loss_type="vlb", com_free=False),
    "learned_train": dict(loss_type="vlb", schedule="learned"),
    "learned_eval": dict(loss_type="vlb", schedule="learned", training=False),
    "size_prior_eval": dict(loss_type="vlb", size_prior=True, training=False),
    "neighbor_k_train": dict(loss_type="l2", neighbor_k=10),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_terms_match_jax(dyn_params, variant):
    kw = dict(VARIANTS[variant])
    training = kw.pop("training", True)
    jmodel, params, tmodel = _pair(dyn_params, **kw)
    _terms_match(jmodel, params, tmodel, training,
                 t_override=[0.0, 4.0, float(T)] if training else None)


@pytest.mark.parametrize("loss_type,training", [("l2", True), ("vlb", False)],
                         ids=["l2_train", "vlb_eval"])
def test_joint_loss_terms_match_jax(dyn_params, loss_type, training):
    jmodel, params, tmodel = _pair(dyn_params, loss_type=loss_type, joint=True,
                                   size_prior=not training)
    _terms_match(jmodel, params, tmodel, training,
                 t_override=[0.0, 4.0, float(T)] if training else None)


def _grad_match(jmodel, params, tmodel, training=True):
    """jax.grad of the mean NLL against the port's backward, every leaf."""
    (jphar, jpocket), (tphar, tpocket) = _clouds(_batch())
    draws = _jax_draws(jmodel, jphar, jpocket, training)
    draws = (jnp.asarray([0.0, 4.0, float(T)]),) + draws[1:]

    def loss(p):
        return jnp.mean(jmodel.loss_given_noise(p, jphar, jpocket, *draws,
                                                training=training)[0])

    ref = convert.flatten_params(_np(jax.jit(jax.grad(loss))(params)["params"]))
    for p in tmodel.parameters():
        p.grad = None
    nll, _ = tmodel.loss_given_noise(tphar, tpocket, *(torch.from_numpy(np.array(d))
                                                       for d in draws), training=training)
    nll.mean().backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in tmodel.named_parameters()}
    got = convert.model_leaves(tmodel, grads)
    assert set(got) == set(ref)
    tree_max = max(np.abs(v).max() for v in ref.values())
    for path, r in ref.items():
        tol = 1e-3 * np.abs(r).max() + 1e-5 * tree_max
        err = np.abs(got[path] - r).max()
        assert err <= tol, f"{path}: {err} > {tol}"
    return got


@pytest.mark.parametrize("variant", ["dense", "neighbor_k", "learned"])
def test_gradients_match_jax(dyn_params, variant):
    kw = {"dense": dict(), "neighbor_k": dict(neighbor_k=10),
          "learned": dict(schedule="learned", loss_type="vlb")}[variant]
    got = _grad_match(*_pair(dyn_params, **kw))
    if variant == "learned":
        # the schedule trains: its gradients reach the gamma network
        assert np.abs(got["gamma_net/gamma_0"]).max() > 0
        assert np.abs(got["gamma_net/l2/kernel"]).max() > 0


def test_joint_gradients_match_jax(dyn_params):
    _grad_match(*_pair(dyn_params, joint=True))


# ---------------------------------------------------------------- optimizer

def _leaves_close(a, b, rtol=1e-6):
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=0.0, err_msg=k)


def test_amsgrad_matches_optax_across_falling_nu_hat():
    """Three steps on the same gradients, the second moment falling after
    the first (a large, then small gradients): optax's maximum over the
    bias-corrected moment keeps the first step's nu_hat, where
    ``torch.optim.Adam(amsgrad=True)``'s maximum over the raw moment does
    not, and its parameters part from optax's at the second step."""
    rng = np.random.RandomState(0)
    p0 = {"a": rng.randn(4, 3).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * s).astype(np.float32) for k, v in p0.items()}
             for s in (10.0, 0.1, 0.1)]
    opt = jstate.reference_optimizer(1e-2)
    jp, jst = {k: jnp.asarray(v) for k, v in p0.items()}, None
    jst = opt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    topt = tstate.reference_optimizer(list(tp.values()), 1e-2)
    naive = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    nopt = torch.optim.Adam(list(naive.values()), lr=1e-2, amsgrad=True, weight_decay=1e-12)
    for g in grads:
        up, jst = opt.update({k: jnp.asarray(v) for k, v in g.items()}, jst, jp)
        jp = optax.apply_updates(jp, up)
        for src in ((tp, topt), (naive, nopt)):
            for k, p in src[0].items():
                p.grad = torch.from_numpy(g[k])
            src[1].step()
        _leaves_close({k: p.detach().numpy() for k, p in tp.items()}, _np(jp))
        first = jst[0]
        for k, p in tp.items():
            st = topt.state[p]
            assert st["count"] == int(first.count)
            for key in ("mu", "nu", "nu_max"):
                np.testing.assert_allclose(st[key].numpy(), np.asarray(getattr(first, key)[k]),
                                           **OPT_TOL)
    # nu_hat fell: the bias-corrected maximum is the first step's
    assert np.all(np.asarray(jst[0].nu_max["a"]) > np.asarray(jst[0].nu["a"]) /
                  (1 - 0.999 ** 3))
    assert not np.allclose(naive["a"].detach().numpy(), np.asarray(jp["a"]), rtol=1e-4)


def test_adaptive_clip_and_ema_match_jax():
    rng = np.random.RandomState(1)
    queue = (3000.0 * rng.rand(tstate.GRAD_QUEUE_LEN) + 1.0).astype(np.float32)
    for scale in (1.0, 1e4):  # below and above the clip
        g = {"a": (rng.randn(6, 4) * scale).astype(np.float32),
             "b": (rng.randn(3) * scale).astype(np.float32)}
        jg, jq, jn = jstate.adaptive_clip({k: jnp.asarray(v) for k, v in g.items()},
                                          jnp.asarray(queue))
        tg, tq, tn = tstate.adaptive_clip([torch.from_numpy(g["a"]), torch.from_numpy(g["b"])],
                                          torch.from_numpy(queue))
        np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-6)
        for t, k in zip(tg, ("a", "b")):
            np.testing.assert_allclose(t.numpy(), np.asarray(jg[k]), rtol=1e-6, atol=1e-7)
    # the population std (jnp.std): torch.std's default would differ here
    assert not np.isclose(float(torch.from_numpy(queue).std()), float(jnp.std(queue)),
                          rtol=1e-4)
    ema = {"a": rng.randn(4).astype(np.float32)}
    p = {"a": rng.randn(4).astype(np.float32)}
    for step in (0, 5, 10_000):
        ref = jstate.ema_update({"a": jnp.asarray(ema["a"])}, {"a": jnp.asarray(p["a"])},
                                jnp.asarray(step, jnp.int32), 0.999)
        te = {"a": torch.from_numpy(ema["a"].copy())}
        tstate.ema_update(te, {"a": torch.from_numpy(p["a"])}, step, 0.999)
        np.testing.assert_allclose(te["a"].numpy(), np.asarray(ref["a"]), rtol=1e-6)


@pytest.mark.parametrize("neighbor_k", [None, 10], ids=["dense", "neighbor_k"])
def test_train_step_matches_jax(dyn_params, neighbor_k):
    """Two JAX train steps (clip and EMA on), the state carried to the port
    (weights, optax's AMSGrad state through ``convert.port_opt_state``, the
    queue, the EMA), then one more step in both on the same batch and
    draws: loss, raw norm, queue, weights, optimizer state and EMA."""
    jmodel, params, tmodel = _pair(dyn_params, neighbor_k=neighbor_k)
    (jphar, jpocket), (tphar, tpocket) = _clouds(_batch())
    opt = jstate.reference_optimizer(1e-3)
    jstep = jax.jit(jstate.make_diffusion_train_step(jmodel, opt, clip_grad=True,
                                                     ema_decay=0.999))
    st = jstate.init_state(params, opt, ema=True)
    for seed in (11, 12):
        st, _ = jstep(st, jax.random.PRNGKey(seed), jphar, jpocket)
    # carry the state across
    convert.load_leaves(tmodel, convert.flatten_params(_np(st.params["params"])))
    topt = tstate.reference_optimizer(tmodel.parameters(), 1e-3)
    arrays = convert.port_opt_state(_np(st.opt_state))
    convert.load_optimizer_arrays(tmodel, topt, arrays)
    tst = tstate.init_state(tmodel, topt, ema=True)
    tst.step = int(st.step)
    tst.grad_norms = torch.from_numpy(np.array(st.grad_norms))
    tst.ema = convert.leaves_to_tensors(
        tmodel, convert.flatten_params(_np(st.ema_params["params"])))
    # the carried state reads back as optax's
    back = convert.optax_state(convert.optimizer_arrays(tmodel, topt), st.opt_state)
    _leaves_close(convert.flatten_params(_np(back[0].nu_max)),
                  convert.flatten_params(_np(st.opt_state[0].nu_max)))
    # one more step each on the same draws
    key = jax.random.PRNGKey(13)
    k_t, k_eps, k_eps0 = jax.random.split(key, 3)
    t_int = jsample_t_int(k_t, B, 0, T)
    shape = (B, N_P, 11)
    m = jphar.mask[..., None]
    draws = (t_int, jax.random.normal(k_eps, shape) * m, jax.random.normal(k_eps0, shape) * m)
    st, jmet = jstep(st, key, jphar, jpocket)
    tstep = tstate.make_diffusion_train_step(clip_grad=True, ema_decay=0.999)
    tmet = tstep(tst, tphar, tpocket, noise=[torch.from_numpy(np.array(d)) for d in draws])
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), **TOL)
    np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-3)
    np.testing.assert_allclose(tst.grad_norms.numpy(), np.asarray(st.grad_norms), rtol=1e-3)
    assert tst.step == int(st.step) == 3
    # weights after the step: the update is lr * mu_hat / (sqrt(nu_max) + eps),
    # at most ~lr per element, so a gradient within 1e-3 of its leaf moves
    # the weight by well under 1e-5 of an update
    ref = convert.flatten_params(_np(st.params["params"]))
    got = convert.model_leaves(tmodel)
    for k, r in ref.items():
        np.testing.assert_allclose(got[k], r, atol=2e-6, rtol=1e-5, err_msg=k)
    ema_ref = convert.flatten_params(_np(st.ema_params["params"]))
    ema_got = convert.model_leaves(tmodel, tst.ema)
    for k, r in ema_ref.items():
        np.testing.assert_allclose(ema_got[k], r, atol=2e-6, rtol=1e-5, err_msg=k)


# ------------------------------------------------------------- kernel route

def test_kernel_route_only_outside_autograd(dyn_params, monkeypatch):
    """K1's wrapper is called 0 times in a train step and in every GCL of
    every denoiser call of ``sample_given_pocket`` (here its plain version
    runs: the tensors lie on the CPU)."""
    from cmdgen_tpu_torch.models import egnn as egnn_module

    calls = []
    real = egnn_module.gcl_message_agg

    def counting(*args, **kwargs):
        calls.append(torch.is_grad_enabled())
        return real(*args, **kwargs)

    monkeypatch.setattr(egnn_module, "gcl_message_agg", counting)
    _, _, tmodel = _pair(dyn_params, neighbor_k=10)
    _, (tphar, tpocket) = _clouds(_batch())
    st = tstate.init_state(tmodel, tstate.reference_optimizer(tmodel.parameters()))
    tstate.make_diffusion_train_step()(st, tphar, tpocket,
                                       generator=torch.Generator().manual_seed(0))
    assert calls == []
    tmodel.sample_given_pocket(tpocket, torch.tensor([5, 3, 4]), N_P, timesteps=3,
                               generator=torch.Generator().manual_seed(0))
    assert len(calls) == 2 * (3 + 1) and not any(calls)


def test_kernel_wrappers_refuse_autograd():
    """On a tensor that requires grad under grad mode the wrappers refuse
    (the check runs before any CUDA work: a CPU tensor flagged as CUDA is
    not needed, the rule is the function's)."""
    from cmdgen_tpu_torch.ops.egnn_msgpass import kernel_route, refuse_autograd

    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward pass"):
        refuse_autograd("k", x)
    with torch.no_grad():
        refuse_autograd("k", x)
        assert kernel_route()
    refuse_autograd("k", x.detach())
    assert not kernel_route()


def test_gamma_net_trains_under_grad(dyn_params):
    """The learned schedule's gamma carries a gradient outside no_grad and
    none inside (the samplers)."""
    _, _, tmodel = _pair(dyn_params, schedule="learned", loss_type="vlb")
    g = tmodel._gamma_t_norm(torch.tensor([0.3]))
    assert g.requires_grad
    with torch.no_grad():
        assert not tmodel._gamma_t_norm(torch.tensor([0.3])).requires_grad


# ----------------------------------------------------------------- trainer

def _tiny_config(**train):
    from cmdgen_tpu_torch.config import ca_config

    cfg = ca_config()
    egnn = dataclasses.replace(cfg.dynamics.egnn, hidden_nf=32, n_layers=2, neighbor_k=6)
    tr = dict(n_epochs=2, batch_size=4, eval_epochs=1, n_eval_samples=3, clip_grad=True)
    tr.update(train)
    return dataclasses.replace(
        cfg, dynamics=dataclasses.replace(cfg.dynamics, joint_nf=8, egnn=egnn),
        ddpm=dataclasses.replace(cfg.ddpm, timesteps=10),
        train=dataclasses.replace(cfg.train, **tr))


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    from cmdgen_tpu_torch.utils.synthetic import synthetic_diffphar_npz

    d = tmp_path_factory.mktemp("diffphar_data")
    synthetic_diffphar_npz(d / "train.npz", np.random.RandomState(0), 9, n_pocket=(10, 20))
    synthetic_diffphar_npz(d / "val.npz", np.random.RandomState(1), 3, n_pocket=(10, 20))
    return d


@pytest.fixture(scope="module")
def trained(data_dir, tmp_path_factory):
    """A 2-epoch run with EMA (eval sampling every epoch), and the batches
    each epoch drew."""
    from cmdgen_tpu_torch.train import diffphar_train

    out = tmp_path_factory.mktemp("diffphar_run")
    logs = []
    state = diffphar_train.train_diffphar(_tiny_config(ema_decay=0.999), data_dir, out,
                                          log_fn=lambda s, m: logs.append((s, m)), device="cpu")
    return out, state, logs


def test_train_diffphar_writes_best_and_last(trained):
    out, state, logs = trained
    assert state.step == 4  # 9 complexes, batches of 4, 2 epochs
    for name in ("best", "last"):
        files = sorted(p.name for p in (out / name).iterdir())
        assert files == ["config.json", "ema_params.npz", "opt_state.npz", "params.npz"]
        meta = json.loads((out / f"{name}.json").read_text())
        assert set(meta) == {"step", "epoch", "monitor", "config"}
    assert json.loads((out / "last.json").read_text())["step"] == 4
    vals = [m["loss/val"] for _, m in logs if "loss/val" in m]
    best = json.loads((out / "best.json").read_text())["monitor"]
    assert len(vals) == 2 and best == pytest.approx(min(vals))
    sampled = [m for _, m in logs if "sampling/kl_types" in m]
    assert len(sampled) == 2 and all(np.isfinite(m["sampling/spread_gen"]) for m in sampled)
    # the checkpoint's EMA is the state's, its weights the model's
    with np.load(out / "last" / "ema_params.npz") as npz:
        ema = {k: npz[k] for k in npz.files}
    _leaves_close(ema, convert.model_leaves(state.model, state.ema), rtol=0)


def test_resume_continues_the_same_run(data_dir, trained, tmp_path):
    """One epoch, then a resume to two: the same batches and draws as the
    continuous run, so the same weights, optimizer state and EMA."""
    from cmdgen_tpu_torch.train import diffphar_train

    out, state, _ = trained
    first = tmp_path / "first"
    diffphar_train.train_diffphar(_tiny_config(ema_decay=0.999, n_epochs=1), data_dir, first,
                                  device="cpu")
    resumed = diffphar_train.train_diffphar(_tiny_config(ema_decay=0.999), data_dir,
                                            tmp_path / "second", resume_from=first, device="cpu")
    assert resumed.step == state.step
    _leaves_close(convert.model_leaves(resumed.model), convert.model_leaves(state.model), rtol=0)
    _leaves_close(convert.model_leaves(resumed.model, resumed.ema),
                  convert.model_leaves(state.model, state.ema), rtol=0)
    _leaves_close(convert.optimizer_arrays(resumed.model, resumed.optimizer),
                  convert.optimizer_arrays(state.model, state.optimizer), rtol=0)


def test_resume_seeds_the_ema_from_the_weights(data_dir, trained, tmp_path):
    """A run without EMA resumed with one: the EMA starts from the restored
    weights (never from the fresh initialisation); resumed without one, a
    checkpoint's EMA is dropped."""
    from cmdgen_tpu_torch.train import diffphar_train

    plain = tmp_path / "plain"
    diffphar_train.train_diffphar(_tiny_config(n_epochs=1), data_dir, plain, device="cpu")
    payload, _ = diffphar_train.ckpt.load_checkpoint(plain, "last")
    assert "ema_params" not in payload
    seen = {}
    real = tstate.ema_update

    def spy(ema, params, step, decay):
        seen.setdefault("first", convert.model_leaves(
            seen["model"], {k: v.clone() for k, v in ema.items()}))
        real(ema, params, step, decay)

    cfg = _tiny_config(ema_decay=0.999, n_epochs=2)
    build = diffphar_train.build_model

    def keep_model(*a, **kw):
        seen["model"] = build(*a, **kw)
        return seen["model"]

    try:
        tstate.ema_update, diffphar_train.build_model = spy, keep_model
        st = diffphar_train.train_diffphar(cfg, data_dir, tmp_path / "ema", resume_from=plain,
                                           device="cpu")
    finally:
        tstate.ema_update, diffphar_train.build_model = real, build
    _leaves_close(seen["first"], payload["params"], rtol=0)
    assert st.ema is not None
    out, _, _ = trained
    st = diffphar_train.train_diffphar(_tiny_config(n_epochs=2), data_dir, tmp_path / "no_ema",
                                       resume_from=out, device="cpu")
    assert st.ema is None


def test_sample_phars_reads_best(trained, tmp_path):
    from cmdgen_tpu_torch import cli
    from cmdgen_tpu_torch.utils.synthetic import synthetic_pocket_pdb

    out, _, _ = trained
    pdb = tmp_path / "pocket.pdb"
    pdb.write_text(synthetic_pocket_pdb(np.random.RandomState(0), 30))
    cli.main(["sample-phars", str(out), str(pdb), str(tmp_path / "o.json"), "--ref-ligand",
              "L:1", "--n-samples", "4", "--timesteps", "5", "--device", "cpu"])
    clouds = json.loads((tmp_path / "o.json").read_text())
    assert len(clouds) == 4
    # the run's directory means its best/, whose EMA weights the model holds
    model, _ = convert.load_port_checkpoint(out, "cpu")
    with np.load(out / "best" / "ema_params.npz") as npz:
        ema = {k: npz[k] for k in npz.files}
    _leaves_close(convert.model_leaves(model), ema, rtol=0)


def test_init_draws_flax_initializers():
    """Fresh weights: zero biases, lecun-normal kernels (std 1/sqrt(fan_in),
    truncated at 2 std), a coordinate gate of variance 1e-6 / fan_avg, the
    gamma network's endpoints -5 and 10; embeddings an untruncated normal
    of std 1/sqrt(width), held against flax's own ``nn.Embed`` draw."""
    from cmdgen_tpu_torch.train.diffphar_train import build_model

    cfg = _tiny_config()
    cfg = dataclasses.replace(cfg, ddpm=dataclasses.replace(
        cfg.ddpm, noise_schedule="learned", loss_type="vlb"))
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    dyn = model.dynamics
    for name, p in dyn.named_parameters():
        if name.endswith("bias"):
            assert torch.all(p == 0), name
    w = dyn.egnn.e_block_0.gcl_0.edge_out.weight
    assert abs(float(w.detach().std()) * 32 ** 0.5 - 1.0) < 0.15
    assert float(w.abs().max()) <= 2.0 / 0.87962566103423978 / 32 ** 0.5 + 1e-6
    gate = dyn.egnn.e_block_0.coord_update.coord_gate.weight
    assert float(gate.abs().max()) <= (3e-6 / 16.5) ** 0.5 + 1e-9
    assert float(model.gamma_net.gamma_0) == -5.0 and float(model.gamma_net.gamma_1) == 10.0
    again = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    _leaves_close(convert.model_leaves(again), convert.model_leaves(model), rtol=0)
    # nn.Embed: an untruncated normal of std 1/sqrt(width), as flax draws it
    import flax.linen as fnn

    from cmdgen_tpu_torch.models.init import init_gcpg_

    emb = torch.nn.Embedding(4000, 64)
    init_gcpg_(emb, torch.Generator().manual_seed(0))
    ours = emb.weight.detach().numpy().ravel() * 8.0
    ref = np.asarray(fnn.Embed(4000, 64).init(jax.random.PRNGKey(0), np.zeros(1, np.int32))
                     ["params"]["embedding"]).ravel() * 8.0
    assert abs(float(ours.std()) - 1.0) < 0.01
    assert float(np.abs(ours).max()) > 2.0 / 0.87962566103423978  # not truncated
    q = [0.005, 0.02, 0.16, 0.5, 0.84, 0.98, 0.995]  # a truncated draw ends at 2.27
    np.testing.assert_allclose(np.quantile(ours, q), np.quantile(ref, q), atol=0.03)


def test_dispatch_settings_leave_one_batch_plan(data_dir, tmp_path):
    """The JAX package's TPU dispatch settings (``steps_per_call``,
    ``resident_data``), as its configs carry them, leave the port's one
    host-fed batch plan: the same steps and the same weights."""
    from cmdgen_tpu_torch.train import diffphar_train

    runs = [diffphar_train.train_diffphar(
        _tiny_config(n_epochs=1, eval_epochs=0, **kw), data_dir, tmp_path / str(i),
        device="cpu") for i, kw in enumerate([{}, dict(resident_data="on", steps_per_call=3)])]
    assert runs[0].step == runs[1].step == 2 and runs[1].optimizer.count == 2
    _leaves_close(convert.model_leaves(runs[1].model), convert.model_leaves(runs[0].model),
                  rtol=0)


def test_eval_sampling_uses_a_snapshot_of_the_ema(data_dir, tmp_path, monkeypatch):
    """Eval-epoch sampling runs on a copy holding the EMA weights, its fused
    engine built on that copy: the sampler's denoiser is the EMA model's
    (not the raw weights'), and later steps do not reach it."""
    from cmdgen_tpu_torch.train import diffphar_train

    seen = []
    real = diffphar_train.sampling_metrics

    def capture(model, *a, **kw):
        seen.append((model, convert.model_leaves(model)))
        return real(model, *a, **kw)

    monkeypatch.setattr(diffphar_train, "sampling_metrics", capture)
    st = diffphar_train.train_diffphar(_tiny_config(ema_decay=0.9), data_dir, tmp_path,
                                       device="cpu", eval_engine="fused")
    (first, first_w), (last, last_w) = seen
    _leaves_close(last_w, convert.model_leaves(st.model, st.ema), rtol=0)
    assert not np.allclose(last_w["egnn/embedding/kernel"],
                           convert.model_leaves(st.model)["egnn/embedding/kernel"])
    _leaves_close(convert.model_leaves(first), first_w, rtol=0)  # untouched by epoch 2
    _, (tphar, tpocket) = _clouds(_batch())
    args = (tphar.xh, tpocket.xh, torch.full((B, 1), 0.5), tphar.mask, tpocket.mask)
    with torch.no_grad():
        fused, plain = last._apply(*args), last.dynamics(*args)
    for f, p in zip(fused, plain):
        np.testing.assert_allclose(f.numpy(), p.numpy(), **TOL)


def test_train_diffphar_joint_and_sample(data_dir, tmp_path):
    """The joint model trains through the same loop (no eval sampling: it
    has no conditional sampler) and its best/ samples by RePaint through
    ``sample-phars``."""
    from cmdgen_tpu_torch import cli
    from cmdgen_tpu_torch.diffusion.joint import JointDDPM
    from cmdgen_tpu_torch.train import diffphar_train
    from cmdgen_tpu_torch.utils.synthetic import synthetic_pocket_pdb

    cfg = _tiny_config(n_epochs=1)
    cfg = dataclasses.replace(
        cfg, dynamics=dataclasses.replace(cfg.dynamics, update_pocket_coords=True),
        train=dataclasses.replace(cfg.train, mode="joint"))
    st = diffphar_train.train_diffphar(cfg, data_dir, tmp_path / "run", device="cpu")
    assert isinstance(st.model, JointDDPM) and st.step == 2
    pdb = tmp_path / "pocket.pdb"
    pdb.write_text(synthetic_pocket_pdb(np.random.RandomState(0), 20))
    cli.main(["sample-phars", str(tmp_path / "run"), str(pdb), str(tmp_path / "o.json"),
              "--ref-ligand", "L:1", "--n-samples", "2", "--device", "cpu"])
    assert len(json.loads((tmp_path / "o.json").read_text())) == 2


def test_stratified_times_cover_every_stratum():
    """``stratified_t`` strides one offset across the batch: with as many
    samples as times, each time is drawn once, in both packages; iid draws
    stay in {lowest..T}."""
    from cmdgen_tpu_torch.diffusion.cddpm import sample_t_int

    for lowest in (0, 1):
        n = T + 1 - lowest
        out = sample_t_int(n, lowest, T, stratified=True,
                           generator=torch.Generator().manual_seed(3))
        ref = jsample_t_int(jax.random.PRNGKey(3), n, lowest, T, stratified=True)
        want = np.arange(lowest, T + 1, dtype=np.float32)
        np.testing.assert_array_equal(np.sort(out.numpy()), want)
        np.testing.assert_array_equal(np.sort(np.asarray(ref)), want)
        iid = sample_t_int(200, lowest, T, generator=torch.Generator().manual_seed(4))
        assert iid.dtype == torch.float32 and iid.min() >= lowest and iid.max() <= T
