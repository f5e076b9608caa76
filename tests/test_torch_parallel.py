"""The port's data and tensor parallelism and FSDP against the single-process
step and against the JAX package's single-device and dp=4 mesh steps.

The port runs one process per rank: here 4 (and 2) CPU processes under
gloo, spawned once per group of runs (``parallel.launch.spawn`` with a
``file://`` store in ``tmp_path``, the target ``parallel.check.run_jobs``).
JAX runs its mesh on the 8 virtual CPU devices of ``tests/conftest.py``.
Every run starts from the same weights (the JAX model's, converted) and
takes the same global batches and draws (those JAX's ``loss`` makes from
its key; the port's ranks each keep their own rows).

Tolerances are ``tests/test_parallel.py``'s: weights atol 1e-5, loss rtol
1e-4 (the sums over dp are taken in another order than over one batch).
"""
import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmdgen_tpu.config import to_dict
from cmdgen_tpu.containers import PointCloud as JPointCloud
from cmdgen_tpu.diffusion import joint as jjoint
from cmdgen_tpu.diffusion.cddpm import ConditionalDDPM as JConditionalDDPM
from cmdgen_tpu.diffusion.cddpm import DDPMConfig as JDDPMConfig
from cmdgen_tpu.diffusion.cddpm import sample_t_int as jsample_t_int
from cmdgen_tpu.models.dynamics import DynamicsConfig, EGNNDynamics
from cmdgen_tpu.models.egnn import EGNNConfig
from cmdgen_tpu.parallel import mesh as jmesh
from cmdgen_tpu.train import state as jstate
from cmdgen_tpu.utils.synthetic import realistic_ca_pocket
from cmdgen_tpu_torch import config as cfgmod
from cmdgen_tpu_torch import convert
from cmdgen_tpu_torch.diffusion.cddpm import DDPMConfig
from cmdgen_tpu_torch.models.dynamics import DynamicsConfig as TDynamicsConfig
from cmdgen_tpu_torch.parallel import check, launch
from cmdgen_tpu_torch.parallel import mesh as pmesh
from cmdgen_tpu_torch.train import state as tstate

torch.set_num_threads(1)

W_ATOL, L_RTOL = 1e-5, 1e-4
B, N_P, N_Q, RES_NF, T = 8, 6, 16, 20, 10
LAYOUTS = {"dp4": dict(dp=4), "dp2_tp2": dict(dp=2, tp=2), "fsdp_dp4": dict(dp=4, fsdp=True),
           "fsdp_dp2_tp2": dict(dp=2, tp=2, fsdp=True)}
EMA = 0.999


def _dcfg(joint=False):
    return DynamicsConfig(phar_nf=8, residue_nf=RES_NF, joint_nf=8, edge_cutoff=6.0,
                          update_pocket_coords=joint,
                          egnn=EGNNConfig(hidden_nf=16, n_layers=2, inv_sublayers=1))


def _batch(seed):
    """B complexes with padded rows, as numpy (px, ph, pm, qx, qh, qm)."""
    rng = np.random.RandomState(seed)
    qx = np.stack([realistic_ca_pocket(rng, N_Q) for _ in range(B)]).astype(np.float32)
    qh = np.eye(RES_NF, dtype=np.float32)[rng.randint(0, RES_NF, (B, N_Q))]
    qm = np.ones((B, N_Q), np.float32)
    qm[1, -4:] = 0.0
    px = (rng.randn(B, N_P, 3) * 2.0).astype(np.float32)
    ph = np.eye(8, dtype=np.float32)[rng.randint(0, 8, (B, N_P))]
    pm = np.ones((B, N_P), np.float32)
    pm[0, -2:] = 0.0
    pm[5, -1:] = 0.0
    return [px * pm[..., None], ph * pm[..., None], pm, qx * qm[..., None],
            qh * qm[..., None], qm]


def _jclouds(arrays):
    px, ph, pm, qx, qh, qm = map(jnp.asarray, arrays)
    return JPointCloud(px, ph, pm), JPointCloud(qx, qh, qm)


def _draws(jmodel, arrays, key):
    """The draws JAX's ``loss`` makes from ``key``, as numpy, in the order
    of the port's ``loss_given_noise``."""
    jphar, jpocket = _jclouds(arrays)
    k_t, k_eps, k_eps0 = jax.random.split(key, 3)
    t_int = jsample_t_int(k_t, B, 0, T)
    if isinstance(jmodel, jjoint.JointDDPM):
        eps = jmodel._sample_joint_noise(k_eps, jphar.mask, jpocket.mask)
        eps0 = jmodel._sample_joint_noise(k_eps0, jphar.mask, jpocket.mask)
        return [np.asarray(a) for a in (t_int, *eps, *eps0)]
    m = jphar.mask[..., None]
    shape = (B, N_P, 11)
    return [np.asarray(a) for a in (t_int, jax.random.normal(k_eps, shape) * m,
                                    jax.random.normal(k_eps0, shape) * m)]


def _model(joint=False):
    """(JAX model, its params, the port's config dict, the flat leaves)."""
    dyn = _dcfg(joint)
    jdyn = EGNNDynamics(dyn)
    px, ph, pm, qx, qh, qm = _batch(0)
    params = jax.jit(jdyn.init)(jax.random.PRNGKey(4), jnp.asarray(np.concatenate([px, ph], -1)),
                                jnp.asarray(np.concatenate([qx, qh], -1)), jnp.zeros((B, 1)),
                                jnp.asarray(pm), jnp.asarray(qm))
    dcfg = JDDPMConfig(timesteps=T)
    jmodel = (jjoint.JointDDPM if joint else JConditionalDDPM)(dcfg, jdyn)
    cfg = cfgmod.DiffPharConfig(dynamics=cfgmod.from_dict(TDynamicsConfig, to_dict(dyn)),
                                ddpm=cfgmod.from_dict(DDPMConfig, to_dict(dcfg)))
    if joint:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, mode="joint"))
    leaves = convert.flatten_params(jax.tree_util.tree_map(np.asarray, params["params"]))
    return jmodel, params, cfgmod.to_dict(cfg), leaves


def _jax_steps(jmodel, params, batches, keys, mesh=None):
    """JAX's train steps (clip and EMA on) on one device or on ``mesh``:
    the flax leaves after each step, the final EMA's, each step's loss."""
    opt = jstate.reference_optimizer(1e-3)
    step = jax.jit(jstate.make_diffusion_train_step(jmodel, opt, clip_grad=True, ema_decay=EMA))
    st = jstate.init_state(params, opt, ema=True)
    if mesh is not None:
        st = jmesh.replicate(st, mesh)
    losses, history = [], []
    flat = lambda tree: convert.flatten_params(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, tree["params"]))
    for arrays, key in zip(batches, keys):
        phar, pocket = _jclouds(arrays)
        if mesh is not None:
            phar, pocket = jmesh.shard_batch(phar, mesh), jmesh.shard_batch(pocket, mesh)
            with mesh:
                st, met = step(st, key, phar, pocket)
        else:
            st, met = step(st, key, phar, pocket)
        losses.append(float(met["loss"]))
        history.append(flat(st.params))
    return {"history": history, "ema": flat(st.ema_params), "losses": losses}


def _close(got, want, what):
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k], v, atol=W_ATOL, rtol=0, err_msg=f"{what} {k}")
    if want.get("ema") is not None:
        for k, v in want["ema"].items():
            np.testing.assert_allclose(got["ema"][k], v, atol=W_ATOL, rtol=0,
                                       err_msg=f"{what} ema {k}")
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=L_RTOL, err_msg=what)


# ------------------------------------------------------------ 4 processes

def _tiny_train_config(**train):
    cfg = cfgmod.ca_config()
    egnn = dataclasses.replace(cfg.dynamics.egnn, hidden_nf=16, n_layers=2, neighbor_k=6)
    tr = dict(n_epochs=2, batch_size=4, eval_epochs=1, n_eval_samples=3, clip_grad=True,
              ema_decay=0.999)
    tr.update(train)
    return dataclasses.replace(
        cfg, dynamics=dataclasses.replace(cfg.dynamics, joint_nf=8, egnn=egnn),
        ddpm=dataclasses.replace(cfg.ddpm, timesteps=10),
        train=dataclasses.replace(cfg.train, **tr))


@pytest.fixture(scope="module")
def train_data(tmp_path_factory):
    """A tiny synthetic train/val set for ``train_diffphar``."""
    from cmdgen_tpu_torch.utils.synthetic import synthetic_diffphar_npz

    data = tmp_path_factory.mktemp("data")
    synthetic_diffphar_npz(data / "train.npz", np.random.RandomState(0), 9, n_pocket=(10, 20))
    synthetic_diffphar_npz(data / "val.npz", np.random.RandomState(1), 3, n_pocket=(10, 20))
    return data


def _train_jobs(data, root, runs, resume=None):
    """``train`` jobs on the CPU: each config of ``runs`` ({run name:
    config}) writing to ``root / name``, resumed where ``resume`` ({run
    name: run name}) says from."""
    resume = resume or {}
    return [dict(kind="train", cfg=cfgmod.to_dict(c), datadir=str(data), out_dir=str(root / n),
                 resume_from=str(root / resume[n]) if n in resume else None, device="cpu")
            for n, c in runs.items()]


@pytest.fixture(scope="module")
def four(tmp_path_factory, train_data):
    """The port at every layout in one 4-process spawn (3 steps with the
    clip and the EMA, the weights kept after each; the first is the
    one-step case), the misfit batch and mesh, ``train_diffphar`` for one
    epoch at dp=4 resumed for the second at FSDP x tp, and JAX's
    single-device and dp=4 runs of the same steps, computed while the
    ranks run."""
    jmodel, params, cfg, leaves = _model()
    keys = [jax.random.PRNGKey(13 + i) for i in range(3)]
    batches = [_batch(1 + i) for i in range(3)]
    draws = [_draws(jmodel, b, k) for b, k in zip(batches, keys)]
    names = ["plain", *LAYOUTS]
    jobs = [dict(kind="steps", cfg=cfg, leaves=leaves, batches=batches, draws=draws,
                 layout=LAYOUTS.get(name), ema_decay=EMA, device="cpu") for name in names]
    odd = [[a[:B - 2] for a in batches[0]]], [[d[:B - 2] for d in draws[0]]]
    jobs.append(dict(kind="steps", cfg=cfg, leaves=leaves, batches=odd[0], draws=odd[1],
                     layout=dict(dp=4), device="cpu"))
    jobs.append(dict(kind="steps", cfg=cfg, leaves=leaves, batches=batches[:1],
                     draws=draws[:1], layout=dict(dp=2), device="cpu"))
    # one epoch at dp=4, resumed for the second at FSDP x tp
    root = tmp_path_factory.mktemp("four")
    jobs += _train_jobs(train_data, root, {
        "first_dp4": _tiny_train_config(dp=4, n_epochs=1),
        "resumed_fsdp_dp2_tp2": _tiny_train_config(dp=2, tp=2, fsdp=True)},
        resume={"resumed_fsdp_dp2_tp2": "first_dp4"})
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch.spawn, check.run_jobs, 4, jobs,
                            init_method=f"file://{root / 'store'}", device="cpu")
        ref = {"jax": _jax_steps(jmodel, params, batches, keys),
               "jax_dp4": _jax_steps(jmodel, params, batches, keys, jmesh.make_mesh(dp=4, tp=1))}
        got = ranks.result()[0]
    return dict(port=dict(zip(names, got)), ref=ref, odd=got[-4], short=got[-3], params=params,
                cfg=cfg, leaves=leaves, root=root, resumed=got[-1])


def _after(run, n):
    """A run as it stood after ``n`` steps (its EMA only at the end)."""
    return {"params": run["history"][n - 1], "losses": run["losses"][:n],
            "ema": run.get("ema") if n == len(run["history"]) else None}


STEPS = pytest.mark.parametrize("n", [1, 3], ids=["one_step", "three_steps_clip_ema"])


@STEPS
def test_plain_step_matches_jax(four, n):
    port, ref = four["port"], four["ref"]
    _close(_after(port["plain"], n), _after(ref["jax"], n), "plain vs jax")
    _close(_after(port["plain"], n), _after(ref["jax_dp4"], n), "plain vs jax dp=4")


@STEPS
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layout_step_matches_single_process_and_jax(four, layout, n):
    """A step at dp=4, dp=2 x tp=2, FSDP dp=4 and FSDP x tp equals the
    port's single-process step and JAX's single-device and dp=4 steps:
    weights, EMA, loss; and, after three, the port's optimizer state,
    queue and norms."""
    port, ref = four["port"], four["ref"]
    got, plain = port[layout], port["plain"]
    _close(_after(got, n), _after(plain, n), f"{layout} vs plain")
    _close(_after(got, n), _after(ref["jax"], n), f"{layout} vs jax")
    _close(_after(got, n), _after(ref["jax_dp4"], n), f"{layout} vs jax dp=4")
    np.testing.assert_allclose(got["grad_norms"][:n], plain["grad_norms"][:n], rtol=1e-5)
    if n == 3:
        for k, v in plain["opt_state"].items():
            np.testing.assert_allclose(got["opt_state"][k], v, atol=1e-6, rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(got["queue"], plain["queue"], rtol=1e-5)


def test_layouts_shard_as_jax_does(four):
    """At tp=2 the port splits exactly the leaves JAX's rule splits (the
    torch weight's dim 0 for flax's last axis); FSDP places every leaf on
    dp, and under FSDP x tp the split leaves carry both axes."""
    placed = {name: run["placements"] for name, run in four["port"].items()}
    leaves = four["leaves"]
    m = jmesh.make_mesh(dp=4, tp=2)
    tp_split = {k: jmesh.tp_sharding(v, m).spec != jmesh.P() for k, v in leaves.items()}
    assert any(tp_split.values()) and not all(tp_split.values())
    for k, split in tp_split.items():
        assert (placed["dp2_tp2"][k] == {"tp": "S(0)"}) == split, k
        both = placed["fsdp_dp2_tp2"][k]
        assert "dp" in both and (both.get("tp", "R") != "R") == split, (k, both)
        assert "dp" in placed["fsdp_dp4"][k], k
        assert placed["dp4"][k] == {}, k


def test_eligibility_rule_matches_jax(four):
    """``tp_eligible`` is JAX's ``_tp_eligible`` on every leaf of a small
    model and several tp; a port Linear is split iff its kernel is."""
    cfg, leaves = four["cfg"], four["leaves"]
    for tp in (1, 2, 3, 4, 8):
        for k, v in leaves.items():
            assert pmesh.tp_eligible(v.shape, tp) == jmesh._tp_eligible(v, tp), (k, tp)
    model = convert.build_model(cfgmod.from_dict(cfgmod.DiffPharConfig, cfg), leaves, "cpu")
    names = convert.flax_names(model)
    for name, lin in model.dynamics.named_modules():
        if isinstance(lin, torch.nn.Linear):
            kernel = leaves[names[f"{name}.weight"]]
            for tp in (2, 4):
                assert pmesh.linear_tp_eligible(lin, tp) == jmesh._tp_eligible(kernel, tp)


def test_batch_not_dividing_by_dp_raises(four):
    assert "does not divide by dp=4" in four["odd"]["ValueError"]


def test_mesh_not_filling_the_world_raises(four):
    assert "must equal the world size 4" in four["short"]["ValueError"]


# ------------------------------------------------------------ 2 processes

@pytest.fixture(scope="module")
def two(tmp_path_factory, train_data):
    """One 2-process spawn: the joint model's step at dp=2, the learned
    schedule's at FSDP dp=2, ``train_diffphar`` at dp=2 and at FSDP dp=2
    (2 epochs), and at dp=2 for one epoch (to resume from), resumed for
    the second at FSDP dp=2; and, while the ranks run, the single-process
    runs they are held to."""
    from cmdgen_tpu_torch.train import diffphar_train

    root = tmp_path_factory.mktemp("two")
    data = train_data
    jobs = []
    for cfg in (_tiny_train_config(mode="joint"),
                dataclasses.replace(_tiny_train_config(), ddpm=dataclasses.replace(
                    _tiny_train_config().ddpm, noise_schedule="learned", loss_type="vlb"))):
        if cfg.train.mode == "joint":
            cfg = dataclasses.replace(cfg, dynamics=dataclasses.replace(
                cfg.dynamics, update_pocket_coords=True))
        model = diffphar_train.build_model(cfg, None, "cpu", torch.Generator().manual_seed(2))
        leaves = convert.model_leaves(model)
        if model.gamma_net is not None:
            # gamma-net weights that keep its float32 normalisation well
            # conditioned (tests/test_torch_train_diffphar.py)
            leaves["gamma_net/l1/kernel"] = np.full((1, 1), 4.0, np.float32)
            leaves["gamma_net/l3/kernel"] = leaves["gamma_net/l3/kernel"] - 4.0
        batch = _batch(7)
        phar, pocket = check.clouds(batch, "cpu")
        draws = [d.numpy() for d in tstate.draw_loss_noise(model, phar, pocket,
                                                           torch.Generator().manual_seed(3))]
        jobs.append(dict(kind="steps", cfg=cfgmod.to_dict(cfg), leaves=leaves, batches=[batch],
                         draws=[draws], layout=dict(dp=2, fsdp=model.gamma_net is not None),
                         device="cpu"))
    trains = _train_jobs(data, root, {
        "dp2": _tiny_train_config(dp=2), "fsdp_dp2": _tiny_train_config(dp=2, fsdp=True),
        "first_dp2": _tiny_train_config(dp=2, n_epochs=1),
        "resumed_fsdp_dp2": _tiny_train_config(dp=2, fsdp=True)},
        resume={"resumed_fsdp_dp2": "first_dp2"})
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch.spawn, check.run_jobs, 2, jobs + trains,
                            init_method=f"file://{root / 'store'}", device="cpu")
        plain = check.run_jobs([dict(j, layout=None) for j in jobs])
        world1 = diffphar_train.train_diffphar(_tiny_train_config(), data, root / "world1",
                                               device="cpu")
        got = ranks.result()[0]
    return dict(root=root, data=data, got=got, plain=plain, world1=world1)


def test_joint_step_at_dp2_matches(two):
    """(The port's single-process joint step is held to JAX's in
    tests/test_torch_train_diffphar.py.)"""
    _close(_after(two["got"][0], 1), _after(two["plain"][0], 1), "joint dp=2 vs plain")


def test_learned_schedule_fsdp_dp2_matches(two):
    """The gamma network stays replicated under FSDP; its gradient is
    averaged over dp like the rest. Its normalisation cancels most of its
    gradient, so Adam's first update (about +-lr for any element above
    eps) takes the sign of rounding for many of its elements: the gamma
    network is held by its gradient (the first moment, 0.1 g) within 1e-3
    of each leaf's largest plus 1e-5 of the tree's largest, the tolerance
    of tests/test_torch_train_diffphar.py; every other weight and the loss
    as at the other layouts."""
    got, plain = two["got"][1], two["plain"][1]
    gamma = [k for k in plain["params"] if k.startswith("gamma_net/")]
    assert gamma
    _close({"params": {k: v for k, v in got["params"].items() if k not in gamma},
            "losses": got["losses"]},
           {"params": {k: v for k, v in plain["params"].items() if k not in gamma},
            "losses": plain["losses"]}, "learned fsdp dp=2 vs plain")
    mu = {k[3:]: v for k, v in plain["opt_state"].items() if k.startswith("mu/")}
    top = max(np.abs(v).max() for v in mu.values())
    for k in gamma:
        want = mu[k]
        np.testing.assert_allclose(got["opt_state"][f"mu/{k}"], want, rtol=0,
                                   atol=1e-3 * np.abs(want).max() + 1e-5 * top, err_msg=k)


def _ckpt(run_dir, name="last"):
    out = {}
    for f in ("params", "ema_params", "opt_state"):
        with np.load(run_dir / name / f"{f}.npz") as npz:
            out[f] = {k: npz[k] for k in npz.files}
    return out, json.loads((run_dir / f"{name}.json").read_text())


@pytest.mark.parametrize("run", ["dp2", "fsdp_dp2"])
def test_train_diffphar_checkpoint_matches_world1(two, run):
    """Rank 0 writes whole arrays in the single-process format: the same
    arrays, step and validation loss as the world-1 run, in best/ and
    last/."""
    root = two["root"]
    assert two["got"][2 + ["dp2", "fsdp_dp2"].index(run)] == {"step": 4}
    for name in ("best", "last"):
        got, gmeta = _ckpt(root / run, name)
        want, wmeta = _ckpt(root / "world1", name)
        for f, arrays in want.items():
            assert sorted(got[f]) == sorted(arrays)
            for k, v in arrays.items():
                np.testing.assert_allclose(got[f][k], v, atol=W_ATOL, rtol=0, err_msg=f"{f} {k}")
        assert gmeta["step"] == wmeta["step"] and gmeta["epoch"] == wmeta["epoch"]
        assert gmeta["monitor"] == pytest.approx(wmeta["monitor"], rel=L_RTOL)


@pytest.mark.parametrize("run", ["dp2", "fsdp_dp2"])
def test_dp2_checkpoint_loads_and_samples(two, tmp_path, run):
    """``load_port_checkpoint`` reads the EMA of best/ and ``sample-phars``
    samples from the run's directory with both engines."""
    from cmdgen_tpu_torch import cli
    from cmdgen_tpu_torch.utils.synthetic import synthetic_pocket_pdb

    run = two["root"] / run
    model, _ = convert.load_port_checkpoint(run, "cpu")
    ema, _ = _ckpt(run, "best")
    got = convert.model_leaves(model)
    for k, v in ema["ema_params"].items():
        np.testing.assert_array_equal(got[k], v)
    pdb = tmp_path / "pocket.pdb"
    pdb.write_text(synthetic_pocket_pdb(np.random.RandomState(0), 30))
    for engine in ("msgpass", "fused"):
        out = tmp_path / f"{engine}.json"
        cli.main(["sample-phars", str(run), str(pdb), str(out), "--ref-ligand", "L:1",
                  "--n-samples", "3", "--timesteps", "4", "--engine", engine, "--device", "cpu"])
        assert len(json.loads(out.read_text())) == 3


def _same_last_checkpoint(run_dir, world1_dir):
    got, _ = _ckpt(run_dir)
    want, _ = _ckpt(world1_dir)
    for f, arrays in want.items():
        for k, v in arrays.items():
            np.testing.assert_allclose(got[f][k], v, atol=W_ATOL, rtol=0, err_msg=f"{f} {k}")


def test_dp2_run_resumes_at_world1(two):
    """One epoch at dp=2, resumed for the second at world 1, ends where
    the continuous world-1 run ends."""
    from cmdgen_tpu_torch.train import diffphar_train

    root = two["root"]
    st = diffphar_train.train_diffphar(_tiny_train_config(), two["data"], root / "resumed",
                                       resume_from=root / "first_dp2", device="cpu")
    assert st.step == two["world1"].step == 4
    _same_last_checkpoint(root / "resumed", root / "world1")


@pytest.mark.parametrize("layout", ["fsdp_dp2", "fsdp_dp2_tp2"])
def test_resume_into_a_sharded_layout_matches_world1(four, two, layout):
    """One epoch at dp=2 (or dp=4), resumed for the second at FSDP dp=2
    (or FSDP x tp on 4 processes): the whole checkpoint is cut into this
    layout's shards (FSDP's uneven dim-0 shards, and under tp the strided
    ones), optimizer moments and EMA with it, and the run ends where the
    continuous world-1 run ends."""
    run = {"fsdp_dp2": (two["got"][-1], two["root"] / "resumed_fsdp_dp2"),
           "fsdp_dp2_tp2": (four["resumed"], four["root"] / "resumed_fsdp_dp2_tp2")}[layout]
    assert run[0] == {"step": 4}
    _same_last_checkpoint(run[1], two["root"] / "world1")
