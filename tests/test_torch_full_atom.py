"""``full_atom_config`` (the CLI's default DiffPhar configuration: a full-atom
pocket in 11 element classes, 3 EGNN layers, polynomial_2, T=100) in the
port against the JAX package on the CPU at f32, on full-atom complexes that
``preprocess`` made at its defaults (``crossdock_full``, ``full-atom``).

The complexes: an aminophenol ligand in pockets of ~40 heavy atoms from
``utils.synthetic.full_atom_pocket_pdb`` (backbone and side chains, real
elements: the one-hot sets C, N, O and S). The width is cut to hidden 32
for the CPU; the element classes, the schedule, T and the layer count
stay. Held: ``preprocess``'s arrays against the JAX package's; the
denoiser on the dense engine against the JAX package's flax path, on the
neighbour list (K=16) through K1's plain version against its message-pass
Pallas kernel in interpret mode, and through K2's plain version against
its fused Pallas kernel in interpret mode; one train step (the config's
own: no clip, no EMA; dense) after two JAX steps carried across.

Tolerances: values atol 2e-4 / rtol 1e-4; the weights after the step
atol 2e-6 / rtol 1e-5 (as ``tests/test_torch_train_diffphar.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmdgen_tpu import config as jcfgmod
from cmdgen_tpu.containers import PointCloud as JPointCloud
from cmdgen_tpu.data import crossdocked as jcrossdocked
from cmdgen_tpu.diffusion.cddpm import ConditionalDDPM as JConditionalDDPM
from cmdgen_tpu.diffusion.cddpm import sample_t_int as jsample_t_int
from cmdgen_tpu.models.dynamics import EGNNDynamics, make_pallas_apply
from cmdgen_tpu.train import state as jstate
from cmdgen_tpu_torch import cli, convert
from cmdgen_tpu_torch.chem.sdf import write_sdf
from cmdgen_tpu_torch.config import DiffPharConfig, from_dict
from cmdgen_tpu_torch.containers import PointCloud
from cmdgen_tpu_torch.data.dataset import DiffPharDataset
from cmdgen_tpu_torch.models.dynamics import make_fused_apply
from cmdgen_tpu_torch.train import state as tstate
from cmdgen_tpu_torch.utils.synthetic import full_atom_pocket_pdb

torch.set_num_threads(1)

TOL = dict(atol=2e-4, rtol=1e-4)
HIDDEN, K, N_COMPLEX = 32, 16, 3

# 4-aminophenol, planar (kekulé ring)
_ANG = np.deg2rad(np.arange(6) * 60.0)
_RING = np.stack([1.39 * np.cos(_ANG), 1.39 * np.sin(_ANG), np.zeros(6)], 1)
LIGAND = (["C"] * 6 + ["O", "N"],
          np.concatenate([_RING, _RING[[0]] * 2.0, _RING[[3]] * 2.05]))
BONDS = [(0, 1, 2), (1, 2, 1), (2, 3, 2), (3, 4, 1), (4, 5, 2), (5, 0, 1), (0, 6, 1),
         (3, 7, 1)]


def _jcfg(neighbor_k=None, msgpass_pallas=False):
    """The JAX package's full_atom_config at hidden 32."""
    cfg = jcfgmod.full_atom_config()
    egnn = dataclasses.replace(cfg.dynamics.egnn, hidden_nf=HIDDEN, neighbor_k=neighbor_k,
                               msgpass_pallas=msgpass_pallas)
    return dataclasses.replace(cfg, dynamics=dataclasses.replace(cfg.dynamics, egnn=egnn))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """preprocess (the port's CLI at its defaults) on N_COMPLEX pairs, the
    JAX package's process_dataset on the same; (npz directory, the JAX
    package's, pocket atoms written)."""
    tmp = tmp_path_factory.mktemp("full_atom")
    rng = np.random.RandomState(0)
    rows, atoms = [], []
    for i in range(N_COMPLEX):
        q, _ = np.linalg.qr(rng.randn(3, 3))
        lig = LIGAND[1] @ q + rng.randn(3) * 5.0
        text, n = full_atom_pocket_pdb(rng, LIGAND[0], lig, 6, max_atoms=44)
        (tmp / f"pocket_{i}.pdb").write_text(text)
        write_sdf(tmp / f"ligand_{i}.sdf", [(LIGAND[0], lig, f"ligand_{i}")],
                  bonds_list=[BONDS])
        rows.append(("train" if i < N_COMPLEX - 1 else "val", str(tmp / f"pocket_{i}.pdb"),
                     str(tmp / f"ligand_{i}.sdf")))
        atoms.append(n)
    (tmp / "pairs.tsv").write_text("\n".join("\t".join(r) for r in rows) + "\n")
    stats = cli.main(["preprocess", str(tmp / "pairs.tsv"), str(tmp / "port")])
    assert stats == {"n_failed": 0, "splits": {"train": N_COMPLEX - 1, "val": 1}}
    jcrossdocked.process_dataset(rows, tmp / "jax")
    return tmp / "port", tmp / "jax", atoms


def _batch(data):
    """Every complex padded to one batch, as numpy: (phar x, h, mask,
    pocket x, h, mask)."""
    port, _, _ = data
    arrays = [DiffPharDataset(port / f"{s}.npz").padded_batch([i]) for s, i in
              (("train", 0), ("train", 1), ("val", 0))]
    keys = ("phar_x", "phar_h", "phar_mask", "pocket_x", "pocket_h", "pocket_mask")
    out = []
    for k in keys:
        n = max(a[k].shape[1] for a in arrays)
        out.append(np.concatenate([np.pad(a[k], [(0, 0), (0, n - a[k].shape[1])] +
                                          [(0, 0)] * (a[k].ndim - 2)) for a in arrays]))
    return [a.astype(np.float32) for a in out]


def test_preprocess_full_atom_matches_jax(data):
    """Every pocket atom reaches the npz, in 4 element classes; the arrays
    equal the JAX package's."""
    port, jax_dir, atoms = data
    for split in ("train", "val"):
        with np.load(port / f"{split}.npz") as g, np.load(jax_dir / f"{split}.npz") as w:
            assert sorted(g.files) == sorted(w.files)
            for k in w.files:
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"{split} {k}")
    ds = [DiffPharDataset(port / f"{s}.npz") for s in ("train", "val")]
    assert sorted(np.concatenate([d.sizes()[1] for d in ds]).tolist()) == sorted(atoms)
    onehot = np.concatenate([np.concatenate(d.pocket_one_hot) for d in ds])
    assert onehot.shape[1] == 11 and set(np.flatnonzero(onehot.sum(0))) == {0, 1, 2, 3}
    assert 30 <= min(atoms) and max(atoms) <= 44


@pytest.fixture(scope="module")
def params(data):
    px, ph, pm, qx, qh, qm = _batch(data)
    xh_p, xh_q = np.concatenate([px, ph / 4], -1), np.concatenate([qx, qh / 4], -1)
    t = np.random.RandomState(1).rand(len(pm), 1).astype(np.float32)
    inputs = (xh_p, xh_q, t, pm, qm)
    p = jax.jit(EGNNDynamics(_jcfg().dynamics).init)(jax.random.PRNGKey(2), *inputs)
    return jax.tree_util.tree_map(np.asarray, p), inputs


def _port_model(p, neighbor_k=None, engine="msgpass"):
    cfg = from_dict(DiffPharConfig, jcfgmod.to_dict(_jcfg(neighbor_k)))
    return convert.build_model(cfg, p, "cpu", engine)


@pytest.mark.parametrize("engine", ["dense", "msgpass", "fused"])
def test_denoiser_matches_jax(params, engine):
    """The denoiser on each engine: the port's against the JAX package's
    on the same weights and inputs (K=16 of ~50 rows on the neighbour
    list)."""
    p, inputs = params
    if engine == "dense":
        ref = EGNNDynamics(_jcfg().dynamics).apply(p, *inputs)
        fn = _port_model(p).dynamics
    elif engine == "msgpass":
        ref = EGNNDynamics(_jcfg(K, msgpass_pallas=True).dynamics).apply(p, *inputs)
        fn = _port_model(p, K).dynamics
    else:
        ref = make_pallas_apply(_jcfg(K).dynamics, interpret=True,
                                compute_dtype=jnp.float32)(p, *inputs)
        fn = make_fused_apply(_port_model(p, K, "fused").dynamics)
    assert inputs[1].shape[1] > K
    with torch.no_grad():
        out = fn(*(torch.from_numpy(a) for a in inputs))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)


def test_train_step_matches_jax(data, params):
    """full_atom_config's own step (AMSGrad at lr 1e-4, no clip, no EMA) on
    the dense engine: two JAX steps carried across, then one more in each
    on the same batch and draws: the loss, the raw norm and every weight."""
    p, _ = params
    jcfg = _jcfg()
    px, ph, pm, qx, qh, qm = _batch(data)
    jphar = JPointCloud(jnp.asarray(px), jnp.asarray(ph), jnp.asarray(pm))
    jpocket = JPointCloud(jnp.asarray(qx), jnp.asarray(qh), jnp.asarray(qm))
    jmodel = JConditionalDDPM(jcfg.ddpm, EGNNDynamics(jcfg.dynamics))
    tc = jcfg.train
    assert (tc.clip_grad, tc.lr, jcfg.ddpm.timesteps, jcfg.ddpm.noise_schedule) == (
        False, 1e-4, 100, "polynomial_2")
    opt = jstate.reference_optimizer(tc.lr)
    jstep = jax.jit(jstate.make_diffusion_train_step(jmodel, opt, clip_grad=tc.clip_grad))
    st = jstate.init_state(p, opt)
    for seed in (11, 12):
        st, _ = jstep(st, jax.random.PRNGKey(seed), jphar, jpocket)
    tmodel = _port_model(jax.tree_util.tree_map(np.asarray, st.params))
    topt = tstate.reference_optimizer(tmodel.parameters(), tc.lr)
    convert.load_optimizer_arrays(tmodel, topt, convert.port_opt_state(
        jax.tree_util.tree_map(np.asarray, st.opt_state)))
    tst = tstate.init_state(tmodel, topt)
    tst.step = int(st.step)
    key = jax.random.PRNGKey(13)
    k_t, k_eps, k_eps0 = jax.random.split(key, 3)
    m = jphar.mask[..., None]
    shape = (*pm.shape, 3 + ph.shape[-1])
    draws = (jsample_t_int(k_t, len(pm), 0, jcfg.ddpm.timesteps),
             jax.random.normal(k_eps, shape) * m, jax.random.normal(k_eps0, shape) * m)
    st, jmet = jstep(st, key, jphar, jpocket)
    tphar = PointCloud(*(torch.from_numpy(a) for a in (px, ph, pm)))
    tpocket = PointCloud(*(torch.from_numpy(a) for a in (qx, qh, qm)))
    tmet = tstate.make_diffusion_train_step(clip_grad=tc.clip_grad)(
        tst, tphar, tpocket, noise=[torch.from_numpy(np.array(d)) for d in draws])
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), **TOL)
    np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-3)
    ref = convert.flatten_params(jax.tree_util.tree_map(np.asarray, st.params["params"]))
    got = convert.model_leaves(tmodel)
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        np.testing.assert_allclose(got[k], r, atol=2e-6, rtol=1e-5, err_msg=k)
