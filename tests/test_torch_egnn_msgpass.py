"""K1 parity: the port's GCL message pass (``cmdgen_tpu_torch.ops.egnn_msgpass``,
plain version on the CPU) and the port's dynamics on the neighbor-list engine
against the JAX package's Pallas kernel in interpret mode, at f32, with the
JAX suite's tolerances (atol 2e-4 / rtol 1e-4; 5e-4 at the flagship-like
shape). The same numpy-seeded inputs and the same flax params drive both."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmdgen_tpu.config import to_dict
from cmdgen_tpu.models.dynamics import DynamicsConfig, EGNNDynamics
from cmdgen_tpu.models.egnn import EGNNConfig
from cmdgen_tpu.ops.egnn_msgpass import gcl_message_agg as jax_gcl_message_agg
from cmdgen_tpu_torch.config import from_dict
from cmdgen_tpu_torch.convert import load_flax_params
from cmdgen_tpu_torch.models.dynamics import DynamicsConfig as TDynamicsConfig
from cmdgen_tpu_torch.models.dynamics import EGNNDynamics as TEGNNDynamics
from cmdgen_tpu_torch.ops.egnn_msgpass import gcl_message_agg, gcl_message_agg_plain

torch.set_num_threads(1)


def port_dynamics(cfg, params):
    dyn = TEGNNDynamics(from_dict(TDynamicsConfig, to_dict(cfg)))
    load_flax_params(dyn, jax.tree_util.tree_map(np.asarray, params["params"]))
    return dyn.eval()


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _setup(b=2, n_p=4, n_q=9, hidden=32, layers=2, cutoff=None, seed=0,
           attention=True, k=None):
    rng = np.random.RandomState(seed)
    cfg = DynamicsConfig(
        phar_nf=8, residue_nf=5, joint_nf=8, edge_cutoff=cutoff,
        egnn=EGNNConfig(
            hidden_nf=hidden, n_layers=layers, inv_sublayers=1,
            attention=attention,
            neighbor_k=k if k is not None else n_p + n_q,
        ),
    )
    xh_p = (rng.randn(b, n_p, 3 + 8) * 2).astype(np.float32)
    xh_q = (rng.randn(b, n_q, 3 + 5) * 2).astype(np.float32)
    t = rng.rand(b, 1).astype(np.float32)
    m_p = (np.arange(n_p)[None, :] < np.array([n_p, n_p - 1])[:b, None]).astype(np.float32)
    m_q = (np.arange(n_q)[None, :] < np.array([n_q, n_q - 2])[:b, None]).astype(np.float32)
    params = EGNNDynamics(cfg).init(jax.random.PRNGKey(1), xh_p, xh_q, t, m_p, m_q)
    return cfg, params, (xh_p, xh_q, t, m_p, m_q)


def _check_dynamics(cfg, params, inputs, atol, rtol):
    jdyn = EGNNDynamics(dataclasses.replace(
        cfg, egnn=dataclasses.replace(cfg.egnn, msgpass_pallas=True)))
    ref_p, ref_q = jdyn.apply(params, *inputs)
    with torch.no_grad():
        out_p, out_q = port_dynamics(cfg, params)(*_t(*inputs))
    np.testing.assert_allclose(out_p.numpy(), np.asarray(ref_p), atol=atol, rtol=rtol)
    np.testing.assert_allclose(out_q.numpy(), np.asarray(ref_q), atol=atol, rtol=rtol)


@pytest.mark.parametrize("attention", [True, False])
def test_gcl_message_agg_plain_matches_pallas_interpret(attention):
    rng = np.random.RandomState(3)
    b, n, k, h = 2, 11, 5, 32
    wi = rng.randn(b, n, h).astype(np.float32)
    wj = rng.randn(b, n, h).astype(np.float32)
    idx = rng.randint(0, n, size=(b, n, k)).astype(np.int32)
    radial = rng.rand(b, n, k).astype(np.float32) * 9
    dist0 = rng.rand(b, n, k).astype(np.float32) * 9
    kmask = (rng.rand(b, n, k) > 0.3).astype(np.float32)
    we = rng.randn(2, h).astype(np.float32) * 0.3
    w2 = rng.randn(h, h).astype(np.float32) / np.sqrt(h)
    w2b = rng.randn(h).astype(np.float32) * 0.1
    atk = rng.randn(h, 1).astype(np.float32) / np.sqrt(h)
    atb = rng.randn(1).astype(np.float32)
    att = (atk, atb) if attention else None
    ref = jax_gcl_message_agg(wi, wj, idx, radial, dist0, kmask, we, w2, w2b,
                              att, 100.0, compute_dtype=jnp.float32,
                              interpret=True)
    targs = _t(wi, wj, idx, radial, dist0, kmask, we, w2, w2b)
    tatt = tuple(_t(*att)) if attention else None
    out = gcl_message_agg_plain(*targs, tatt, 100.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-4)
    # the wrapper takes the plain version for CPU tensors, launching nothing
    before = gcl_message_agg.launches
    out2 = gcl_message_agg(*targs, tatt, 100.0)
    assert gcl_message_agg.launches == before
    torch.testing.assert_close(out2, out, rtol=0, atol=0)


@pytest.mark.parametrize("cutoff", [None, 4.0])
def test_msgpass_dynamics_matches_jax_conditional(cutoff):
    cfg, params, inputs = _setup(cutoff=cutoff)
    _check_dynamics(cfg, params, inputs, 2e-4, 1e-4)


def test_msgpass_k_truncation_matches_jax():
    """K below the true neighbor count: both keep the K nearest (random
    gaussian geometry has no distance ties)."""
    cfg, params, inputs = _setup(n_p=4, n_q=12, cutoff=None, k=8)
    _check_dynamics(cfg, params, inputs, 2e-4, 1e-4)


def test_msgpass_no_attention_matches_jax():
    cfg, params, inputs = _setup(attention=False, cutoff=4.0)
    _check_dynamics(cfg, params, inputs, 2e-4, 1e-4)


def test_msgpass_flagship_like_shape_matches_jax():
    """N = 8 + 130, H=64, K=12, 3 blocks."""
    cfg, params, inputs = _setup(b=2, n_p=8, n_q=130, hidden=64, layers=3,
                                 cutoff=6.0, seed=7, k=12)
    _check_dynamics(cfg, params, inputs, 5e-4, 5e-4)
