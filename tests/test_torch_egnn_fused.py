"""K2 parity: the port's fused EGNN (``cmdgen_tpu_torch.ops.egnn_fused``,
plain layers on the CPU) and the port's fused dynamics against the JAX
package's ``egnn_forward_fused`` / ``make_pallas_apply`` in interpret mode
at f32, with the JAX suite's tolerances."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmdgen_tpu.config import to_dict
from cmdgen_tpu.models.dynamics import DynamicsConfig, EGNNDynamics, make_pallas_apply
from cmdgen_tpu.models.egnn import EGNNConfig
from cmdgen_tpu.ops.egnn_fused import egnn_forward_fused as jax_egnn_forward_fused
from cmdgen_tpu.ops.masked import pair_mask
from cmdgen_tpu_torch.config import from_dict
from cmdgen_tpu_torch.convert import load_flax_params
from cmdgen_tpu_torch.models.dynamics import DynamicsConfig as TDynamicsConfig
from cmdgen_tpu_torch.models.dynamics import EGNNDynamics as TEGNNDynamics
from cmdgen_tpu_torch.models.dynamics import make_fused_apply
from cmdgen_tpu_torch.ops.egnn_fused import (
    egnn_forward_fused,
    egnn_forward_fused_plain,
    fused_params,
)

torch.set_num_threads(1)


def port_dynamics(cfg, params):
    dyn = TEGNNDynamics(from_dict(TDynamicsConfig, to_dict(cfg)))
    load_flax_params(dyn, jax.tree_util.tree_map(np.asarray, params["params"]))
    return dyn.eval()


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _setup(b=2, n_p=4, n_q=9, hidden=32, layers=2, cutoff=None, seed=0,
           k=None, joint=False):
    rng = np.random.RandomState(seed)
    cfg = DynamicsConfig(
        phar_nf=8, residue_nf=5, joint_nf=8, edge_cutoff=cutoff,
        update_pocket_coords=joint,
        egnn=EGNNConfig(hidden_nf=hidden, n_layers=layers, inv_sublayers=1,
                        neighbor_k=k if k is not None else n_p + n_q),
    )
    xh_p = (rng.randn(b, n_p, 3 + 8) * 2).astype(np.float32)
    xh_q = (rng.randn(b, n_q, 3 + 5) * 2).astype(np.float32)
    t = rng.rand(b, 1).astype(np.float32)
    m_p = (np.arange(n_p)[None, :] < np.array([n_p, n_p - 1])[:b, None]).astype(np.float32)
    m_q = (np.arange(n_q)[None, :] < np.array([n_q, n_q - 2])[:b, None]).astype(np.float32)
    params = EGNNDynamics(cfg).init(jax.random.PRNGKey(1), xh_p, xh_q, t, m_p, m_q)
    return cfg, params, (xh_p, xh_q, t, m_p, m_q)


def _check_fused_dynamics(cfg, params, inputs, atol, rtol):
    ref_p, ref_q = make_pallas_apply(cfg, interpret=True,
                                     compute_dtype=jnp.float32)(params, *inputs)
    dyn = port_dynamics(cfg, params)
    with torch.no_grad():
        out_p, out_q = make_fused_apply(dyn)(*_t(*inputs))
    np.testing.assert_allclose(out_p.numpy(), np.asarray(ref_p), atol=atol, rtol=rtol)
    np.testing.assert_allclose(out_q.numpy(), np.asarray(ref_q), atol=atol, rtol=rtol)


@pytest.mark.parametrize("update_rows", [3, None])
def test_egnn_forward_fused_plain_matches_pallas_interpret(update_rows):
    rng = np.random.RandomState(5)
    b, n, d_in, k = 2, 10, 9, 6
    cfg, params, _ = _setup(hidden=32, layers=2, k=k)
    egnn_p = params["params"]["egnn"]
    h = rng.randn(b, n, d_in).astype(np.float32)
    x = (rng.randn(b, n, 3) * 2).astype(np.float32)
    mask = (np.arange(n)[None] < np.array([[n], [n - 2]])).astype(np.float32)
    em = np.asarray(pair_mask(mask, mask))
    ucm = None if update_rows is None else (
        (np.arange(n)[None] < update_rows) * mask).astype(np.float32)
    # the flax init above used D_in = joint_nf + 1 = 9 input features
    ref_h, ref_x = jax_egnn_forward_fused(
        egnn_p, h, x, em, mask, ucm, n_layers=2, out_node_nf=9, neighbor_k=k,
        update_rows=update_rows, interpret=True, compute_dtype=jnp.float32)
    dyn = port_dynamics(cfg, params)
    with torch.no_grad():
        p = fused_params(dyn.egnn, torch.float32)
        tucm = None if ucm is None else torch.from_numpy(ucm)
        th, tx, tem, tmask = _t(h, x, em, mask)
        out_h, out_x = egnn_forward_fused_plain(
            p, th, tx, tem, tmask, tucm, n_layers=2, neighbor_k=k,
            update_rows=update_rows, compute_dtype=torch.float32)
        before = egnn_forward_fused.launches
        out_h2, out_x2 = egnn_forward_fused(
            p, th, tx, tem, tmask, tucm, n_layers=2, neighbor_k=k,
            update_rows=update_rows, compute_dtype=torch.float32)
    assert egnn_forward_fused.launches == before
    np.testing.assert_allclose(out_h.numpy(), np.asarray(ref_h), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(out_x.numpy(), np.asarray(ref_x), atol=2e-4, rtol=1e-4)
    torch.testing.assert_close(out_h2, out_h, rtol=0, atol=0)
    torch.testing.assert_close(out_x2, out_x, rtol=0, atol=0)


@pytest.mark.parametrize("cutoff", [None, 4.0])
def test_fused_dynamics_matches_jax_conditional(cutoff):
    cfg, params, inputs = _setup(cutoff=cutoff)
    _check_fused_dynamics(cfg, params, inputs, 2e-4, 1e-4)


def test_fused_dynamics_matches_jax_joint_mode():
    """update_pocket_coords=True: every row moves, remove_mean on vel."""
    cfg, params, inputs = _setup(n_p=3, n_q=7, seed=3, joint=True)
    _check_fused_dynamics(cfg, params, inputs, 2e-4, 1e-4)


def test_fused_dynamics_k_truncation_matches_jax():
    """K below the neighbor count on tie-free (gaussian) geometry."""
    cfg, params, inputs = _setup(n_p=4, n_q=12, k=8)
    _check_fused_dynamics(cfg, params, inputs, 2e-4, 1e-4)


def test_fused_dynamics_flagship_like_shape_matches_jax():
    cfg, params, inputs = _setup(b=2, n_p=8, n_q=30, hidden=64, layers=3,
                                 cutoff=6.0, seed=7, k=12)
    _check_fused_dynamics(cfg, params, inputs, 5e-4, 5e-4)


def test_fused_engine_matches_msgpass_engine():
    """The two port engines compute the same dynamics at f32."""
    cfg, params, inputs = _setup(cutoff=4.0, k=6)
    dyn = port_dynamics(cfg, params)
    with torch.no_grad():
        a = dyn(*_t(*inputs))
        b = make_fused_apply(dyn)(*_t(*inputs))
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, atol=2e-4, rtol=1e-4)


def test_fused_apply_rejects_unsupported_configs():
    cfg, params, _ = _setup()
    dyn = port_dynamics(dataclasses.replace(
        cfg, egnn=dataclasses.replace(cfg.egnn, neighbor_k=None)), params)
    with pytest.raises(ValueError, match="neighbor_k"):
        make_fused_apply(dyn)
