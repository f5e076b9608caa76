"""The port's EGNN against flax on both engines (dense and neighbor list),
the exactness of the static ``update_rows`` receiver slice, and the
dynamics' NaN guard. f32, the JAX suite's tolerances."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from cmdgen_tpu.config import to_dict
from cmdgen_tpu.models.dynamics import DynamicsConfig, EGNNDynamics
from cmdgen_tpu.models.egnn import EGNN, EGNNConfig
from cmdgen_tpu.ops.masked import pair_mask
from cmdgen_tpu_torch.config import from_dict
from cmdgen_tpu_torch.convert import dynamics_state_dict, load_flax_params
from cmdgen_tpu_torch.models.dynamics import DynamicsConfig as TDynamicsConfig
from cmdgen_tpu_torch.models.dynamics import EGNNDynamics as TEGNNDynamics
from cmdgen_tpu_torch.models.egnn import EGNN as TEGNN
from cmdgen_tpu_torch.models.egnn import EGNNConfig as TEGNNConfig

torch.set_num_threads(1)

SMALL = EGNNConfig(hidden_nf=32, n_layers=2, inv_sublayers=1)
D = 6


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(1)
    b, n = 2, 12
    h = rng.randn(b, n, D).astype(np.float32)
    x = rng.randn(b, n, 3).astype(np.float32)
    mask = (np.arange(n)[None, :] < np.array([8, 12])[:, None]).astype(np.float32)
    em = np.asarray(pair_mask(mask, mask))
    params = EGNN(SMALL, out_node_nf=D).init(jax.random.PRNGKey(0), h, x, em, mask)
    return params, h, x, mask, em


def port_egnn(cfg, params):
    egnn = TEGNN(from_dict(TEGNNConfig, to_dict(cfg)), D, D)
    egnn.load_state_dict(dynamics_state_dict(
        jax.tree_util.tree_map(np.asarray, params["params"])))
    return egnn.eval()


def _run_both(cfg, params, *args):
    ref = EGNN(cfg, out_node_nf=D).apply(params, *args)
    targs = [a if a is None or isinstance(a, int) else torch.from_numpy(np.asarray(a))
             for a in args]
    with torch.no_grad():
        out = port_egnn(cfg, params)(*targs)
    return [np.asarray(r) for r in ref], [o.numpy() for o in out]


@pytest.mark.parametrize("neighbor_k", [None, 12, 6])
@pytest.mark.parametrize("cutoff", [None, 2.0])
def test_egnn_matches_flax(setup, neighbor_k, cutoff):
    """Dense engine, neighbor list covering every edge, and a truncating
    neighbor list (tie-free gaussian geometry), with and without a cutoff."""
    params, h, x, mask, em = setup
    if cutoff is not None:
        d2 = ((x[:, :, None] - x[:, None]) ** 2).sum(-1)
        em = em * (d2 <= cutoff).astype(np.float32)
    cfg = dataclasses.replace(SMALL, neighbor_k=neighbor_k)
    (rh, rx), (oh, ox) = _run_both(cfg, params, h, x, em, mask)
    np.testing.assert_allclose(oh, rh, atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(ox, rx, atol=2e-4, rtol=1e-4)


def test_egnn_mean_aggregation_matches_flax(setup):
    params, h, x, mask, em = setup
    for k in (None, 8):
        cfg = dataclasses.replace(SMALL, aggregation_method="mean", neighbor_k=k)
        (rh, rx), (oh, ox) = _run_both(cfg, params, h, x, em, mask)
        np.testing.assert_allclose(oh, rh, atol=2e-4, rtol=1e-4)
        np.testing.assert_allclose(ox, rx, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("neighbor_k", [None, 6])
def test_update_rows_exact(setup, neighbor_k):
    """Slicing the coordinate pass to the first r receivers equals computing
    every receiver and masking, and matches flax's update_rows path."""
    params, h, x, mask, em = setup
    r = 3
    ucm = ((np.arange(x.shape[1])[None] < r) * np.ones((x.shape[0], 1))).astype(np.float32)
    cfg = dataclasses.replace(SMALL, neighbor_k=neighbor_k)
    egnn = port_egnn(cfg, params)
    t = [torch.from_numpy(v) for v in (h, x, em, mask, ucm)]
    with torch.no_grad():
        h1, x1 = egnn(*t)
        h2, x2 = egnn(*t, r)
    torch.testing.assert_close(h2, h1, atol=1e-6, rtol=0)
    torch.testing.assert_close(x2, x1, atol=1e-6, rtol=0)
    (rh, rx), (oh, ox) = _run_both(cfg, params, h, x, em, mask, ucm, r)
    np.testing.assert_allclose(oh, rh, atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(ox, rx, atol=2e-4, rtol=1e-4)


def test_nan_guard_zeroes_velocities():
    """A NaN pharmacophore coordinate makes the EGNN's coordinates NaN; the
    dynamics zero those velocities, as flax's does."""
    cfg = DynamicsConfig(phar_nf=8, residue_nf=5, joint_nf=8, edge_cutoff=None,
                         egnn=EGNNConfig(hidden_nf=16, n_layers=1, neighbor_k=None))
    rng = np.random.RandomState(0)
    xh_p = rng.randn(1, 3, 11).astype(np.float32)
    xh_q = rng.randn(1, 4, 8).astype(np.float32)
    xh_p[0, 0, 0] = np.nan
    args = (xh_p, xh_q, np.zeros((1, 1), np.float32), np.ones((1, 3), np.float32),
            np.ones((1, 4), np.float32))
    params = EGNNDynamics(cfg).init(jax.random.PRNGKey(0), *args)
    ref_p, _ = EGNNDynamics(cfg).apply(params, *args)
    dyn = TEGNNDynamics(from_dict(TDynamicsConfig, to_dict(cfg)))
    load_flax_params(dyn, jax.tree_util.tree_map(np.asarray, params["params"]))
    with torch.no_grad():
        out_p, _ = dyn(*[torch.from_numpy(a) for a in args])
    vel, ref_vel = out_p[..., :3].numpy(), np.asarray(ref_p)[..., :3]
    assert not np.isnan(vel).any()
    np.testing.assert_array_equal(np.isnan(vel), np.isnan(ref_vel))
    np.testing.assert_array_equal(vel == 0, ref_vel == 0)


def test_unported_modes_raise():
    """Every dynamics mode and EGNN option is ported; the fused engine still
    refuses sin_embedding and the GNN mode (as make_pallas_apply asserts),
    and an unknown mode raises."""
    from cmdgen_tpu_torch.models.dynamics import make_fused_apply

    for cfg in (TDynamicsConfig(mode="gnn_dynamics"),
                TDynamicsConfig(egnn=TEGNNConfig(sin_embedding=True, neighbor_k=4))):
        with pytest.raises(ValueError, match="fused engine"):
            make_fused_apply(TEGNNDynamics(cfg))
    with pytest.raises(ValueError, match="unknown dynamics mode"):
        TEGNNDynamics(TDynamicsConfig(mode="egnn"))
