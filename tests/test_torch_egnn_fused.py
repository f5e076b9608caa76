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
    WEIGHT_NAMES,
    egnn_forward_fused,
    egnn_forward_fused_plain,
    fused_params,
    launch_plan,
    resize_stacks,
)
from cmdgen_tpu_torch.ops.egnn_msgpass import kernel_limits, padded_width

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


@pytest.mark.parametrize("hidden,n_q,k", [
    (100, 9, None),   # a width that is not a power of two
    (32, 136, 130),   # K = 130 over 140 rows: past one 128-row tile, chunked on the card
], ids=["H100", "K130"])
def test_fused_dynamics_matches_jax_at_any_width_and_k(hidden, n_q, k):
    """Shapes the JAX fused kernel takes and the port's K2 took only from
    this port on: the plain layers against ``make_pallas_apply`` in
    interpret mode."""
    cfg, params, inputs = _setup(n_q=n_q, hidden=hidden, k=k)
    _check_fused_dynamics(cfg, params, inputs, 2e-4, 1e-4)


@pytest.mark.parametrize("hidden,cdt", [(48, torch.bfloat16), (99, torch.float32)])
def test_fused_params_pad_once_to_the_kernel_width(hidden, cdt):
    """fused_params zero-pads every stack to the kernel's width at build,
    and the plain layers, which cut them back, give the same stack as
    unpadded weights; at float32 the fused engine still equals the msgpass
    engine."""
    from cmdgen_tpu_torch.models.egnn import EGNNConfig as TEGNNConfig

    cfg = TDynamicsConfig(phar_nf=8, residue_nf=5, joint_nf=8, edge_cutoff=4.0,
                          egnn=TEGNNConfig(hidden_nf=hidden, n_layers=2, inv_sublayers=1,
                                           neighbor_k=6, compute_dtype=cdt))
    torch.manual_seed(0)
    dyn = TEGNNDynamics(cfg).eval()
    hp = padded_width(hidden, cdt)
    assert hp > hidden
    with torch.no_grad():
        p = fused_params(dyn.egnn, cdt)
    for name in WEIGHT_NAMES:
        t = p[name]
        if name == "attb":
            continue
        assert t.shape[-1] == hp and t.is_contiguous()
        assert not t[..., hidden:].any()
        if t.dim() == 3 and t.shape[1] == hp:
            assert not t[:, hidden:].any()
    _, _, inputs = _setup(cutoff=4.0)
    args = [torch.from_numpy(a) for a in inputs]
    with torch.no_grad():
        h, x, mask, edge_mask, ucm = dyn._inputs(*args, lambda mlp, v: mlp.forward_f32(v))
        kw = dict(n_layers=2, neighbor_k=6, update_rows=4, compute_dtype=cdt)
        padded = egnn_forward_fused_plain(p, h, x, edge_mask, mask, ucm, **kw)
        cut = egnn_forward_fused_plain(resize_stacks(p, hidden), h, x, edge_mask, mask, ucm, **kw)
        for u, v in zip(padded, cut):
            torch.testing.assert_close(u, v, rtol=0, atol=0)
        if cdt == torch.float32:
            for u, v in zip(dyn(*args), make_fused_apply(dyn)(*args)):
                torch.testing.assert_close(u, v, atol=2e-4, rtol=1e-4)


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


ROW_CASES = [
    (48, 118, 12, 256, 8),   # the flagship shape
    (1, 37, 12, 256, 0),     # no movable rows
    (3, 130, 16, 128, 130),  # every row moves
    (160, 100, 12, 256, 8),
    (2, 12, 5, 32, 4),
    (2, 130, 128, 64, 3),    # one receiver per message tile
    (2, 140, 160, 256, 3),   # K past one tile: each receiver's edges in chunks
    (3, 50, 12, 640, 4),     # bf16 past 256: the block_gemm route, 96-row tiles
    (2, 20, 12, 48, 5),      # a width padded to 64
]
# float32: the regular variant (tiles of 128 rows fixed), its chunked
# build, the ragged variant at a width that is not a power of two, past
# 256 and chunked, and the cutoff-exact full-atom shape
F32_ROW_CASES = [
    (48, 118, 12, 256, 8), (2, 140, 160, 256, 3), (48, 118, 12, 100, 8),
    (3, 50, 12, 640, 4), (2, 20, 12, 48, 5), (2, 140, 160, 99, 3), (16, 522, 160, 256, 16),
]


@pytest.mark.parametrize("b,n,k,h,r,cdt", [
    pytest.param(*c, torch.bfloat16, id="-".join(map(str, c))) for c in ROW_CASES] + [
    pytest.param(*c, torch.float32, id="f32-" + "-".join(map(str, c))) for c in F32_ROW_CASES])
def test_launch_plan_covers_every_row_once(b, n, k, h, r, cdt):
    """The fused kernel's work items, from the wrapper's plan, cover each
    row, receiver and movable receiver exactly once at ragged shapes; the
    library variant matches the plan's tiles."""
    lim = kernel_limits()
    plan = launch_plan(b, n, k, h, r, cdt)
    rcv, items, erows = plan["receivers"], plan["items"], plan["rows"]
    assert plan["smem_bytes"] <= lim["max_smem"] and plan["node_rows"] * 2 == erows
    assert erows == lim["edge_rows"] if plan["route"] == "mma" else erows % 32 == 0
    if cdt == torch.bfloat16:
        assert plan["variant"] == ((5 if plan["chunks"] > 1 else 2) if plan["route"] == "mma"
                                   else 3)
    else:
        regular = plan["hp"] <= 256 and plan["hp"] & (plan["hp"] - 1) == 0
        assert plan["route"] == "block_gemm"
        assert plan["variant"] == ((4 if plan["chunks"] > 1 else 0) if regular else 1)
        assert not regular or erows == lim["edge_rows"]  # the regular tiles are fixed
    if k <= erows:
        assert rcv * k <= erows < (rcv + 1) * k and plan["chunks"] == 1
    else:
        assert rcv == 1 and plan["chunk"] <= erows < k <= plan["chunk"] * plan["chunks"]
    for rows, n_tiles in ((plan["node_rows"], items["C"]), (erows, items["A"] // 2)):
        tiles = [list(range(t * rows, min((t + 1) * rows, b * n))) for t in range(n_tiles)]
        assert all(tiles) and sorted(sum(tiles, [])) == list(range(b * n))
    assert items["A"] % 2 == 0

    def receivers(n_items, rows, size):
        per = -(-rows // size) if rows else 0
        assert n_items == b * per
        out = []
        for it in range(n_items):
            i0 = (it % per) * size
            out += [(it // per, i) for i in range(i0, min(i0 + size, rows))]
        return out

    assert receivers(items["B"], n, rcv) == [(s, i) for s in range(b) for i in range(n)]
    assert receivers(items["D"], r, rcv) == [(s, i) for s in range(b) for i in range(r)]
    # the kernel's half items (SplitTail, take_half): any item's receivers
    # split in two cover it
    for it in range(items["B"]):
        i0 = (it % (items["B"] // b)) * rcv
        rv = min(rcv, n - i0)
        first = (rv + 1) // 2
        assert list(range(i0, i0 + first)) + list(range(i0 + first, i0 + rv)) == list(
            range(i0, i0 + rv))
    assert plan["max_items"] == max(items.values())
    assert plan["hp"] == padded_width(h, cdt)
    assert plan["work"] == (4, b * n, plan["hp"]) and plan["coords"] == (2, b * n, 3)


def test_launch_plan_rejects_what_the_kernel_cannot_tile():
    """K past one tile is a plan of chunks that covers each receiver's
    edges once, in k order (the kernel's loop over ``chunks``); update_rows
    past N and an empty neighbour list are refused."""
    k = kernel_limits()["edge_rows"] + 1
    plan = launch_plan(1, 200, k, 64, 0, torch.bfloat16)
    assert plan["receivers"] == 1 and plan["chunks"] == 2
    edges = []
    for ch in range(plan["chunks"]):
        k0 = ch * plan["chunk"]
        edges += list(range(k0, k0 + min(plan["chunk"], k - k0)))
    assert edges == list(range(k)) and plan["chunk"] <= plan["rows"]
    with pytest.raises(ValueError, match="update_rows"):
        launch_plan(1, 10, 4, 64, 11, torch.bfloat16)
    with pytest.raises(ValueError, match="neighbor_k"):
        launch_plan(1, 10, 0, 64, 0, torch.bfloat16)


def test_launch_plan_of_the_wrapping_card_case():
    """tests/test_torch_kernels_cuda.py's (160, 100, ...) case gives every
    phase more work items than the H100's 132 SMs, so each strided item
    loop wraps."""
    assert min(launch_plan(160, 100, 12, 256, 8, torch.bfloat16)["items"].values()) > 132


def test_fused_apply_refuses_kernel_limits_at_build():
    """make_fused_apply builds at every width and K that K2 takes (bf16 H =
    320, an f32 width that is not a power of two, K beyond one 128-row
    tile) and refuses, naming it, only what the JAX package's
    make_pallas_apply refuses (no neighbor_k here), a model without
    attention and a width past the kernels' limit."""
    from cmdgen_tpu_torch.models.egnn import EGNNConfig as TEGNNConfig

    def dyn(**egnn):
        base = dict(hidden_nf=64, n_layers=1, inv_sublayers=1, neighbor_k=8)
        return TEGNNDynamics(TDynamicsConfig(phar_nf=8, residue_nf=5, joint_nf=8,
                                             egnn=TEGNNConfig(**{**base, **egnn})))

    make_fused_apply(dyn(hidden_nf=320, compute_dtype=torch.bfloat16))
    make_fused_apply(dyn(hidden_nf=192))
    make_fused_apply(dyn(neighbor_k=129))
    make_fused_apply(dyn(hidden_nf=256, compute_dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="neighbor_k"):
        make_fused_apply(dyn(neighbor_k=None))
    with pytest.raises(ValueError, match="attention"):
        make_fused_apply(dyn(attention=False))
    with pytest.raises(ValueError, match=r"hidden width 1025 .*H <= 1024"):
        make_fused_apply(dyn(hidden_nf=1025))
