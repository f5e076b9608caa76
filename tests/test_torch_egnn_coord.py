"""K3 parity: the port's coordinate update on the neighbor list
(``cmdgen_tpu_torch.ops.egnn_coord``, its plain version on the CPU) against
the JAX package's ``EquivariantUpdate`` on the neighbor-list path, on
weights converted by ``convert.py``: float32 at the JAX suite's tolerances
(atol 2e-4 / rtol 1e-4); bfloat16 within 2**-5 of the largest
displacement, four bf16 steps, where the two packages round at different
points (the plain version reads 1.6-1.9% here, the port's op-by-op path
1.1-2.4%). The model's route through the wrapper against its op-by-op path
(bfloat16 within K1's tolerance, 2**-7: the EGNN's displacements here read
0.03% apart, a single update's 0.5-0.7%);
planted faults that the comparison catches; K3's plan and argument
layout."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmdgen_tpu.models.egnn import EGNNConfig as JEGNNConfig
from cmdgen_tpu.models.egnn import EquivariantUpdate as JEquivariantUpdate
from cmdgen_tpu.models.egnn import gather_nodes
from cmdgen_tpu_torch.convert import load_flax_params
from cmdgen_tpu_torch.models import egnn as egnn_module
from cmdgen_tpu_torch.models.egnn import EGNN, EGNNConfig, EquivariantUpdate
from cmdgen_tpu_torch.ops import egnn_coord, egnn_msgpass
from cmdgen_tpu_torch.ops.egnn_coord import (
    coord_update_agg,
    coord_update_agg_plain,
    launch_plan,
)

torch.set_num_threads(1)

B, N, K, H, MOVING = 2, 20, 6, 32, 16
COORDS_RANGE, NORM_FACTOR = 15.0, 100.0
TOL_BF16 = 2.0 ** -7  # K1's bf16 tolerance, of the largest displacement
TOL_BF16_JAX = 2.0 ** -5  # the same against the JAX package, which rounds elsewhere
JAX_DT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(seed):
    """h, x, the neighbor list of each row (self-edge first), dist0, kmask
    and an update-coordinates mask with a frozen row, as numpy arrays."""
    rng = np.random.RandomState(seed)
    h = rng.randn(B, N, H).astype(np.float32)
    x = (rng.randn(B, N, 3) * 2).astype(np.float32)
    idx = np.concatenate([np.broadcast_to(np.arange(N)[None, :, None], (B, N, 1)),
                          rng.randint(0, N, (B, N, K - 1))], -1).astype(np.int64)
    dist0 = (rng.rand(B, N, K) * 9).astype(np.float32)
    kmask = (rng.rand(B, N, K) > 0.25).astype(np.float32)
    kmask[..., 0] = 1.0
    ucm = np.ones((B, N), np.float32)
    ucm[1, 3] = 0.0
    return h, x, idx, dist0, kmask, ucm


def _jax_update(cdt, tanh, update_rows, use_ucm, seed=0):
    """The JAX package's EquivariantUpdate on the neighbor-list path: its
    output, its params (the gate's kernel drawn at 1/sqrt(H), not its
    1e-6 variance, so that x moves by up to about an angstrom) and the
    inputs."""
    h, x, idx, dist0, kmask, ucm = _inputs(seed)
    jcfg = JEGNNConfig(hidden_nf=H, tanh=tanh, compute_dtype=JAX_DT[cdt], neighbor_k=K)
    nbr = jax.nn.one_hot(idx, N, dtype=jnp.float32)
    diff = x[:, :, None, :] - gather_nodes(jnp.asarray(x), nbr)
    radial = jnp.sum(diff ** 2, axis=-1, keepdims=True)
    coord_diff = diff / (jnp.sqrt(radial + 1e-8) + jcfg.norm_constant)
    dt = JAX_DT[cdt]
    edge_attr = jnp.concatenate([radial.astype(dt), jnp.asarray(dist0)[..., None].astype(dt)], -1)
    args = (jnp.asarray(h), jnp.asarray(x), coord_diff, edge_attr, jnp.asarray(kmask).astype(dt),
            jnp.asarray(ucm) if use_ucm else None, nbr, update_rows)
    mod = JEquivariantUpdate(jcfg, COORDS_RANGE)
    params = jax.tree_util.tree_map(np.asarray, mod.init(jax.random.PRNGKey(seed), *args))
    rng = np.random.RandomState(seed + 1)
    params["params"]["coord_gate"]["kernel"] = (rng.randn(H, 1) / np.sqrt(H)).astype(np.float32)
    params["params"]["coord_mid"]["bias"] = (rng.randn(H) * 0.1).astype(np.float32)
    out = np.asarray(mod.apply(params, *args), np.float32)
    return out, params, (h, x, idx, dist0, kmask, ucm if use_ucm else None)


def _port_update(cdt, tanh, params):
    cfg = EGNNConfig(hidden_nf=H, tanh=tanh, compute_dtype=cdt, neighbor_k=K)
    mod = EquivariantUpdate(cfg, COORDS_RANGE)
    load_flax_params(mod, params["params"])
    return mod.eval()


def _plain_args(mod, cdt, h, x, idx, dist0, kmask, ucm, update_rows):
    """The arguments the model hands the wrapper."""
    t = [None if v is None else torch.from_numpy(np.asarray(v)) for v in
         (h, x, idx, dist0, kmask, ucm)]
    h, x, idx, dist0, kmask, ucm = t
    wi, wj = mod.coord_in.project(h, cdt, rows=update_rows)
    return (wi, wj, idx, dist0.to(cdt), kmask.to(cdt), x, ucm,
            mod.coord_in.w_e.weight.t(), mod.coord_mid.weight.t(), mod.coord_mid.bias,
            mod.coord_gate.weight.reshape(H), COORDS_RANGE, 1.0, NORM_FACTOR)


def _hold(out, ref, x, cdt):
    """Whether out agrees with the JAX package's ref: float32 at atol 2e-4 /
    rtol 1e-4, bfloat16 within TOL_BF16_JAX of the largest displacement."""
    if cdt == torch.float32:
        return np.allclose(out, ref, atol=2e-4, rtol=1e-4)
    return np.abs(out - ref).max() <= TOL_BF16_JAX * np.abs(ref - x).max()


CASES = [(cdt, tanh, rows, ucm) for cdt in (torch.float32, torch.bfloat16)
         for tanh in (True, False) for rows, ucm in ((None, False), (MOVING, True))]
CASE_IDS = [f"{'f32' if c == torch.float32 else 'bf16'}-{'tanh' if t else 'linear'}-"
            f"{'all_rows' if r is None else f'rows{r}'}" for c, t, r, _ in CASES]


@pytest.mark.parametrize("cdt,tanh,update_rows,use_ucm", CASES, ids=CASE_IDS)
def test_plain_matches_jax_equivariant_update(cdt, tanh, update_rows, use_ucm):
    """coord_update_agg_plain against the JAX package's EquivariantUpdate on
    the neighbor list, every row or the first 16 moving (with a row of the
    update-coordinates mask at zero); the sublayer's route on CPU tensors
    is the plain version, launching nothing."""
    ref, params, (h, x, idx, dist0, kmask, ucm) = _jax_update(cdt, tanh, update_rows, use_ucm)
    mod = _port_update(cdt, tanh, params)
    args = _plain_args(mod, cdt, h, x, idx, dist0, kmask, ucm, update_rows)
    with torch.no_grad():
        out = coord_update_agg_plain(*args, tanh, cdt).numpy()
        before = coord_update_agg.launches
        routed = coord_update_agg(*args, tanh, cdt).numpy()
        assert coord_update_agg.launches == before
    np.testing.assert_array_equal(routed, out)
    assert np.abs(ref - x).max() > 0.05  # the update moves x
    if update_rows is not None:  # the rows past the moving ones stay
        np.testing.assert_array_equal(out[:, update_rows:], x[:, update_rows:])
        np.testing.assert_array_equal(out[1, 3], x[1, 3])
    assert _hold(out, ref, x, cdt), np.abs(out - ref).max()


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("fault", ["tanh_left_out", "coord_mid_column_zeroed"])
def test_planted_fault_fails_the_comparison(fault, cdt):
    """The comparison above catches a plain version that leaves the gate's
    tanh out or loses one column of coord_mid."""
    ref, params, (h, x, idx, dist0, kmask, ucm) = _jax_update(cdt, True, MOVING, True)
    mod = _port_update(cdt, True, params)
    args = list(_plain_args(mod, cdt, h, x, idx, dist0, kmask, ucm, MOVING))
    tanh = True
    if fault == "tanh_left_out":
        tanh = False
    else:
        wm = args[8].clone()
        wm[:, 5] = 0
        args[8] = wm
    with torch.no_grad():
        out = coord_update_agg_plain(*args, tanh, cdt).numpy()
    assert not _hold(out, ref, x, cdt)


def _egnn(cdt, joint, seed=0):
    """An EGNN on the neighbor list (K=6) with seeded weights, the gates at
    1/sqrt(H); its inputs with a padded node, and the update rows and mask
    of the conditional model (16 of 20 rows) or of the joint one (None)."""
    torch.manual_seed(seed)
    cfg = EGNNConfig(hidden_nf=H, n_layers=2, compute_dtype=cdt, neighbor_k=K)
    egnn = EGNN(cfg, 9, 9).eval()
    with torch.no_grad():
        for i in range(cfg.n_layers):
            gate = getattr(egnn, f"e_block_{i}").coord_update.coord_gate.weight
            gate.copy_(torch.randn(gate.shape) / H ** 0.5)
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(B, N, 9, generator=g)
    x = torch.randn(B, N, 3, generator=g) * 2
    node_mask = torch.ones(B, N)
    node_mask[1, -1] = 0
    edge_mask = node_mask[:, :, None] * node_mask[:, None, :]
    ucm = None if joint else torch.cat([node_mask[:, :MOVING], torch.zeros(B, N - MOVING)], 1)
    return egnn, (h, x, edge_mask, node_mask, ucm, None if joint else MOVING)


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("joint", [False, True], ids=["conditional", "joint"])
def test_egnn_same_through_the_wrapper_and_op_by_op(monkeypatch, cdt, joint):
    """EGNN.forward with each coordinate update through the wrapper (its
    plain version here), one call a block, against the same forward pass
    with the coordinate updates op by op (today's torch path; the GCLs
    through K1's wrapper in both)."""
    egnn, inputs = _egnn(cdt, joint)
    calls = []
    real = egnn_module.coord_update_agg

    def counting(*args, **kw):
        calls.append(args[0].shape[1])
        return real(*args, **kw)

    monkeypatch.setattr(egnn_module, "coord_update_agg", counting)
    with torch.no_grad():
        h, x = egnn(*inputs)
        assert calls == [MOVING if not joint else N] * 2
        monkeypatch.setattr(egnn_module, "coord_update_agg",
                            lambda *a, **k: pytest.fail("the wrapper ran"))
        real_route = egnn_module.kernel_route
        update_forward = EquivariantUpdate.forward

        def op_by_op(self, *args, **kw):
            monkeypatch.setattr(egnn_module, "kernel_route", lambda: False)
            try:
                return update_forward(self, *args, **kw)
            finally:
                monkeypatch.setattr(egnn_module, "kernel_route", real_route)

        monkeypatch.setattr(EquivariantUpdate, "forward", op_by_op)
        h_ref, x_ref = egnn(*inputs)
    x0 = inputs[1]
    assert (x_ref - x0).abs().max() > 0.05
    if cdt == torch.float32:
        torch.testing.assert_close(x, x_ref, atol=2e-4, rtol=1e-4)
        torch.testing.assert_close(h, h_ref, atol=2e-4, rtol=1e-4)
    else:
        assert (x - x_ref).abs().max() <= TOL_BF16 * (x_ref - x0).abs().max()
        assert (h - h_ref).abs().max() <= 2.0 ** -6 * h_ref.abs().max()


@pytest.mark.parametrize("engine", ["dense", "grad", "mean", "sin_embedding"])
def test_other_cases_keep_the_torch_path(monkeypatch, engine):
    """The dense engine, a forward pass under autograd, mean aggregation and
    sin_embedding never call the wrapper."""
    monkeypatch.setattr(egnn_module, "coord_update_agg",
                        lambda *a, **k: pytest.fail("the wrapper ran"))
    cfg = EGNNConfig(hidden_nf=H, n_layers=1, neighbor_k=None if engine == "dense" else K,
                     aggregation_method="mean" if engine == "mean" else "sum",
                     sin_embedding=engine == "sin_embedding")
    egnn = EGNN(cfg, 9, 9)
    _, inputs = _egnn(torch.float32, True)
    with torch.set_grad_enabled(engine == "grad"):
        h, x = egnn(*inputs)
    assert torch.isfinite(x).all()


@pytest.mark.parametrize("mask", ["scattered", "prefix", "masked_rows", "long_rows"])
@pytest.mark.parametrize("b,n,r,k,h,cdt", [
    (64, 126, 126, 12, 256, torch.float32),   # the joint cell: every row moves
    (64, 126, 16, 12, 256, torch.float32),    # the conditional CA cell: 16 rows
    (16, 522, 16, 160, 256, torch.float32),   # full atom, K = 160: long rows in chunks
    (48, 118, 118, 12, 256, torch.bfloat16),  # bf16 on mma.sync
    (1, 118, 37, 12, 256, torch.bfloat16),    # B = 1
    (3, 9, 0, 4, 64, torch.float32),          # no row moves
    (2, 40, 30, 70, 100, torch.float32),      # a width that is not a power of two
    (2, 9, 9, 200, 640, torch.bfloat16),      # bf16 past 256, K past a tile
])
def test_launch_plan_covers_every_moving_edge_once(b, n, r, k, h, cdt, mask):
    """K3's plan and the work list its pre-pass packs over the moving rows,
    walked as the kernel walks it (K1's walk,
    tests/test_torch_egnn_msgpass.py: check_worklist), take every live
    (sample, moving receiver, edge) exactly once and no masked one, a
    receiver's in k order, in tiles that fit; its tiles hold the coordinate
    differences, so they take a little more shared memory than K1's."""
    from test_torch_egnn_msgpass import check_worklist, mask_case

    sms = 132
    plan = launch_plan(b, n, r, k, h, cdt, sms)
    k1 = egnn_msgpass.launch_plan(b, n, k, h, cdt, sms)
    lim = egnn_msgpass.kernel_limits()
    assert plan["route"] == k1["route"] and plan["hp"] == k1["hp"]
    assert k1["smem_bytes"] < plan["smem_bytes"] <= lim["max_smem"]
    assert plan["items"] == b * r and plan["grid"] == min(sms, max(plan["items"], 1))
    assert plan["list_smem"] == 4 * (r + 1) * (1 + max(1, (r - 1).bit_length()))
    kmask = mask_case(mask, b, n, k, seed=r + k)
    wl = check_worklist(kmask, r, plan["cap"])
    if r == n and plan["cap"] == k1["cap"]:  # every row moves: K1's list
        assert wl["items"] == check_worklist(kmask, n, k1["cap"])["items"]
    if (b, r, k, cdt) == (64, 16, 12, torch.float32):  # one round of full tiles: half tiles
        assert (plan["cap"], k1["cap"]) == (64, 128)


def test_launch_plan_refuses_more_rows_than_a_sample_has():
    with pytest.raises(ValueError, match="coordinate update of 10 of 9 rows"):
        launch_plan(2, 9, 10, 4, 64, torch.float32, 132)


def test_kernel_params_match_the_cuda_struct():
    """K3 launches through K1's argument structure: the wrappers' one ctypes
    structure lists K1Params's fields in the source's order with the same C
    types, the coordinate update's among them, and K3's plan is K1's
    library's fourth and third variants (``edge_variant``)."""
    from test_torch_egnn_msgpass import struct_fields

    got = [(name, t.__name__) for name, t in egnn_msgpass._Params._fields_]
    assert got == struct_fields("egnn_msgpass", "K1Params")
    assert {"coords", "x", "ucm", "use_tanh", "coords_range", "norm_constant", "r"} <= {
        name for name, _ in got}
    assert not hasattr(egnn_coord, "_Params")
    for h, variant in ((256, 2), (100, 3)):
        assert launch_plan(2, 9, 5, 4, h, torch.float32, 132)["variant"] == variant
        assert egnn_msgpass.launch_plan(2, 9, 4, h, torch.float32, 132)["variant"] == variant - 2


def test_graph_replay_counts_each_kernels_launches():
    """A replayed graph adds the launches it holds to each counted
    kernel's counter, K1's and K3's."""
    from cmdgen_tpu_torch.models.dynamics import COUNTED_KERNELS, _Graph

    class Replayed:
        def replay(self):
            pass

    assert COUNTED_KERNELS == (egnn_msgpass.gcl_message_agg, coord_update_agg)
    before = [fn.launches for fn in COUNTED_KERNELS]
    graph = _Graph(Replayed(), (torch.zeros(2),), (torch.ones(2),), (5, 3))
    out = graph.replay((torch.full((2,), 7.0),))
    assert [fn.launches - b for fn, b in zip(COUNTED_KERNELS, before)] == [5, 3]
    assert torch.equal(graph.inputs[0], torch.full((2,), 7.0)) and torch.equal(out[0],
                                                                               torch.ones(2))
    for fn, b in zip(COUNTED_KERNELS, before):
        fn.launches = b



@pytest.mark.parametrize("kernel", ["coord_update_agg_kernel", "gcl_message_agg_kernel"])
def test_coord_roofline_reads_k3_kernels_only(kernel):
    """The benchmark's ``coord_roofline`` at ca-joint-b64: the least time
    of one K3 launch a layer over the traced K3 kernels' time; it reads
    nothing in a trace without K3 (a program without the kernel)."""
    from perfbench.harness import cell as cellmod
    from perfbench.harness import spec, trace, work

    root = Path(__file__).resolve().parent.parent
    c = spec.load_cell(root, "ca-joint-b64")
    g = work.Graph(nodes=7000, moving=7000, pocket=6000, edges=60000, moving_edges=60000,
                   phar=1000)
    ran = trace.ChainTrace()
    ran.events = trace.Events(
        device=[(f"void egnn::{kernel}<float, false, false>(K1Params)", 0, 400_000, i)
                for i in range(5)], api=[], start=0, end=5_000_000)
    run = cellmod.Run(c, trace=ran, graphs=[g, g])
    got = spec.reader_of("coord_roofline", root / "perfbench")(run)
    if kernel != "coord_update_agg_kernel":
        assert got is None
        return
    e = c.config["dynamics"]["egnn"]
    h = e["hidden_nf"]
    flops = 2 * 60000 * h * h + 2 * 60000 * h
    want = 2 * e["n_layers"] * flops / work.PEAK_FLOPS["float32"] / 2e-3
    assert got == pytest.approx(100 * want)
