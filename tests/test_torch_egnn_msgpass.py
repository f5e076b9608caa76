"""K1 parity: the port's GCL message pass (``cmdgen_tpu_torch.ops.egnn_msgpass``,
plain version on the CPU) and the port's dynamics on the neighbor-list engine
against the JAX package's Pallas kernel in interpret mode, at f32, with the
JAX suite's tolerances (atol 2e-4 / rtol 1e-4; 5e-4 at the flagship-like
shape). The same numpy-seeded inputs and the same flax params drive both."""
import ctypes
import dataclasses
import re
from pathlib import Path

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
from cmdgen_tpu_torch.ops import egnn_msgpass
from cmdgen_tpu_torch.ops.egnn_msgpass import (
    STAGES,
    edge_worklist_plain,
    gcl_message_agg,
    gcl_message_agg_plain,
    item_chunks,
    kernel_limits,
    launch_plan,
    padded_width,
    stage_shares,
)

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


def _gcl_vs_pallas_interpret(attention, h):
    rng = np.random.RandomState(3)
    b, n, k = 2, 11, 5
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


@pytest.mark.parametrize("attention", [True, False])
def test_gcl_message_agg_plain_matches_pallas_interpret(attention):
    _gcl_vs_pallas_interpret(attention, 32)


@pytest.mark.parametrize("h", [100, 192])
def test_gcl_message_agg_plain_matches_pallas_interpret_at_other_widths(h):
    """Widths that are not a power of two, which the CUDA kernel also
    takes (it computes them at ``padded_width``): the plain version against
    JAX's kernel at f32."""
    _gcl_vs_pallas_interpret(True, h)


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


def plan_tiles(wl, rows):
    """The tiles K1's and K3's item loop takes (csrc/egnn_msgpass.cu:
    edge_pass) from a work list (``edge_worklist_plain``), in item order:
    (sample, first receiver, receivers, edges, and for each receiver the
    range of its live slots that the tile holds, as (first, count)). A copy
    of that loop's mapping from item to tile, kept in step with it by hand:
    the card cases (tests/test_torch_kernels_cuda.py) catch a kernel that
    drifts from it."""
    for s, per_sample in enumerate(wl["items"]):
        p = wl["poff"][s].tolist()
        for i0, rv, live in per_sample:
            chunks = item_chunks(live, rows)
            kc = -(-live // chunks)
            for ch in range(chunks):
                t0 = ch * kc
                e = min(kc, live - t0)
                if chunks > 1:
                    spans = [(t0, e)]
                else:
                    spans = [(0, p[i0 + q + 1] - p[i0 + q]) for q in range(rv)]
                yield s, i0, rv, e, spans


MASKS = ["scattered", "prefix", "all_live", "masked_rows", "long_rows"]


def mask_case(kind, b, n, k, seed=0):
    """kmask [b, n, k] of one kind: slots live at random; each receiver's
    first c slots live (what ``build_neighbor_list``'s topk gives); every
    slot live; at random with whole receivers masked (padded rows); or,
    where K passes a 128-row tile, receivers with 129 to K live slots
    beside sparse ones."""
    g = torch.Generator().manual_seed(seed)
    if kind == "all_live":
        return torch.ones(b, n, k)
    if kind == "prefix":
        c = torch.randint(0, k + 1, (b, n, 1), generator=g)
        return (torch.arange(k) < c).float()
    m = (torch.rand(b, n, k, generator=g) > 0.6).float()
    if kind == "masked_rows":
        m[torch.rand(b, n, generator=g) > 0.5] = 0
    if kind == "long_rows":
        c = torch.randint(min(129, k), k + 1, (b, n, 1), generator=g)
        dense = (torch.rand(b, n, k, generator=g).argsort(-1) < c).float()
        m = torch.where(torch.rand(b, n, 1, generator=g) > 0.5, dense, m)
    return m


def check_worklist(kmask, r, rows):
    """The work list that the kernels' pre-pass builds from ``kmask`` over
    the first ``r`` receivers of each sample (``edge_worklist_plain``),
    walked as the kernel walks it: every live slot (kmask non-zero) taken
    exactly once, a receiver's in k order, no masked slot taken; tiles of
    at most ``rows`` edges and receivers; receivers whole unless they have
    more than ``rows`` live slots; every receiver, live or not, in exactly
    one item, so that its output is written; items in sample order."""
    b, _, k = kmask.shape
    wl = edge_worklist_plain(kmask, r, rows)
    live = (kmask[:, :r] != 0).numpy()
    seen = np.zeros((b, r, k), dtype=int)
    next_t = np.zeros((b, r), dtype=int)
    written = np.zeros((b, r), dtype=int)
    last = (0, 0)
    for s, i0, rv, e, spans in plan_tiles(wl, rows):
        assert 0 < rv <= rows and e <= rows and 0 <= i0 and i0 + rv <= r
        assert (s, i0) >= last
        last = (s, i0)
        assert sum(c for _, c in spans) == e
        for q, (t0, c) in enumerate(spans):
            slots = wl["slots"][s][i0 + q]
            assert next_t[s, i0 + q] == t0  # chunks in k order
            next_t[s, i0 + q] = t0 + c
            if rv > 1 or len(slots) <= rows:  # whole
                assert (t0, c) == (0, len(slots))
            for kk in slots[t0:t0 + c]:
                seen[s, i0 + q, kk] += 1
    for s, per_sample in enumerate(wl["items"]):
        for i0, rv, _ in per_sample:
            written[s, i0:i0 + rv] += 1
    assert (written == 1).all()
    assert (seen == live).all()
    assert all(sl == sorted(sl) for per in wl["slots"] for sl in per)
    assert (next_t == live.sum(-1)).all()
    return wl


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("b,n,k,h,cdt", [
    (48, 118, 12, 256, torch.bfloat16),   # the flagship shape
    (132, 118, 12, 256, torch.bfloat16),  # 12 whole rounds when every slot is live
    (24, 69, 16, 128, torch.float32),     # the qrun_aa widths (trained run, f32)
    (24, 69, 16, 128, torch.bfloat16),
    (3, 5, 12, 64, torch.bfloat16),       # N < R: one item per sample
    (1, 118, 12, 256, torch.bfloat16),    # B = 1
    (2, 9, 200, 256, torch.bfloat16),     # K past one tile: chunks of edges
    (2, 40, 70, 512, torch.float32),      # float32 wider than 256: 64-row tiles
    (1, 3, 1, 32, torch.bfloat16),        # K = 1
    (48, 118, 12, 100, torch.float32),    # a width that is not a power of two
    (2, 40, 12, 640, torch.bfloat16),     # bf16 past 512: 112-row tiles
    (3, 140, 160, 256, torch.float32),    # K = 160: rows of up to 160 live slots
    (4, 30, 7, 99, torch.float32),        # an odd width: tiles of Hp = 100
])
def test_launch_plan_covers_every_edge_once(b, n, k, h, cdt, mask):
    """K1's plan (``launch_plan``) fits the kernel's rows and shared memory,
    and the work list its pre-pass packs from kmask (``check_worklist``)
    takes every live (sample, receiver, edge) exactly once and no masked
    one, each receiver's in k order, in tiles of at most ``rows`` edges.
    Where every slot is live the tiles are packed as a fixed R x K plan
    would pack them: rows // K receivers an item."""
    sms = 132
    lim = kernel_limits()
    plan = launch_plan(b, n, k, h, cdt, sms)
    rows = plan["rows"]
    assert plan["route"] == ("mma" if cdt == torch.bfloat16 and h <= 256 else "block_gemm")
    assert plan["hp"] == padded_width(h, cdt) and plan["smem_bytes"] <= lim["max_smem"]
    assert rows == lim["edge_rows"] or (plan["route"] == "block_gemm" and rows % 16 == 0)
    assert plan["items"] == b * n and plan["grid"] == min(sms, plan["items"])
    assert plan["list_ints"] == 5 * b * n + b * n * k + b
    assert plan["list_smem"] == 4 * (n + 1) * (1 + max(1, (n - 1).bit_length()))
    cap = plan["cap"]
    hp = plan["hp"]
    pass_rows = 16384 // hp if hp & (hp - 1) == 0 else 0  # float's 64-row passes at 256
    halved = cdt == torch.float32 and 2 * pass_rows == rows and b * n * k <= sms * rows
    assert cap == (rows // 2 if halved else rows)
    wl = check_worklist(mask_case(mask, b, n, k, seed=n + k), n, cap)
    if mask == "all_live" and k <= cap:
        for per_sample in wl["items"]:
            assert [rv for _, rv, _ in per_sample] == [
                min(cap // k, n - i0) for i0 in range(0, n, cap // k)]


def test_worklist_packs_whole_receivers_greedily():
    """The pre-pass's packing, by hand: receivers with 3, 0, 5, 130, 2 and
    0 live slots in tiles of 8 rows: (3, 0, 5) fill one item, 130 is an
    item alone, taken in 17 tiles (``item_chunks``: 16 of 8 edges, one of
    2), then (2, 0)."""
    counts = [3, 0, 5, 130, 2, 0]
    kmask = torch.zeros(1, 6, 130)
    for i, c in enumerate(counts):
        kmask[0, i, torch.arange(130)[-c:] if c else []] = 1  # the last c slots
    wl = edge_worklist_plain(kmask, 6, 8)
    assert wl["items"] == [[(0, 3, 8), (3, 1, 130), (4, 2, 2)]]
    assert wl["poff"].tolist() == [[0, 3, 3, 8, 138, 140, 140]]
    assert item_chunks(130, 8) == 17 and item_chunks(8, 8) == 1
    assert wl["slots"][0][0] == [127, 128, 129]
    check_worklist(kmask, 6, 8)


def test_launch_plan_splits_the_last_round():
    """A float launch whose every slot fits in one round of full tiles
    packs items of half a tile (``cap``), so that twice as many blocks
    share the round, each one 64-row pass instead of two: K3 over the CA
    cells' 16 moving rows (64 x 16 x 12 slots, 96 full tiles on 132 SMs),
    not K1 over all 126 rows, nor the mma route, whose tile always
    multiplies its 128 rows. With every slot live, half items take two
    rounds of one pass where full ones took one of two."""
    from cmdgen_tpu_torch.ops import egnn_coord

    k3 = egnn_coord.launch_plan(64, 126, 16, 12, 256, torch.float32, 132)
    assert (k3["rows"], k3["cap"]) == (128, 64)
    assert launch_plan(64, 126, 12, 256, torch.float32, 132)["cap"] == 128
    assert egnn_coord.launch_plan(64, 126, 16, 12, 256, torch.bfloat16, 132)["cap"] == 128
    full = edge_worklist_plain(torch.ones(64, 16, 12), 16, k3["cap"])
    assert sum(map(len, full["items"])) == 64 * 4 <= 2 * 132  # 5, 5, 5 and 1 receivers
    plan = launch_plan(48, 118, 12, 256, torch.bfloat16, 132)
    full = edge_worklist_plain(torch.ones(48, 118, 12), 118, plan["cap"])
    assert sum(map(len, full["items"])) == 576


def struct_fields(source: str, struct: str):
    """The fields of a kernel's argument structure in csrc/<source>.cu, in
    order, as (name, ctypes type name): the layout its wrapper's ctypes
    structure must repeat."""
    src = (Path(egnn_msgpass.__file__).resolve().parent.parent / "csrc"
           / f"{source}.cu").read_text()
    body = re.search(rf"struct {struct} \{{(.*?)\n\}};", src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if not decl:
            continue
        ctype, names = re.match(r"((?:const )?\w+\*?(?: long\*)?)\s+(.*)", decl).groups()
        for name in names.split(","):
            name = name.strip()
            ptr = "*" in ctype or name.startswith("*")
            fields.append((name.lstrip("*"), "void_p" if ptr else ctype))
    want = {"int": "c_int", "float": "c_float", "void_p": "c_void_p"}
    return [(name, want[t]) for name, t in fields]


def test_kernel_params_match_the_cuda_struct():
    """The wrapper's ctypes structure lists K1Params's fields in the
    source's order with the same C types."""
    got = [(name, t.__name__) for name, t in egnn_msgpass._Params._fields_]
    assert got == struct_fields("egnn_msgpass", "K1Params")


def test_plan_structs_match_the_header():
    """The wrappers' ctypes structures list K1Plan's and K2Plan's fields in
    csrc/egnn_plan.h's order, every one an int (``items`` four of them)."""
    from cmdgen_tpu_torch.ops import egnn_fused

    src = (Path(egnn_msgpass.__file__).resolve().parent.parent / "csrc"
           / "egnn_plan.h").read_text()
    for name, struct in (("K1Plan", egnn_msgpass._K1Plan), ("K2Plan", egnn_fused._K2Plan)):
        body = re.search(rf"struct {name} \{{(.*?)\n\}};", src, re.S).group(1)
        decl = re.fullmatch(r"\s*int (.*);\s*", body, re.S).group(1)
        fields = [f.strip() for f in decl.replace("\n", " ").split(",")]
        got = [(f, t) for f, t in struct._fields_]
        want = [(f.split("[")[0], ctypes.c_int * int(f.split("[")[1][:-1]) if "[" in f
                 else ctypes.c_int) for f in fields]
        assert [f for f, _ in got] == [f for f, _ in want]
        for (_, a), (_, b) in zip(got, want):
            assert ctypes.sizeof(a) == ctypes.sizeof(b) and (a is b or a._type_ is b._type_)


def test_stage_shares_from_stamps():
    stamps = torch.tensor([10, 30, 20, 25, 15, 7])
    shares = stage_shares(stamps)
    assert shares["tiles"] == 7
    assert list(shares)[:len(STAGES)] == list(STAGES)
    assert sum(shares[s] for s in STAGES) == pytest.approx(1.0)
    assert shares["pair layer"] == pytest.approx(0.3)


def test_padded_width_and_its_limit():
    """The kernels' products run at H rounded up to 32 (bf16) or 4
    (float32), any H from 1 to the widest stack (1024); past it the plan
    raises by name."""
    max_h = kernel_limits()["max_h"]
    assert max_h == 1024
    assert [padded_width(h, torch.bfloat16) for h in (1, 32, 48, 320, 1024)] == [
        32, 32, 64, 320, 1024]
    assert [padded_width(h, torch.float32) for h in (1, 4, 99, 100, 192, 1023)] == [
        4, 4, 100, 100, 192, 1024]
    with pytest.raises(ValueError, match=f"hidden width {max_h + 1} .*H <= {max_h}"):
        launch_plan(1, 8, 4, max_h + 1, torch.float32, 132)
    with pytest.raises(ValueError, match="hidden width 0 "):
        padded_width(0, torch.bfloat16)


def test_launch_plan_takes_the_route_it_is_asked_for():
    """``route``: None takes mma.sync where it runs (bf16 up to 256), else
    block_gemm; "block_gemm" is taken at any width; no other is."""
    def route(h, cdt, asked):
        return launch_plan(48, 118, 12, h, cdt, 132, asked)["route"]

    assert route(256, torch.bfloat16, None) == "mma"
    assert route(256, torch.bfloat16, "block_gemm") == route(64, torch.float32, "block_gemm")
    assert route(256, torch.bfloat16, "block_gemm") == "block_gemm"
    assert route(288, torch.bfloat16, None) == route(256, torch.float32, None) == "block_gemm"
    plan = launch_plan(48, 118, 12, 256, torch.bfloat16, 132, "block_gemm")
    assert plan["rows"] % 16 == 0 and plan["smem_bytes"] <= kernel_limits()["max_smem"]
    with pytest.raises(ValueError, match="route 'mma': None or 'block_gemm'"):
        launch_plan(48, 118, 12, 256, torch.bfloat16, 132, "mma")


@pytest.mark.parametrize("hidden,dtype", [
    (192, torch.float32),
    (48, torch.bfloat16),
    (256, torch.bfloat16),   # the flagship width
    (128, torch.float32),    # qrun_aa's width
    (100, torch.float32),
    (640, torch.bfloat16),
], ids=["f32_H192", "bf16_H48", "flagship_bf16_H256", "qrun_aa_f32_H128", "f32_H100",
        "bf16_H640"])
def test_gcl_routing_rule(monkeypatch, hidden, dtype):
    """A neighbor-list GCL goes to K1's wrapper at every width (here its
    plain version runs: the tensors lie on the CPU), one call per layer."""
    from cmdgen_tpu_torch.models import egnn as egnn_module
    from cmdgen_tpu_torch.models.egnn import EGNNConfig as TEGNNConfig

    calls = []
    real = egnn_module.gcl_message_agg

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(egnn_module, "gcl_message_agg", counting)
    cfg = TDynamicsConfig(phar_nf=8, residue_nf=5, joint_nf=8, edge_cutoff=None,
                          egnn=TEGNNConfig(hidden_nf=hidden, n_layers=2, inv_sublayers=1,
                                           neighbor_k=6, compute_dtype=dtype))
    torch.manual_seed(0)
    dyn = TEGNNDynamics(cfg).eval()
    _, _, inputs = _setup(b=2, n_p=4, n_q=9)
    with torch.no_grad():
        out_p, out_q = dyn(*_t(*inputs))
    assert len(calls) == 2
    assert torch.isfinite(out_p).all() and torch.isfinite(out_q).all()


def test_edge_rows_counter_adds_over_devices_and_launches():
    """``EdgeRows``: one [rows, slots] pair a device, made at the device's
    first launch, which the pre-pass adds to; read as the sums over the
    devices (here a CPU stand-in for the card's pair)."""
    counter = egnn_msgpass.EdgeRows()
    assert counter() == (0, 0)
    dev = torch.device("cpu")
    buf = counter.buffer(dev)
    assert counter.buffer(dev) is buf and buf.tolist() == [0, 0]
    buf += torch.tensor([38, 100])
    buf += torch.tensor([2, 10])
    assert counter() == (40, 110)
    assert isinstance(gcl_message_agg.edge_rows, egnn_msgpass.EdgeRows)
