"""K2: the whole L-layer EGNN stack in one kernel (counterpart of
``cmdgen_tpu/ops/egnn_fused.py:egnn_forward_fused``).

Semantics: ``models.egnn.EGNN`` with inv_sublayers=1, the neighbor list,
sum aggregation, attention and the tanh gate. The neighbor list, dist0 and
the input and output embeddings are computed here in PyTorch; the layer
stack runs in the hand-written CUDA kernel (``csrc/egnn_fused.cu``) on CUDA
tensors, or in ``_layers_plain`` (the kernel's function in plain PyTorch,
with its casts) on CPU tensors. ``egnn_forward_fused_plain`` always takes
the plain layers.

Like the JAX kernel, the GCL radial is computed from x rounded to the
compute dtype; the coordinate pass gathers x in float32.

Widths: the kernel runs the stack at ``padded_width(H)`` (H rounded up to
32 for bfloat16, 4 for float32). ``fused_params`` pads the stacked weights
to it once, with zeros, and the kernel's entry h is padded on each call;
the padded columns stay zero through every layer and are cut from the
kernel's output. The plain layers take the weights back to H.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from cmdgen_tpu_torch.ops import _build
from cmdgen_tpu_torch.ops.egnn_msgpass import (
    _DTYPE_CODE,
    _check,
    block_gemm_asked,
    gather_rows,
    ksum,
    padded_width,
    plan_error,
    refuse_autograd,
    silu_cdt,
)
from cmdgen_tpu_torch.utils.profiling import span

# kernel argument order (csrc/egnn_fused.cu: FusedWeights)
WEIGHT_NAMES = (
    "wi", "wj", "wjb", "we", "w2", "w2b", "att", "attb",
    "nih", "nia", "nib", "no", "nob",
    "cwi", "cwj", "cwjb", "cwe", "cm", "cmb", "cg",
)
_F32_NAMES = frozenset({"wjb", "w2b", "attb", "nib", "nob", "cwjb", "cmb"})
# the trailing dimensions of each stack that are H wide ([L, H, H]
# matrices: 2; [L, 2, H] edge rows and [L, H] vectors: 1; attb [L]: 0)
_H_DIMS = {name: 2 for name in WEIGHT_NAMES}
_H_DIMS.update({name: 1 for name in ("wjb", "we", "w2b", "att", "nib", "nob", "cwjb",
                                     "cwe", "cmb", "cg")}, attb=0)


def resize_stacks(p: Dict[str, torch.Tensor], h: int) -> Dict[str, torch.Tensor]:
    """The stacks of ``p`` (``WEIGHT_NAMES``) at width h: zero-padded where
    they are narrower, cut (views) where wider; other entries as they are."""
    out = dict(p)
    for name in WEIGHT_NAMES:
        t, d = p[name], _H_DIMS[name]
        if d == 0 or t.shape[-1] == h:
            continue
        if t.shape[-1] < h:
            out[name] = F.pad(t, (0, h - t.shape[-1]) * d).contiguous()
        else:
            out[name] = t[..., :h, :h] if d == 2 else t[..., :h]
    return out


def _kernel_io(lin: torch.nn.Linear) -> torch.Tensor:
    """A Linear's weight [out, in] in the kernels' [in, out] layout."""
    return lin.weight.t()


def fused_params(egnn, compute_dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Stack an ``models.egnn.EGNN``'s weights per layer, in the kernel's
    layout: matrices [L, H, H] as [in, out] and edge rows [L, 2, H] in the
    compute dtype; biases [L, H] in float32. Also carries the input and
    output embeddings in float32. Every entry is a copy: a snapshot of the
    weights as they are now, which later optimizer steps do not reach. The
    stacks are zero-padded to the kernel's width (``padded_width``), once,
    here; the embeddings keep H."""
    cfg = egnn.cfg
    hdim = cfg.hidden_nf
    blocks = [getattr(egnn, f"e_block_{i}") for i in range(cfg.n_layers)]

    def stack(fn, f32=False):
        t = torch.stack([fn(blk).detach() for blk in blocks])
        return t.float().contiguous() if f32 else t.to(compute_dtype).contiguous()

    def gcl(b):
        return b.gcl_0

    def cu(b):
        return b.coord_update

    p = {
        "wi": stack(lambda b: _kernel_io(gcl(b).edge_in.w_i)),
        "wj": stack(lambda b: _kernel_io(gcl(b).edge_in.w_j)),
        "wjb": stack(lambda b: gcl(b).edge_in.w_j.bias, True),
        "we": stack(lambda b: _kernel_io(gcl(b).edge_in.w_e)),
        "w2": stack(lambda b: _kernel_io(gcl(b).edge_out)),
        "w2b": stack(lambda b: gcl(b).edge_out.bias, True),
        "att": stack(lambda b: gcl(b).att.weight.reshape(hdim)),
        "attb": stack(lambda b: gcl(b).att.bias.reshape(()), True),
        "nih": stack(lambda b: _kernel_io(gcl(b).node_in)[:hdim]),
        "nia": stack(lambda b: _kernel_io(gcl(b).node_in)[hdim:]),
        "nib": stack(lambda b: gcl(b).node_in.bias, True),
        "no": stack(lambda b: _kernel_io(gcl(b).node_out)),
        "nob": stack(lambda b: gcl(b).node_out.bias, True),
        "cwi": stack(lambda b: _kernel_io(cu(b).coord_in.w_i)),
        "cwj": stack(lambda b: _kernel_io(cu(b).coord_in.w_j)),
        "cwjb": stack(lambda b: cu(b).coord_in.w_j.bias, True),
        "cwe": stack(lambda b: _kernel_io(cu(b).coord_in.w_e)),
        "cm": stack(lambda b: _kernel_io(cu(b).coord_mid)),
        "cmb": stack(lambda b: cu(b).coord_mid.bias, True),
        "cg": stack(lambda b: cu(b).coord_gate.weight.reshape(hdim)),
    }
    p = resize_stacks(p, padded_width(hdim, compute_dtype))
    p["emb_w"] = _kernel_io(egnn.embedding).detach().float().contiguous()
    p["emb_b"] = egnn.embedding.bias.detach().float().clone()
    p["out_w"] = _kernel_io(egnn.embedding_out).detach().float().contiguous()
    p["out_b"] = egnn.embedding_out.bias.detach().float().clone()
    return p


def _layers_plain(p, h0, x, idx, kmask, dist0, nmask, r_true, n_layers,
                  norm_constant, coords_range, norm_factor, tanh, cdt):
    """The kernel's layer stack in plain PyTorch, at h0's width H (the
    stacks are cut back to it). Returns (h [B,N,H] f32, x [B,N,3] f32)."""
    p = resize_stacks(p, h0.shape[-1])
    h = h0.to(cdt)
    x = x.float()
    idx = idx.long()
    km = kmask.float()
    d0c = dist0.to(cdt)
    nm = nmask.float()
    r = r_true
    inv = torch.tensor(1.0 / norm_factor, dtype=cdt, device=h.device)

    def mm(a, w):
        return a.float() @ w.float()

    for l in range(n_layers):
        # GCL message pass on a radial from x in the compute dtype
        wi = mm(h, p["wi"][l]).to(cdt)
        wj = (mm(h, p["wj"][l]) + p["wjb"][l]).to(cdt)
        xc = x.to(cdt)
        diff = xc[:, :, None, :] - gather_rows(xc, idx)
        radial = (diff * diff).sum(-1)
        pre = wi[:, :, None, :] + gather_rows(wj, idx)
        pre = pre + radial[..., None] * p["we"][l, 0]
        pre = pre + d0c[..., None] * p["we"][l, 1]
        m = silu_cdt(pre)
        m = silu_cdt((mm(m, p["w2"][l]) + p["w2b"][l]).to(cdt))
        gate = torch.sigmoid(mm(m, p["att"][l]) + p["attb"][l])
        agg = ksum(m * (gate * km).to(cdt)[..., None]) * inv
        # node MLP residual
        upd = silu_cdt((mm(h, p["nih"][l]) + mm(agg, p["nia"][l])
                        + p["nib"][l]).to(cdt))
        h = h + (mm(upd, p["no"][l]) + p["nob"][l]).to(cdt)
        h = h * nm.to(cdt)[..., None]
        # coordinate pass on the first r receivers, float32 x gather
        cwi = mm(h[:, :r], p["cwi"][l]).to(cdt)
        cwj = (mm(h, p["cwj"][l]) + p["cwjb"][l]).to(cdt)
        idx_r = idx[:, :r]
        diff_r = x[:, :r, None, :] - gather_rows(x, idx_r)
        radial_r = (diff_r * diff_r).sum(-1)
        pre_c = cwi[:, :, None, :] + gather_rows(cwj, idx_r)
        pre_c = pre_c + radial_r.to(cdt)[..., None] * p["cwe"][l, 0]
        pre_c = pre_c + d0c[:, :r, :, None] * p["cwe"][l, 1]
        o = silu_cdt(pre_c)
        o = silu_cdt((mm(o, p["cm"][l]) + p["cmb"][l]).to(cdt))
        g = mm(o, p["cg"][l])
        if tanh:
            g = torch.tanh(g) * coords_range
        cd = diff_r / (torch.sqrt(radial_r + 1e-8) + norm_constant)[..., None]
        trans = cd * g[..., None] * km[:, :r, :, None]
        x = torch.cat([x[:, :r] + ksum(trans) / norm_factor, x[:, r:]], dim=1)
        x = x * nm[..., None]
    return h.float(), x


def check_fused_shape(hdim: int, cdt: torch.dtype) -> None:
    """Raise ValueError, naming the limit, for a stack K2 cannot run:
    compute dtypes float32 and bfloat16, widths 1 <= H <=
    ``kernel_limits()["max_h"]``."""
    if cdt not in _DTYPE_CODE:
        raise ValueError(f"the fused kernel takes float32 or bfloat16, not {cdt}")
    padded_width(hdim, cdt)


class _K2Plan(ctypes.Structure):
    """csrc/egnn_plan.h: K2Plan, field for field."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "hp", "mma", "variant", "rows", "node_rows", "receivers", "chunk", "chunks")] + [
        ("items", ctypes.c_int * 4), ("max_items", ctypes.c_int), ("smem_bytes", ctypes.c_int)]


def launch_plan(b: int, n: int, k: int, hdim: int, r_true: int, cdt: torch.dtype,
                route: Optional[str] = None) -> Dict[str, object]:
    """The kernel's work decomposition (csrc/egnn_plan.h: k2_plan), passed
    to it.

    Each layer runs as four phases over the whole batch (csrc/egnn_fused.cu),
    each a list of work items that the blocks of one cooperative grid take
    in a strided loop: A, the node projections w_j, w_i (one item per
    ``rows``-row tile and matrix); B, the GCL messages (one item per R
    receivers of one sample); C, the node MLP and then the coordinate
    projections of the new h (one item per ``node_rows``-row tile); D, the
    coordinate pass (one item per R movable receivers of one sample). In B
    and D the kernel takes a last, partial round of items as half items
    where twice as many still fit in the grid and R >= 2. A receiver with
    more than ``rows`` edges is an item of its own, its edges taken in
    ``chunks`` tiles of ``chunk``. The stack runs at width ``hp``
    (``padded_width``); ``rows`` is 128 on the mma route (bf16, hp <= 256;
    ``route``: ``block_gemm_asked``), else the most, a multiple of 32, that
    fits in shared memory. The grid is capped at the largest phase's item
    count. ``variant``: the library of the launch's instantiation.
    Workspace: the four [B*N, hp] arrays (h, proj, wia, agg) and two
    [B*N, 3] coordinate buffers.
    """
    p = _K2Plan()
    st = _build.plan_library().egnn_k2_plan(b, n, k, hdim, r_true, int(cdt == torch.bfloat16),
                                            block_gemm_asked(route), ctypes.byref(p))
    if st == 4:
        raise ValueError(f"update_rows {r_true} outside [0, {n}]")
    if st:
        raise plan_error(st, hdim, f"empty layer stack: B={b}, N={n}, neighbor_k={k}")
    items = dict(zip("ABCD", p.items))
    return {"route": "mma" if p.mma else "block_gemm", "hp": p.hp, "rows": p.rows,
            "variant": p.variant, "node_rows": p.node_rows, "smem_bytes": p.smem_bytes,
            "receivers": p.receivers, "chunk": p.chunk, "chunks": p.chunks, "items": items,
            "max_items": p.max_items, "work": (4, b * n, p.hp), "coords": (2, b * n, 3)}


def _layers_kernel(p, h0, x, idx, kmask, dist0, nmask, r_true, n_layers,
                   norm_constant, coords_range, norm_factor, tanh, cdt, *,
                   stamps: Optional[torch.Tensor] = None, route: Optional[str] = None):
    """Launch csrc/egnn_fused.cu on CUDA tensors, or raise. ``stamps``: an
    int64 CUDA tensor of 1 + len(PHASES) * n_layers elements, or None; the
    kernel then writes one block's SM clock at its start and after each
    phase (:func:`phase_shares`). ``route``: :func:`launch_plan`'s."""
    with span("kernel.k2"):
        b, n, hdim = h0.shape
        k = idx.shape[-1]
        check_fused_shape(hdim, cdt)
        plan = launch_plan(b, n, k, hdim, int(r_true), cdt, route)
        hp = plan["hp"]
        dev = h0.device
        h0 = h0.to(cdt)
        if hp > hdim:
            h0 = F.pad(h0, (0, hp - hdim))
        h0 = h0.contiguous()
        x = x.to(torch.float32).contiguous()
        idx = idx.to(torch.int32).contiguous()
        kmask = kmask.to(torch.float32).contiguous()
        dist0 = dist0.to(torch.float32).contiguous()
        nmask = nmask.to(torch.float32).contiguous()
        L = n_layers
        shapes = {"wjb": (L, hp), "w2b": (L, hp), "attb": (L,),
                  "nib": (L, hp), "nob": (L, hp), "cwjb": (L, hp),
                  "cmb": (L, hp), "we": (L, 2, hp), "cwe": (L, 2, hp),
                  "att": (L, hp), "cg": (L, hp)}
        for t, name, shape, dt in (
            (h0, "h0", (b, n, hp), cdt), (x, "x", (b, n, 3), torch.float32),
            (idx, "idx", (b, n, k), torch.int32),
            (kmask, "kmask", (b, n, k), torch.float32),
            (dist0, "dist0", (b, n, k), torch.float32),
            (nmask, "nmask", (b, n), torch.float32),
        ):
            _check(t, name, shape, dt)
        for name in WEIGHT_NAMES:
            dt = torch.float32 if name in _F32_NAMES else cdt
            _check(p[name], name, shapes.get(name, (L, hp, hp)), dt)
        work = torch.empty(plan["work"], dtype=cdt, device=dev)
        coords = torch.empty(plan["coords"], dtype=torch.float32, device=dev)
        hout = torch.empty((b, n, hp), dtype=torch.float32, device=dev)
        xout = torch.empty((b, n, 3), dtype=torch.float32, device=dev)
        wptrs = (ctypes.c_void_p * len(WEIGHT_NAMES))(
            *[p[name].data_ptr() for name in WEIGHT_NAMES]
        )
        if stamps is not None:
            _check(stamps, "stamps", (1 + len(PHASES) * L,), torch.int64)
        grid = (ctypes.c_int * 3)()
        lib = _build.load("egnn_fused", plan["variant"])
        fn = lib.egnn_fused_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 11 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            _DTYPE_CODE[cdt], int(plan["route"] == "mma"), h0.data_ptr(), x.data_ptr(),
            idx.data_ptr(), kmask.data_ptr(), dist0.data_ptr(), nmask.data_ptr(),
            ctypes.cast(wptrs, ctypes.c_void_p), work.data_ptr(), coords.data_ptr(),
            hout.data_ptr(), xout.data_ptr(), b, n, k, hp, L, int(r_true),
            plan["receivers"], plan["rows"], plan["chunk"], plan["chunks"], plan["max_items"],
            float(norm_constant), float(coords_range), float(norm_factor),
            int(bool(tanh)), None if stamps is None else stamps.data_ptr(), stream,
            ctypes.cast(grid, ctypes.c_void_p),
        )
        if rc != 0:
            raise RuntimeError(f"egnn_fused cooperative launch failed: cudaError {rc}")
        egnn_forward_fused.launches += 1
        egnn_forward_fused.last_grid = {"blocks": grid[0], "blocks_per_sm": grid[1],
                                        "smem_bytes": grid[2]}
        return hout[..., :hdim], xout


def layer_args(params, h, x, edge_mask, node_mask, n_layers, neighbor_k,
               norm_constant, coords_range, normalization_factor, tanh,
               update_rows, compute_dtype):
    """The layer stack's arguments (for ``_layers_kernel`` or
    ``_layers_plain``): the neighbor list and dist0 from the entry
    coordinates and the input embedding, computed in PyTorch."""
    b, n, _ = h.shape
    kk = min(neighbor_k, n)
    x = x.float()
    d2 = ((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1)
    score = torch.where(edge_mask > 0, -d2, torch.full_like(d2, float("-inf")))
    idx = torch.topk(score, kk, dim=-1).indices
    kmask = torch.gather(edge_mask.float(), -1, idx)
    dist0k = torch.gather(d2, -1, idx)
    h0 = (h.float() @ params["emb_w"] + params["emb_b"]).to(compute_dtype)
    r_true = update_rows if update_rows is not None else n
    return (params, h0, x, idx, kmask, dist0k, node_mask, r_true, n_layers,
            norm_constant, coords_range, normalization_factor, tanh,
            compute_dtype)


PHASES = ("A node projections", "B messages",
          "C node MLP and coordinate projections", "D coordinate pass")


def phase_shares(stamps: torch.Tensor) -> Dict[str, float]:
    """Each phase's share of a launch's clock, summed over the layers, from
    the ``stamps`` that ``_layers_kernel`` filled (each share includes the
    phase's closing grid barrier)."""
    t = stamps.cpu().double()
    span = t[1:] - t[:-1]
    total = span.sum().item()
    return {name: span[i::len(PHASES)].sum().item() / total
            for i, name in enumerate(PHASES)}


def _forward(layers, params, h, x, edge_mask, node_mask, update_coords_mask,
             n_layers, neighbor_k, norm_constant, coords_range,
             normalization_factor, tanh, update_rows, compute_dtype):
    args = layer_args(params, h, x, edge_mask, node_mask, n_layers, neighbor_k,
                      norm_constant, coords_range, normalization_factor, tanh,
                      update_rows, compute_dtype)
    hout, xout = layers(*args)
    x = args[2]
    if update_coords_mask is not None:
        xout = x + (xout - x) * update_coords_mask[..., None]
    hfin = hout @ params["out_w"] + params["out_b"]
    hfin = hfin * node_mask[..., None]
    return hfin.float(), xout.float()


def egnn_forward_fused(
    params: Dict[str, torch.Tensor],
    h: torch.Tensor,              # [B, N, D_in]
    x: torch.Tensor,              # [B, N, 3]
    edge_mask: torch.Tensor,      # [B, N, N]
    node_mask: torch.Tensor,      # [B, N]
    update_coords_mask: Optional[torch.Tensor],
    n_layers: int,
    neighbor_k: int,
    norm_constant: float = 1.0,
    coords_range: float = 15.0,
    normalization_factor: float = 100.0,
    tanh: bool = True,
    update_rows: Optional[int] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
):
    """``models.egnn.EGNN`` (inv_sublayers=1, neighbor list) with the layer
    stack in one kernel launch on CUDA tensors (counted in
    ``egnn_forward_fused.launches``), or in plain PyTorch on CPU tensors.
    ``params`` comes from :func:`fused_params`. Returns (h_out [B,N,D_out],
    x_out [B,N,3]), both float32. On CUDA tensors it raises where an input
    requires grad under grad mode: the kernel has no backward pass."""
    if h.device.type == "cpu":
        layers = _layers_plain
    else:
        refuse_autograd("egnn_forward_fused", h, x, *params.values())
        layers = _layers_kernel
    return _forward(layers, params, h, x, edge_mask, node_mask,
                    update_coords_mask, n_layers, neighbor_k, norm_constant,
                    coords_range, normalization_factor, tanh, update_rows,
                    compute_dtype)


egnn_forward_fused.launches = 0
# the grid of the last launch: blocks, blocks per SM, shared memory per block
egnn_forward_fused.last_grid = None


def egnn_forward_fused_plain(params, h, x, edge_mask, node_mask,
                             update_coords_mask, n_layers, neighbor_k,
                             norm_constant=1.0, coords_range=15.0,
                             normalization_factor=100.0, tanh=True,
                             update_rows=None,
                             compute_dtype=torch.bfloat16):
    """:func:`egnn_forward_fused` with the layer stack in plain PyTorch on
    any device."""
    return _forward(_layers_plain, params, h, x, edge_mask, node_mask,
                    update_coords_mask, n_layers, neighbor_k, norm_constant,
                    coords_range, normalization_factor, tanh, update_rows,
                    compute_dtype)
