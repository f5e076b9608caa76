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
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from cmdgen_tpu_torch.ops import _build
from cmdgen_tpu_torch.ops.egnn_msgpass import (
    _DTYPE_CODE,
    _check,
    _check_width,
    gather_rows,
    ksum,
    silu_cdt,
)

# kernel argument order (csrc/egnn_fused.cu: FusedWeights)
WEIGHT_NAMES = (
    "wi", "wj", "wjb", "we", "w2", "w2b", "att", "attb",
    "nih", "nia", "nib", "no", "nob",
    "cwi", "cwj", "cwjb", "cwe", "cm", "cmb", "cg",
)
_F32_NAMES = frozenset({"wjb", "w2b", "attb", "nib", "nob", "cwjb", "cmb"})


def _kernel_io(lin: torch.nn.Linear) -> torch.Tensor:
    """A Linear's weight [out, in] in the kernels' [in, out] layout."""
    return lin.weight.t()


def fused_params(egnn, compute_dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Stack an ``models.egnn.EGNN``'s weights per layer, in the kernel's
    layout: matrices [L, H, H] as [in, out] and edge rows [L, 2, H] in the
    compute dtype; biases [L, H] in float32. Also carries the input and
    output embeddings in float32."""
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
    p["emb_w"] = _kernel_io(egnn.embedding).detach().float().contiguous()
    p["emb_b"] = egnn.embedding.bias.detach().float().contiguous()
    p["out_w"] = _kernel_io(egnn.embedding_out).detach().float().contiguous()
    p["out_b"] = egnn.embedding_out.bias.detach().float().contiguous()
    return p


def _layers_plain(p, h0, x, idx, kmask, dist0, nmask, r_true, n_layers,
                  norm_constant, coords_range, norm_factor, tanh, cdt):
    """The kernel's layer stack in plain PyTorch. Returns (h [B,N,H] f32,
    x [B,N,3] f32)."""
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


def _layers_kernel(p, h0, x, idx, kmask, dist0, nmask, r_true, n_layers,
                   norm_constant, coords_range, norm_factor, tanh, cdt):
    """Launch csrc/egnn_fused.cu on CUDA tensors, or raise."""
    if cdt not in _DTYPE_CODE:
        raise ValueError(f"unsupported compute dtype {cdt}")
    b, n, hdim = h0.shape
    k = idx.shape[-1]
    _check_width(hdim, cdt)
    dev = h0.device
    h0 = h0.to(cdt).contiguous()
    x = x.to(torch.float32).contiguous()
    idx = idx.to(torch.int32).contiguous()
    kmask = kmask.to(torch.float32).contiguous()
    dist0 = dist0.to(torch.float32).contiguous()
    nmask = nmask.to(torch.float32).contiguous()
    L = n_layers
    shapes = {"wjb": (L, hdim), "w2b": (L, hdim), "attb": (L,),
              "nib": (L, hdim), "nob": (L, hdim), "cwjb": (L, hdim),
              "cmb": (L, hdim), "we": (L, 2, hdim), "cwe": (L, 2, hdim),
              "att": (L, hdim), "cg": (L, hdim)}
    for t, name, shape, dt in (
        (h0, "h0", (b, n, hdim), cdt), (x, "x", (b, n, 3), torch.float32),
        (idx, "idx", (b, n, k), torch.int32),
        (kmask, "kmask", (b, n, k), torch.float32),
        (dist0, "dist0", (b, n, k), torch.float32),
        (nmask, "nmask", (b, n), torch.float32),
    ):
        _check(t, name, shape, dt)
    for name in WEIGHT_NAMES:
        dt = torch.float32 if name in _F32_NAMES else cdt
        _check(p[name], name, shapes.get(name, (L, hdim, hdim)), dt)
    if not 0 <= r_true <= n:
        raise ValueError(f"update_rows {r_true} outside [0, {n}]")
    # three [N, H] arrays per sample, rows rounded up to whole 16-row tiles
    scratch = torch.empty((b, 3 * (-(-n // 16) * 16), hdim), dtype=cdt, device=dev)
    hout = torch.empty((b, n, hdim), dtype=torch.float32, device=dev)
    xout = torch.empty((b, n, 3), dtype=torch.float32, device=dev)
    wptrs = (ctypes.c_void_p * len(WEIGHT_NAMES))(
        *[p[name].data_ptr() for name in WEIGHT_NAMES]
    )
    lib = _build.load("egnn_fused")
    fn = lib.egnn_fused_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p,
    ]
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(
        _DTYPE_CODE[cdt], h0.data_ptr(), x.data_ptr(), idx.data_ptr(),
        kmask.data_ptr(), dist0.data_ptr(), nmask.data_ptr(),
        ctypes.cast(wptrs, ctypes.c_void_p), scratch.data_ptr(),
        hout.data_ptr(), xout.data_ptr(), b, n, k, hdim, L, int(r_true),
        float(norm_constant), float(coords_range), float(norm_factor),
        int(bool(tanh)), stream,
    )
    if rc != 0:
        raise RuntimeError(f"egnn_fused kernel launch failed: cudaError {rc}")
    egnn_forward_fused.launches += 1
    return hout, xout


def _forward(layers, params, h, x, edge_mask, node_mask, update_coords_mask,
             n_layers, neighbor_k, norm_constant, coords_range,
             normalization_factor, tanh, update_rows, compute_dtype):
    b, n, _ = h.shape
    kk = min(neighbor_k, n)
    x = x.float()
    # neighbor list from the entry coordinates
    d2 = ((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1)
    score = torch.where(edge_mask > 0, -d2, torch.full_like(d2, float("-inf")))
    idx = torch.topk(score, kk, dim=-1).indices
    kmask = torch.gather(edge_mask.float(), -1, idx)
    dist0k = torch.gather(d2, -1, idx)
    h0 = (h.float() @ params["emb_w"] + params["emb_b"]).to(compute_dtype)
    r_true = update_rows if update_rows is not None else n
    hout, xout = layers(
        params, h0, x, idx, kmask, dist0k, node_mask, r_true, n_layers,
        norm_constant, coords_range, normalization_factor, tanh,
        compute_dtype,
    )
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
    x_out [B,N,3]), both float32."""
    layers = _layers_plain if h.device.type == "cpu" else _layers_kernel
    return _forward(layers, params, h, x, edge_mask, node_mask,
                    update_coords_mask, n_layers, neighbor_k, norm_constant,
                    coords_range, normalization_factor, tanh, update_rows,
                    compute_dtype)


egnn_forward_fused.launches = 0


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
