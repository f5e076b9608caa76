"""K3: the coordinate update of one EGNN block on the fixed-K neighbor list
(``models.egnn.EquivariantUpdate`` on the neighbor-list engine with sum
aggregation and the two raw edge scalars).

``coord_update_agg`` launches the hand-written CUDA kernel on CUDA tensors
and raises if it cannot: K1's kernel body with the coordinate epilogue
(``csrc/egnn_msgpass.cu``), prepared by K1's wrapper
(``egnn_msgpass.prepare_edge_pass``). On CPU tensors it runs
``coord_update_agg_plain``, the same function in plain PyTorch with the
kernel's casts. It takes what the sublayer has: the ``coord_in``
projections ``w_i h`` of the rows that move and ``w_j h + b`` of every row,
the neighbor list and its edge scalars over every row, x in float32 and the
optional update-coordinates mask; the weights in K1's layout (``we`` [2,
H], ``wm`` [H, H] as [in, out], the transposed views of the ``nn.Linear``
weights the model passes as they lie). The rows that move are the first
``wi.shape[1]``. The difference x_i - x_j and the squared distance are
taken from a float32 gather of x, as K2's coordinate phase takes them, so
the kernel reads no radial and builds no [B, N, K, 3] tensor; the pair
layer rounds the squared distance to the compute dtype, as the model's edge
features do.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from cmdgen_tpu_torch.ops.egnn_msgpass import (
    EdgeRows,
    edge_plan,
    gather_rows,
    ksum,
    prepare_edge_pass,
    refuse_autograd,
    silu_cdt,
)
from cmdgen_tpu_torch.utils.profiling import span


def coord_update_agg_plain(
    wi: torch.Tensor,          # [B, R, H] w_i h of the rows that move
    wj: torch.Tensor,          # [B, N, H] w_j h + b
    idx: torch.Tensor,         # [B, N, K] neighbor indices
    dist0: torch.Tensor,       # [B, N, K] entry squared distances
    kmask: torch.Tensor,       # [B, N, K] edge validity
    x: torch.Tensor,           # [B, N, 3] coordinates
    update_coords_mask: Optional[torch.Tensor],  # [B, N] or None
    we: torch.Tensor,          # [2, H] coord_in's edge-feature rows
    wm: torch.Tensor,          # [H, H] coord_mid kernel, [in, out]
    bm: torch.Tensor,          # [H] coord_mid bias
    wg: torch.Tensor,          # [H] coord_gate kernel
    coords_range: float,
    norm_constant: float,
    norm_factor: float,
    use_tanh: bool = True,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with its casts: x + agg
    [B, N, 3] in x's dtype, agg over the first R rows' edges in k order,
    divided by ``norm_factor``, times ``update_coords_mask``, zero past R."""
    cdt = compute_dtype or wi.dtype
    r, n = wi.shape[1], x.shape[1]
    wi, wj, we = wi.to(cdt), wj.to(cdt), we.to(cdt)
    idx = idx[:, :r].long().clamp(0, n - 1)
    xf = x.float()
    diff = xf[:, :r, None, :] - gather_rows(xf, idx)
    radial = (diff ** 2).sum(-1)
    pre = wi[:, :, None, :] + gather_rows(wj, idx)
    pre = pre + radial.to(cdt)[..., None] * we[0]
    pre = pre + dist0[:, :r].to(cdt)[..., None] * we[1]
    m = silu_cdt(pre)
    m = silu_cdt((m.float() @ wm.to(cdt).float() + bm.float()).to(cdt))
    gate = (m.float() @ wg.reshape(-1).to(cdt).float()).to(cdt)
    gate = (torch.tanh(gate).float() * coords_range) if use_tanh else gate.float()
    trans = diff / (torch.sqrt(radial + 1e-8) + norm_constant)[..., None] * gate[..., None]
    agg = ksum(trans * kmask[:, :r].float()[..., None]) / norm_factor
    if update_coords_mask is not None:
        agg = agg * update_coords_mask[:, :r, None].float()
    out = xf.clone()
    out[:, :r] += agg
    return out.to(x.dtype)


def launch_plan(b: int, n: int, r: int, k: int, h: int, cdt: torch.dtype, sms: int,
                route: Optional[str] = None) -> dict:
    """The kernel's work decomposition (``egnn_msgpass.edge_plan``), passed
    to it: K1's plan (``egnn_msgpass.launch_plan``: the width, the route,
    the rows of a tile, the work list's size and the grid) over the first
    ``r`` receivers of each sample, its tiles also holding each edge's
    coordinate difference; the grid is one block at least, which copies
    the rows that do not move where none moves."""
    return edge_plan(b, n, r, k, h, cdt, sms, route, True)


def prepare_launch(wi, wj, idx, dist0, kmask, x, update_coords_mask, we, wm, bm, wg,
                   coords_range, norm_constant, norm_factor, use_tanh=True,
                   compute_dtype=None, *, route: Optional[str] = None
                   ) -> Callable[..., torch.Tensor]:
    """Everything :func:`coord_update_agg` does on CUDA tensors before the
    launch (``egnn_msgpass.prepare_edge_pass``). Returns
    ``run(stamps=None)``, which launches the pre-pass and the kernel
    (counted in ``coord_update_agg.launches``) and returns x + agg [B, N, 3] float32;
    ``stamps``: as K1's (``egnn_msgpass.stage_shares``). ``route``:
    :func:`launch_plan`'s."""
    return prepare_edge_pass(coord_update_agg, wi, wj, idx, None, dist0, kmask, we, wm, bm,
                             (wg, None), norm_factor, compute_dtype, route=route,
                             coords=(x, update_coords_mask, coords_range, norm_constant,
                                     use_tanh))


def coord_update_agg(wi, wj, idx, dist0, kmask, x, update_coords_mask, we, wm, bm, wg,
                     coords_range: float, norm_constant: float, norm_factor: float,
                     use_tanh: bool = True,
                     compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The coordinate update x + agg. Same arguments and result as
    :func:`coord_update_agg_plain`. On CUDA tensors
    this launches the kernel (and counts the launch in
    ``coord_update_agg.launches``, its edge rows in
    ``coord_update_agg.edge_rows``) or raises, also where an input requires
    grad under grad mode (``refuse_autograd``)."""
    if wi.device.type == "cpu":
        return coord_update_agg_plain(wi, wj, idx, dist0, kmask, x, update_coords_mask, we, wm,
                                      bm, wg, coords_range, norm_constant, norm_factor,
                                      use_tanh, compute_dtype)
    with span("kernel.coord"):
        refuse_autograd("coord_update_agg", wi, wj, dist0, kmask, x, we, wm, bm, wg)
        return prepare_launch(wi, wj, idx, dist0, kmask, x, update_coords_mask, we, wm, bm, wg,
                              coords_range, norm_constant, norm_factor, use_tanh,
                              compute_dtype)().to(x.dtype)


coord_update_agg.launches = 0
coord_update_agg.edge_rows = EdgeRows()
