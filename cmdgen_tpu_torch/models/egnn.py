"""E(n)-equivariant graph network over padded dense point clouds
(counterpart of ``cmdgen_tpu/models/egnn.py``).

Two engines, as in the JAX package:
- dense: every sample is an [N, N] pair block with an edge mask;
- neighbor list (``neighbor_k``): the K nearest valid edges of each
  receiver, messages on gathered [B, N, K, H] tensors. With sum
  aggregation the GCL message pass always goes through
  ``ops.egnn_msgpass.gcl_message_agg`` (the CUDA kernel on the GPU, its
  plain version on the CPU).

Module and parameter names follow the flax tree, so ``convert.py`` maps a
flax path ``a/b/kernel`` onto ``a.b.weight`` (transposed). The first pair
layer keeps flax's split into ``w_i``, ``w_j`` and ``w_e``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cmdgen_tpu_torch.ops.egnn_msgpass import gather_rows, gcl_message_agg


@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    hidden_nf: int = 256
    n_layers: int = 3          # number of EquivariantBlocks
    inv_sublayers: int = 1     # GCLs per block
    attention: bool = True
    tanh: bool = True
    coords_range: float = 15.0
    norm_constant: float = 1.0
    normalization_factor: float = 100.0
    aggregation_method: str = "sum"  # 'sum' (divide by factor) or 'mean'
    compute_dtype: torch.dtype = torch.float32
    # fixed-K neighbor-list message passing (None => dense [N,N] pair blocks)
    neighbor_k: Optional[int] = None
    # not ported yet (off in every shipped config)
    sin_embedding: bool = False


def linear(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)``: inputs, kernel and bias cast to dtype."""
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


def build_neighbor_list(x: torch.Tensor, edge_mask: torch.Tensor, k: int):
    """The K nearest valid edges of each receiver (self-edges first).

    x [B, N, 3], edge_mask [B, N, N] -> (kmask [B, N, K] float32 validity,
    idx [B, N, K] int64). Rows with fewer than K edges get kmask 0 on the
    rest. The selected set equals the JAX package's (order within K may
    differ, which the K-sum is invariant to)."""
    k = min(k, x.shape[-2])
    d2 = ((x[..., :, None, :] - x[..., None, :, :]) ** 2).sum(-1)
    score = torch.where(edge_mask > 0, -d2, torch.full_like(d2, float("-inf")))
    idx = torch.topk(score, k, dim=-1).indices
    kmask = torch.gather(edge_mask.float(), -1, idx)
    return kmask, idx


def coord2diff(x: torch.Tensor, norm_constant: float = 1.0):
    """Dense pairwise squared distances [B,N,N,1] and normalized differences."""
    diff = x[..., :, None, :] - x[..., None, :, :]
    radial = (diff ** 2).sum(-1, keepdim=True)
    norm = torch.sqrt(radial + 1e-8)
    return radial, diff / (norm + norm_constant)


def _aggregate(msg, edge_mask, cfg: EGNNConfig):
    """Masked aggregation over the source axis (-2) of [B, N, J, D]."""
    msg = msg * edge_mask[..., None]
    agg = msg.sum(-2)
    if cfg.aggregation_method == "sum":
        return agg / cfg.normalization_factor
    if cfg.aggregation_method == "mean":
        count = edge_mask.sum(-1, keepdim=True)
        return agg / count.clamp_min(1.0)
    raise ValueError(cfg.aggregation_method)


class PairFirstLayer(nn.Module):
    """First pair-MLP layer, Dense([h_i ‖ h_j ‖ e_ij]) without the concat:
    w_i h_i + (w_j h_j + b) + w_e e_ij."""

    def __init__(self, in_nf: int, features: int, edge_nf: int = 2):
        super().__init__()
        self.w_i = nn.Linear(in_nf, features, bias=False)
        self.w_j = nn.Linear(in_nf, features)
        self.w_e = nn.Linear(edge_nf, features, bias=False)

    def project(self, h, dtype, rows=None):
        """(w_i h[:rows], w_j h + b) in dtype, without the pair tensor."""
        hi = h if rows is None else h[:, :rows]
        return linear(hi, self.w_i, dtype), linear(h, self.w_j, dtype)

    def forward(self, h, e, dtype, nbr_idx=None, rows=None):
        """e: [B, R, J, E] edge features -> [B, R, J, H], J = N (dense) or
        K (gathered at nbr_idx [B, R, K])."""
        wi, wj = self.project(h, dtype, rows)
        wj_pair = wj[:, None, :, :] if nbr_idx is None else gather_rows(wj, nbr_idx)
        out = wi[:, :, None, :] + wj_pair
        kernel = self.w_e.weight.t().to(dtype)  # [E, H]
        e = e.to(dtype)
        for c in range(e.shape[-1]):
            out = out + e[..., c : c + 1] * kernel[c]
        return out


class GCL(nn.Module):
    """Invariant message-passing sublayer."""

    def __init__(self, cfg: EGNNConfig):
        super().__init__()
        hdim = cfg.hidden_nf
        self.cfg = cfg
        self.edge_in = PairFirstLayer(hdim, hdim)
        self.edge_out = nn.Linear(hdim, hdim)
        if cfg.attention:
            self.att = nn.Linear(hdim, 1)
        self.node_in = nn.Linear(2 * hdim, hdim)
        self.node_out = nn.Linear(hdim, hdim)

    def forward(self, h, edge_attr, edge_mask, nbr_idx=None):
        cfg = self.cfg
        dt = cfg.compute_dtype
        hdim = cfg.hidden_nf
        if nbr_idx is not None and cfg.aggregation_method == "sum":
            wi, wj = self.edge_in.project(h, dt)
            att = (self.att.weight.reshape(hdim), self.att.bias) if cfg.attention else None
            agg = gcl_message_agg(
                wi, wj, nbr_idx, edge_attr[..., 0], edge_attr[..., 1],
                edge_mask, self.edge_in.w_e.weight.t(), self.edge_out.weight.t(),
                self.edge_out.bias, att, cfg.normalization_factor,
                compute_dtype=dt,
            ).to(dt)
        else:
            mij = F.silu(self.edge_in(h, edge_attr, dt, nbr_idx))
            mij = F.silu(linear(mij, self.edge_out, dt))
            if cfg.attention:
                gate = (mij * self.att.weight[0].to(dt)).sum(-1, keepdim=True)
                mij = mij * torch.sigmoid(gate + self.att.bias.to(dt))
            agg = _aggregate(mij, edge_mask, cfg)
        # node model: residual MLP over [h, agg], node_in split at the seam
        kin = self.node_in.weight.to(dt)  # [H, 2H]
        upd = (h.to(dt) @ kin[:, :hdim].t() + agg.to(dt) @ kin[:, hdim:].t()
               + self.node_in.bias.to(dt))
        upd = linear(F.silu(upd), self.node_out, dt)
        return h + upd


class EquivariantUpdate(nn.Module):
    """Coordinate update sublayer."""

    def __init__(self, cfg: EGNNConfig, coords_range_layer: float):
        super().__init__()
        hdim = cfg.hidden_nf
        self.cfg = cfg
        self.coords_range_layer = coords_range_layer
        self.coord_in = PairFirstLayer(hdim, hdim)
        self.coord_mid = nn.Linear(hdim, hdim)
        self.coord_gate = nn.Linear(hdim, 1, bias=False)

    def forward(self, h, x, coord_diff, edge_attr, edge_mask,
                update_coords_mask, nbr_idx=None, update_rows=None):
        """update_rows: only the first ``update_rows`` receivers move (the
        conditional model's pharmacophore nodes); the frozen rows' pair
        messages are never computed, which is exact."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        r = update_rows
        if r is not None:
            edge_attr = edge_attr[:, :r]
            coord_diff = coord_diff[:, :r]
            edge_mask = edge_mask[:, :r]
            if nbr_idx is not None:
                nbr_idx = nbr_idx[:, :r]
        out = F.silu(self.coord_in(h, edge_attr, dt, nbr_idx, rows=r))
        out = F.silu(linear(out, self.coord_mid, dt))
        gate = linear(out, self.coord_gate, dt)
        if cfg.tanh:
            trans = coord_diff * torch.tanh(gate) * self.coords_range_layer
        else:
            trans = coord_diff * gate
        agg = _aggregate(trans, edge_mask, cfg)
        if r is not None:
            agg = F.pad(agg, (0, 0, 0, x.shape[-2] - r))
        if update_coords_mask is not None:
            agg = agg * update_coords_mask[..., None]
        return x + agg.to(x.dtype)


class EquivariantBlock(nn.Module):
    """inv_sublayers GCLs + one coordinate update."""

    def __init__(self, cfg: EGNNConfig, coords_range_layer: float):
        super().__init__()
        self.cfg = cfg
        for i in range(cfg.inv_sublayers):
            self.add_module(f"gcl_{i}", GCL(cfg))
        self.coord_update = EquivariantUpdate(cfg, coords_range_layer)

    def forward(self, h, x, dist0, edge_mask, node_mask, update_coords_mask,
                nbr_idx=None, update_rows=None):
        cfg = self.cfg
        if nbr_idx is None:
            radial, coord_diff = coord2diff(x, cfg.norm_constant)
        else:
            diff = x[:, :, None, :] - gather_rows(x, nbr_idx)
            radial = (diff ** 2).sum(-1, keepdim=True)
            coord_diff = diff / (torch.sqrt(radial + 1e-8) + cfg.norm_constant)
        edge_attr = torch.cat([radial.to(cfg.compute_dtype), dist0], dim=-1)
        for i in range(cfg.inv_sublayers):
            h = getattr(self, f"gcl_{i}")(h, edge_attr, edge_mask, nbr_idx)
            h = h * node_mask[..., None]
        x = self.coord_update(h, x, coord_diff, edge_attr, edge_mask,
                              update_coords_mask, nbr_idx, update_rows)
        x = x * node_mask[..., None]
        h = h * node_mask[..., None]
        return h, x


class EGNN(nn.Module):
    """Full EGNN stack over a padded dense batch.

    forward(h [B,N,D_in], x [B,N,3], edge_mask [B,N,N] (self-edges set),
            node_mask [B,N], update_coords_mask [B,N] or None,
            update_rows int or None) -> (h_out [B,N,D_out], x_out [B,N,3]),
    both float32.
    """

    def __init__(self, cfg: EGNNConfig, in_node_nf: int, out_node_nf: int):
        super().__init__()
        if cfg.sin_embedding:
            raise NotImplementedError("sin_embedding is not ported yet")
        self.cfg = cfg
        self.embedding = nn.Linear(in_node_nf, cfg.hidden_nf)
        # the reference hands the full coords_range to every block
        for i in range(cfg.n_layers):
            self.add_module(f"e_block_{i}", EquivariantBlock(cfg, cfg.coords_range))
        self.embedding_out = nn.Linear(cfg.hidden_nf, out_node_nf)

    def forward(self, h, x, edge_mask, node_mask, update_coords_mask=None,
                update_rows=None):
        cfg = self.cfg
        dt = cfg.compute_dtype
        if cfg.neighbor_k is not None:
            kmask, nbr_idx = build_neighbor_list(x, edge_mask, cfg.neighbor_k)
            dist0 = ((x[:, :, None, :] - gather_rows(x, nbr_idx)) ** 2).sum(
                -1, keepdim=True)
            edge_mask = kmask.to(dt)
        else:
            nbr_idx = None
            dist0, _ = coord2diff(x)
        dist0 = dist0.to(dt)
        h = linear(h, self.embedding, dt)
        for i in range(cfg.n_layers):
            h, x = getattr(self, f"e_block_{i}")(
                h, x, dist0, edge_mask, node_mask, update_coords_mask,
                nbr_idx, update_rows,
            )
        h = linear(h, self.embedding_out, dt)
        h = h * node_mask[..., None]
        return h.float(), x.float()
