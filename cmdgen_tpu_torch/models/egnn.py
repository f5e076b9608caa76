"""E(n)-equivariant graph network over padded dense point clouds
(counterpart of ``cmdgen_tpu/models/egnn.py``).

Two engines, as in the JAX package:
- dense: every sample is an [N, N] pair block with an edge mask;
- neighbor list (``neighbor_k``): the K nearest valid edges of each
  receiver, messages on gathered [B, N, K, H] tensors. With sum
  aggregation and the two raw edge features (radial, dist0) the GCL
  message pass goes through ``ops.egnn_msgpass.gcl_message_agg`` (the CUDA
  kernel on the GPU, its plain version on the CPU), as the JAX package
  sends only such GCLs to its Pallas kernel, at any hidden width; with
  ``sin_embedding`` (24 edge features), or where autograd records the
  forward pass (``ops.egnn_msgpass.kernel_route``: the kernel has no
  backward pass, as the JAX package's has none), it runs in PyTorch. Training therefore takes the torch message path, as the JAX
  package's training takes XLA's, and every sampler, under
  ``torch.no_grad()``, takes the kernel. Under the same conditions the
  coordinate update goes through ``ops.egnn_coord.coord_update_agg``
  (K3: one kernel a block, the plain version on the CPU).

Under autograd each ``EquivariantBlock`` is checkpointed (``remat``, the
JAX package's ``nn.remat`` default): the backward pass recomputes a
block's pair activations instead of keeping them.

``GNN`` is the plain (non-equivariant) network of the ``gnn_dynamics``
mode: GCLs without edge features over the dense adjacency.

Under tensor parallelism (``parallel.mesh.tp_shard``) every Dense goes
through ``linear`` (or, for the node MLP's split first layer,
``column_parallel`` directly), which computes a rank's own output columns
of a column-split weight; the first pair layer's tiny edge kernel is
gathered whole at use. The kernels' path reads plain weights only: it
runs on unsharded evaluation copies.

Module and parameter names follow the flax tree, so ``convert.py`` maps a
flax path ``a/b/kernel`` onto ``a.b.weight`` (transposed). The first pair
layer keeps flax's split into ``w_i``, ``w_j`` and ``w_e``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from cmdgen_tpu_torch.ops.egnn_coord import coord_update_agg
from cmdgen_tpu_torch.ops.egnn_msgpass import gather_rows, gcl_message_agg, kernel_route
from cmdgen_tpu_torch.parallel.mesh import column_parallel, full_weight


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
    # sinusoidal distance features instead of raw squared distances
    # (off in every shipped config)
    sin_embedding: bool = False


# SinusoidsEmbeddingNew: max_res 15, min_res 15/2000, div_factor 4 ->
# 6 geometric frequencies, 12 features. The float32 frequencies are formed
# on the host, as the JAX package forms them: formed on the GPU they
# differed from the CPU's in the last bit, and at phases of ~2,600 rad
# that moved the denoiser's output by ~1e-3 even in float64.
_SIN_N_FREQ = int(math.log(2000.0, 4.0)) + 1
_SIN_FREQS = 2.0 * math.pi * (4.0 ** torch.arange(_SIN_N_FREQ)) / 15.0


def sinusoids_embedding(d2: torch.Tensor) -> torch.Tensor:
    """Sin/cos of sqrt(d2) at 6 geometric frequencies: [..., 1] -> [..., 12],
    constant features (detached, as the JAX package stops their gradient)."""
    emb = torch.sqrt(d2.detach() + 1e-8) * _SIN_FREQS.to(d2.device)
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


def edge_features(cfg: EGNNConfig) -> int:
    """Width of the EGNN's edge features: (radial, dist0), each raw or
    sinusoid-embedded."""
    return 2 * (2 * _SIN_N_FREQ if cfg.sin_embedding else 1)


def linear(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)``: inputs, kernel and bias cast to dtype.
    A weight column-split over ``tp`` computes this rank's output columns
    and gathers them (``parallel.mesh.column_parallel``)."""
    (x,), w, b, gather = column_parallel(lin, x)
    bias = None if b is None else b.to(dtype)
    return gather(F.linear(x.to(dtype), w.to(dtype), bias))


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
        if edge_nf:  # the plain GNN's GCLs take no edge features
            self.w_e = nn.Linear(edge_nf, features, bias=False)

    def project(self, h, dtype, rows=None):
        """(w_i h[:rows], w_j h + b) in dtype, without the pair tensor."""
        hi = h if rows is None else h[:, :rows]
        return linear(hi, self.w_i, dtype), linear(h, self.w_j, dtype)

    def forward(self, h, e, dtype, nbr_idx=None, rows=None):
        """e: [B, R, J, E] edge features or None -> [B, R, J, H], J = N
        (dense) or K (gathered at nbr_idx [B, R, K])."""
        wi, wj = self.project(h, dtype, rows)
        wj_pair = wj[:, None, :, :] if nbr_idx is None else gather_rows(wj, nbr_idx)
        out = wi[:, :, None, :] + wj_pair
        if e is None:
            return out
        kernel = full_weight(self.w_e.weight).t().to(dtype)  # [E, H]
        e = e.to(dtype)
        for c in range(e.shape[-1]):
            out = out + e[..., c : c + 1] * kernel[c]
        return out


class GCL(nn.Module):
    """Invariant message-passing sublayer."""

    def __init__(self, cfg: EGNNConfig, edge_nf: int):
        super().__init__()
        hdim = cfg.hidden_nf
        self.cfg = cfg
        self.edge_in = PairFirstLayer(hdim, hdim, edge_nf)
        self.edge_out = nn.Linear(hdim, hdim)
        if cfg.attention:
            self.att = nn.Linear(hdim, 1)
        self.node_in = nn.Linear(2 * hdim, hdim)
        self.node_out = nn.Linear(hdim, hdim)

    def forward(self, h, edge_attr, edge_mask, nbr_idx=None):
        cfg = self.cfg
        dt = cfg.compute_dtype
        hdim = cfg.hidden_nf
        # K1 takes neighbor-list GCLs with sum aggregation and the two edge
        # scalars, outside autograd; the rest take the torch path
        if (nbr_idx is not None and cfg.aggregation_method == "sum"
                and edge_attr.shape[-1] == 2 and kernel_route()):
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
        (hh, aa), kin, kb, gather = column_parallel(self.node_in, h, agg)
        kin = kin.to(dt)  # [H, 2H]
        upd = gather(hh.to(dt) @ kin[:, :hdim].t() + aa.to(dt) @ kin[:, hdim:].t() + kb.to(dt))
        upd = linear(F.silu(upd), self.node_out, dt)
        return h + upd


def nbr_coord_diff(x, nbr_idx, norm_constant):
    """The normalised differences x_i - x_j [B, R, K, 3] of the first R
    receivers (``nbr_idx`` [B, R, K]) to their neighbors."""
    r = nbr_idx.shape[1]
    diff = x[:, :r, None, :] - gather_rows(x, nbr_idx)
    return diff / (torch.sqrt((diff ** 2).sum(-1, keepdim=True) + 1e-8) + norm_constant)


class EquivariantUpdate(nn.Module):
    """Coordinate update sublayer."""

    def __init__(self, cfg: EGNNConfig, coords_range_layer: float):
        super().__init__()
        hdim = cfg.hidden_nf
        self.cfg = cfg
        self.coords_range_layer = coords_range_layer
        self.coord_in = PairFirstLayer(hdim, hdim, edge_features(cfg))
        self.coord_mid = nn.Linear(hdim, hdim)
        self.coord_gate = nn.Linear(hdim, 1, bias=False)

    def forward(self, h, x, coord_diff, edge_attr, edge_mask,
                update_coords_mask, nbr_idx=None, update_rows=None):
        """update_rows: only the first ``update_rows`` receivers move (the
        conditional model's pharmacophore nodes); the frozen rows' pair
        messages are never computed, which is exact. coord_diff: the dense
        engine's [B, N, N, 3]; None on the neighbor list, where K3 takes the
        differences from x and the torch path gathers them
        (:func:`nbr_coord_diff`)."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        r = update_rows
        # K3 takes the neighbor-list update under K1's conditions (models.egnn.GCL)
        if (nbr_idx is not None and cfg.aggregation_method == "sum"
                and edge_attr.shape[-1] == 2 and kernel_route()):
            wi, wj = self.coord_in.project(h, dt, rows=r)
            return coord_update_agg(
                wi, wj, nbr_idx, edge_attr[..., 1], edge_mask, x, update_coords_mask,
                self.coord_in.w_e.weight.t(), self.coord_mid.weight.t(), self.coord_mid.bias,
                self.coord_gate.weight.reshape(cfg.hidden_nf), self.coords_range_layer,
                cfg.norm_constant, cfg.normalization_factor, cfg.tanh, compute_dtype=dt)
        if r is not None:
            edge_attr = edge_attr[:, :r]
            edge_mask = edge_mask[:, :r]
            if nbr_idx is not None:
                nbr_idx = nbr_idx[:, :r]
            if coord_diff is not None:
                coord_diff = coord_diff[:, :r]
        if coord_diff is None:  # the neighbor list's, of the receivers that move
            coord_diff = nbr_coord_diff(x, nbr_idx, cfg.norm_constant)
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
            self.add_module(f"gcl_{i}", GCL(cfg, edge_features(cfg)))
        self.coord_update = EquivariantUpdate(cfg, coords_range_layer)

    def forward(self, h, x, dist0, edge_mask, node_mask, update_coords_mask,
                nbr_idx=None, update_rows=None):
        cfg = self.cfg
        if nbr_idx is None:
            radial, coord_diff = coord2diff(x, cfg.norm_constant)
        else:
            radial = ((x[:, :, None, :] - gather_rows(x, nbr_idx)) ** 2).sum(-1, keepdim=True)
            coord_diff = None  # the coordinate update's own (EquivariantUpdate)
        if cfg.sin_embedding:
            radial = sinusoids_embedding(radial)
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
        if cfg.sin_embedding:
            dist0 = sinusoids_embedding(dist0)
        dist0 = dist0.to(dt)
        h = linear(h, self.embedding, dt)
        for i in range(cfg.n_layers):
            block = getattr(self, f"e_block_{i}")
            args = (h, x, dist0, edge_mask, node_mask, update_coords_mask, nbr_idx,
                    update_rows)
            if torch.is_grad_enabled():
                h, x = checkpoint(block, *args, use_reentrant=False)
            else:
                h, x = block(*args)
        h = linear(h, self.embedding_out, dt)
        h = h * node_mask[..., None]
        return h.float(), x.float()


class GNN(nn.Module):
    """Plain (non-equivariant) message passing: embedding -> n_layers GCLs
    without edge features over the dense adjacency -> output Dense.

    forward(h [B,N,D_in], edge_mask [B,N,N], node_mask [B,N])
      -> [B, N, out_node_nf] float32.
    """

    def __init__(self, cfg: EGNNConfig, in_node_nf: int, out_node_nf: int):
        super().__init__()
        self.cfg = cfg
        self.embedding = nn.Linear(in_node_nf, cfg.hidden_nf)
        for i in range(cfg.n_layers):
            self.add_module(f"gcl_{i}", GCL(cfg, edge_nf=0))
        self.embedding_out = nn.Linear(cfg.hidden_nf, out_node_nf)

    def forward(self, h, edge_mask, node_mask):
        dt = self.cfg.compute_dtype
        h = linear(h, self.embedding, dt)
        for i in range(self.cfg.n_layers):
            h = getattr(self, f"gcl_{i}")(h, None, edge_mask)
            h = h * node_mask[..., None]
        h = linear(h, self.embedding_out, dt)
        return (h * node_mask[..., None]).float()
