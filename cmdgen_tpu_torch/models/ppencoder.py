"""Pharmacophore-graph encoder: edge-featured graph attention, dense form
(counterpart of ``cmdgen_tpu/models/ppencoder.py``).

A batch of pharmacophore graphs is a dense ``[B, 8, D]`` node tensor with
``[B, 8, 8, D]`` edge features and a node mask. ``PPEncoder`` stacks
``n_layers`` layers of one ``variant`` ('egat', the active encoder, or the
alternates 'ggcn', 'gine', 'graphtransformer'), each followed by a node
LayerNorm, then (for 'egat') one extra attention layer and a residual to
the input. Module names are the flax ones, LayerNorms use flax's epsilon.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cmdgen_tpu_torch.models.transformer import NEG_INF, layer_norm


def _edge_mask(node_mask):
    return node_mask[:, :, None] * node_mask[:, None, :]


class EGATLayer(nn.Module):
    """One edge-featured graph attention layer (DGL EGATConv semantics).

    f_ij = LeakyReLU(A [h_i ‖ e_ij ‖ h_j])    (per head)
    a_ij = softmax_j(att · f_ij)
    h'_i = mean_heads( Σ_j a_ij · (W h_j) )
    e'_ij = mean_heads(f_ij)
    """

    def __init__(self, dim: int, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        # the head width: dim / heads where the heads divide dim, else dim
        self.hd = hd = dim // num_heads if dim % num_heads == 0 else dim
        wide = num_heads * hd
        self.f_i = nn.Linear(dim, wide, bias=False)
        self.f_j = nn.Linear(dim, wide)
        self.f_e = nn.Linear(dim, wide, bias=False)
        self.att = nn.Linear(hd, 1, bias=False)
        self.w_v = nn.Linear(dim, wide)
        self.proj = nn.Linear(hd, dim)
        self.eproj = nn.Linear(hd, dim)

    def forward(self, h, e, node_mask):
        b, n, _ = h.shape
        f = (self.f_i(h)[:, :, None, :] + self.f_j(h)[:, None, :, :]
             + self.f_e(e)).reshape(b, n, n, self.num_heads, self.hd)
        f = F.leaky_relu(f, negative_slope=0.2)
        logits = self.att(f)[..., 0]  # [B, N, N, heads]
        emask = _edge_mask(node_mask)[..., None]
        logits = torch.where(emask > 0, logits, NEG_INF)
        # rows with no valid neighbour become all-zero
        alpha = torch.softmax(logits, dim=2) * emask
        v = self.w_v(h).reshape(b, n, self.num_heads, self.hd)
        h_out = torch.einsum("bijh,bjhd->bihd", alpha, v).mean(dim=2)
        return self.proj(h_out), self.eproj(f.mean(dim=3))


class GatedGCNLayer(nn.Module):
    """Dense GatedGCN (benchmarking-gnns style), the reference's unused
    alternate encoder block."""

    def __init__(self, dim: int):
        super().__init__()
        for name in ("A", "B", "C", "V", "U"):
            self.add_module(name, nn.Linear(dim, dim))
        self.LayerNorm_0 = layer_norm(dim)
        self.LayerNorm_1 = layer_norm(dim)

    def forward(self, h, e, node_mask):
        emask = _edge_mask(node_mask)
        # edge gate e'_ij = A e_ij + B h_i + C h_j
        e_new = self.A(e) + self.B(h)[:, :, None, :] + self.C(h)[:, None, :, :]
        eta = torch.sigmoid(e_new) * emask[..., None]
        denom = eta.sum(dim=2) + 1e-6
        msg = torch.einsum("bijd,bjd->bid", eta, self.V(h))
        h_new = self.U(h) + msg / denom
        h = h + torch.relu(self.LayerNorm_0(h_new))
        e = e + torch.relu(self.LayerNorm_1(e_new))
        return h * node_mask[..., None], e * emask[..., None]


class GINELayer(nn.Module):
    """Dense GINE conv, the reference's unused alternate encoder block."""

    def __init__(self, dim: int):
        super().__init__()
        self.eps = nn.Parameter(torch.zeros(()))
        self.Dense_0 = nn.Linear(dim, dim)
        self.Dense_1 = nn.Linear(dim, dim)

    def forward(self, h, e, node_mask):
        emask = _edge_mask(node_mask)
        msg = torch.relu(h[:, None, :, :] + e) * emask[..., None]
        out = (1.0 + self.eps) * h + msg.sum(dim=2)
        out = self.Dense_1(torch.relu(self.Dense_0(out)))
        return out * node_mask[..., None]


class GraphTransformerLayer(nn.Module):
    """Dense graph transformer with edge-modulated attention, the
    reference's unused alternate encoder block."""

    def __init__(self, dim: int, num_heads: int = 8):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        for name in ("q", "k", "v", "o"):
            self.add_module(name, nn.Linear(dim, dim))
        self.edge_bias = nn.Linear(dim, num_heads)
        # flax names the outer Dense of Dense(dim)(relu(Dense(2 dim)(h))) first
        self.Dense_0 = nn.Linear(2 * dim, dim)
        self.Dense_1 = nn.Linear(dim, 2 * dim)
        self.LayerNorm_0 = layer_norm(dim)
        self.LayerNorm_1 = layer_norm(dim)

    def forward(self, h, e, node_mask):
        hd = self.dim // self.num_heads
        b, n, _ = h.shape
        q = self.q(h).reshape(b, n, self.num_heads, hd)
        k = self.k(h).reshape(b, n, self.num_heads, hd)
        v = self.v(h).reshape(b, n, self.num_heads, hd)
        logits = torch.einsum("bihd,bjhd->bijh", q, k) / (hd ** 0.5) + self.edge_bias(e)
        emask = _edge_mask(node_mask)[..., None]
        logits = torch.where(emask > 0, logits, NEG_INF)
        att = torch.softmax(logits, dim=2) * emask
        out = torch.einsum("bijh,bjhd->bihd", att, v).reshape(b, n, self.dim)
        h = self.LayerNorm_0(h + self.o(out))
        h = self.LayerNorm_1(h + self.Dense_0(torch.relu(self.Dense_1(h))))
        return h * node_mask[..., None]


VARIANTS = ("egat", "ggcn", "gine", "graphtransformer")


class PPEncoder(nn.Module):
    """EGATEncoderBlock equivalent: n_layers layers with node LayerNorm, one
    extra final attention layer ('egat' only), residual to the input."""

    def __init__(self, dim: int, n_layers: int = 4, num_heads: int = 8,
                 variant: str = "egat"):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(variant)
        self.n_layers, self.variant = n_layers, variant
        make, self._prefix = {
            "egat": (lambda: EGATLayer(dim, num_heads), "egat"),
            "ggcn": (lambda: GatedGCNLayer(dim), "ggcn"),
            "gine": (lambda: GINELayer(dim), "gine"),
            "graphtransformer": (lambda: GraphTransformerLayer(dim, num_heads), "gt"),
        }[variant]
        for i in range(n_layers):
            self.add_module(f"{self._prefix}_{i}", make())
            self.add_module(f"ln_{i}", layer_norm(dim))
        if variant == "egat":
            self.egat_final = EGATLayer(dim, num_heads)

    def forward(self, h, e, node_mask):
        init = h
        for i in range(self.n_layers):
            out = getattr(self, f"{self._prefix}_{i}")(h, e, node_mask)
            # egat and ggcn also update the edge features
            h, e = out if isinstance(out, tuple) else (out, e)
            h = getattr(self, f"ln_{i}")(h)
        if self.variant == "egat":
            h, _ = self.egat_final(h, e, node_mask)
        h = h + init
        return h * node_mask[..., None]
