"""The EGNN denoiser of DiffPhar in plain PyTorch, float32.

``denoise(w, cfg, xh_phar, xh_pocket, t, mask_phar, mask_pocket, neighbor_k)``
returns the pharmacophore rows' eps prediction [B, Np, 3 + phar_nf] of the
conditional model (the pocket is context and does not move);
``denoise_joint`` with the same arguments returns both clouds' eps of the
joint model, in which every row moves. ``w`` maps flax paths to tensors
(kernels [in, out]); ``cfg`` is the ``dynamics`` group of a configuration
file.

Edges: valid pairs within ``edge_cutoff`` (self-edges kept); with
``neighbor_k`` the K nearest of them for each receiver, else every pair
(the dense rule). Both rules are discontinuous, at the cutoff and at the
K-th neighbour.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]


def dense(w: Weights, path: str, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
    out = x @ w[f"{path}/kernel"]
    return out + w[f"{path}/bias"] if bias else out


def type_mlp(w: Weights, path: str, h: torch.Tensor) -> torch.Tensor:
    return dense(w, f"{path}/Dense_1", F.silu(dense(w, f"{path}/Dense_0", h)))


def gather(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """v [B, N, D], idx [B, R, K] -> [B, R, K, D]."""
    b = torch.arange(v.shape[0], device=v.device)[:, None, None]
    return v[b, idx]


def edges(x: torch.Tensor, mask: torch.Tensor, cutoff: Optional[float],
          neighbor_k: Optional[int]):
    """(d2 [B, N, J], edge mask [B, N, J], idx [B, N, J] or None): J = N
    for the dense rule, else K, the K nearest valid edges of each row."""
    d2 = ((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1)
    emask = mask[:, :, None] * mask[:, None, :]
    if cutoff is not None:
        emask = emask * (d2 <= cutoff ** 2).float()
    if neighbor_k is None:
        return d2, emask, None
    k = min(neighbor_k, x.shape[1])
    score = torch.where(emask > 0, -d2, torch.full_like(d2, float("-inf")))
    idx = torch.topk(score, k, dim=-1).indices
    return torch.gather(d2, -1, idx), torch.gather(emask, -1, idx), idx


def sources(v: torch.Tensor, idx: Optional[torch.Tensor], rows: Optional[int] = None):
    """The source side of each edge: [B, R, J, D] (dense: v broadcast)."""
    if idx is None:
        return v[:, None, :, :]
    return gather(v, idx if rows is None else idx[:, :rows])


def egnn(w: Weights, ecfg: dict, h: torch.Tensor, x: torch.Tensor, node_mask: torch.Tensor,
         move_mask: torch.Tensor, cutoff: Optional[float], neighbor_k: Optional[int]):
    """The EGNN stack: (h_out [B, N, D_out], x_out [B, N, 3]); the first
    ``move_mask.shape[1]`` rows move where ``move_mask`` is 1."""
    norm = ecfg["normalization_factor"]
    r = move_mask.shape[1]
    dist0, emask, idx = edges(x, node_mask, cutoff, neighbor_k)
    h = dense(w, "egnn/embedding", h)
    for layer in range(ecfg["n_layers"]):
        p = f"egnn/e_block_{layer}"
        diff = x[:, :, None, :] - sources(x, idx)
        radial = (diff ** 2).sum(-1)
        coord_diff = diff / (torch.sqrt(radial + 1e-8) + ecfg["norm_constant"])[..., None]
        # GCL: messages of every edge, attention-gated sum over sources
        g = f"{p}/gcl_0"
        we = w[f"{g}/edge_in/w_e/kernel"]
        pre = (dense(w, f"{g}/edge_in/w_i", h, bias=False)[:, :, None, :]
               + sources(dense(w, f"{g}/edge_in/w_j", h), idx)
               + radial[..., None] * we[0] + dist0[..., None] * we[1])
        m = F.silu(dense(w, f"{g}/edge_out", F.silu(pre)))
        m = m * torch.sigmoid(dense(w, f"{g}/att", m))
        agg = (m * emask[..., None]).sum(2) / norm
        upd = F.silu(dense(w, f"{g}/node_in", torch.cat([h, agg], dim=-1)))
        h = (h + dense(w, f"{g}/node_out", upd)) * node_mask[..., None]
        # coordinate update of the moving rows
        c = f"{p}/coord_update"
        cwe = w[f"{c}/coord_in/w_e/kernel"]
        pre = (dense(w, f"{c}/coord_in/w_i", h[:, :r], bias=False)[:, :, None, :]
               + sources(dense(w, f"{c}/coord_in/w_j", h), idx, r)
               + radial[:, :r, :, None] * cwe[0] + dist0[:, :r, :, None] * cwe[1])
        o = F.silu(dense(w, f"{c}/coord_mid", F.silu(pre)))
        gate = dense(w, f"{c}/coord_gate", o, bias=False)
        if ecfg["tanh"]:
            gate = torch.tanh(gate) * ecfg["coords_range"]
        trans = coord_diff[:, :r] * gate * emask[:, :r, :, None]
        moved = x[:, :r] + trans.sum(2) / norm * move_mask[..., None]
        x = torch.cat([moved, x[:, r:]], dim=1) * node_mask[..., None]
    h = dense(w, "egnn/embedding_out", h) * node_mask[..., None]
    return h, x


def network(w: Weights, cfg: dict, xh_phar: torch.Tensor, xh_pocket: torch.Tensor,
            t: torch.Tensor, mask_phar: torch.Tensor, mask_pocket: torch.Tensor,
            neighbor_k: Optional[int], joint: bool):
    """The encoders and the EGNN stack over both clouds: (h_out, velocity
    [B, N, 3], mask [B, N]); the pharmacophore rows move, and with
    ``joint`` the pocket's too."""
    ecfg = cfg["egnn"]
    if (cfg["mode"] != "egnn_dynamics" or cfg["update_pocket_coords"] != joint
            or ecfg["inv_sublayers"] != 1 or ecfg["sin_embedding"]
            or not ecfg["attention"] or ecfg["aggregation_method"] != "sum"
            or not cfg["condition_time"]):
        raise ValueError("the reference covers the EGNN dynamics with one attention GCL a "
                         "block, sum aggregation, raw edge features and time conditioning, "
                         "the pocket moving in the joint model alone")
    nd = cfg["n_dims"]
    h = torch.cat([type_mlp(w, "phar_encoder", xh_phar[..., nd:]),
                   type_mlp(w, "residue_encoder", xh_pocket[..., nd:])], dim=1)
    x = torch.cat([xh_phar[..., :nd], xh_pocket[..., :nd]], dim=1)
    mask = torch.cat([mask_phar, mask_pocket], dim=1)
    h = torch.cat([h, t[:, None, :].expand(*h.shape[:2], 1)], dim=-1)
    h_out, x_out = egnn(w, ecfg, h, x, mask, mask if joint else mask_phar,
                        cfg["edge_cutoff"], neighbor_k)
    vel = (x_out - x) * mask[..., None]
    return h_out, torch.where(torch.isnan(vel), torch.zeros_like(vel), vel), mask


def denoise(w: Weights, cfg: dict, xh_phar: torch.Tensor, xh_pocket: torch.Tensor,
            t: torch.Tensor, mask_phar: torch.Tensor, mask_pocket: torch.Tensor,
            neighbor_k: Optional[int]) -> torch.Tensor:
    """eps prediction of the pharmacophore rows [B, Np, 3 + phar_nf]."""
    npr = xh_phar.shape[1]
    h_out, vel, _ = network(w, cfg, xh_phar, xh_pocket, t, mask_phar, mask_pocket,
                            neighbor_k, joint=False)
    h_phar = type_mlp(w, "phar_decoder", h_out[:, :npr, :-1])
    return torch.cat([vel[:, :npr], h_phar], dim=-1) * mask_phar[..., None]


def denoise_joint(w: Weights, cfg: dict, xh_phar: torch.Tensor, xh_pocket: torch.Tensor,
                  t: torch.Tensor, mask_phar: torch.Tensor, mask_pocket: torch.Tensor,
                  neighbor_k: Optional[int]):
    """eps prediction of the joint model, (pharmacophore [B, Np, 3 +
    phar_nf], pocket [B, Nq, 3 + residue_nf]): every row moves, the
    velocity is made free of the combined cloud's centre of mass, and the
    pocket's types come from the residue decoder."""
    npr = xh_phar.shape[1]
    h_out, vel, mask = network(w, cfg, xh_phar, xh_pocket, t, mask_phar, mask_pocket,
                               neighbor_k, joint=True)
    mean = (vel * mask[..., None]).sum(1) / mask.sum(1, keepdim=True).clamp_min(1.0)
    vel = (vel - mean[:, None, :]) * mask[..., None]
    h_phar = type_mlp(w, "phar_decoder", h_out[:, :npr, :-1])
    h_pocket = type_mlp(w, "residue_decoder", h_out[:, npr:, :-1])
    return (torch.cat([vel[:, :npr], h_phar], dim=-1) * mask_phar[..., None],
            torch.cat([vel[:, npr:], h_pocket], dim=-1) * mask_pocket[..., None])
