"""Two-node-type denoiser around the EGNN (counterpart of
``cmdgen_tpu/models/dynamics.py``).

Pharmacophore and pocket nodes are encoded by per-type MLPs, concatenated,
conditioned on the diffusion time, run through the EGNN over a 6 Å cutoff
adjacency (self-edges included) and decoded per type. Velocity = coordinate
displacement.

``EGNNDynamics`` is the module (the JAX package's flax path, with the K1
kernel on the neighbor-list engine); ``make_fused_apply`` is the
counterpart of ``make_pallas_apply``: the same function with the EGNN
stack in the K2 kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from cmdgen_tpu_torch.models.egnn import EGNN, EGNNConfig, linear
from cmdgen_tpu_torch.ops.egnn_fused import egnn_forward_fused, fused_params
from cmdgen_tpu_torch.ops.masked import pair_mask, remove_mean


@dataclasses.dataclass(frozen=True)
class DynamicsConfig:
    phar_nf: int = 8
    residue_nf: int = 20
    joint_nf: int = 32
    n_dims: int = 3
    condition_time: bool = True
    update_pocket_coords: bool = False  # False => conditional model
    edge_cutoff: Optional[float] = 6.0  # Å; None => complete graph
    # 'egnn_dynamics' | 'gnn_dynamics' (the plain-GNN mode is not ported yet)
    mode: str = "egnn_dynamics"
    egnn: EGNNConfig = dataclasses.field(default_factory=EGNNConfig)


class TypeMLP(nn.Module):
    """Per-type 2-layer encoder/decoder."""

    def __init__(self, in_nf: int, mid: int, out: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_nf, mid)
        self.Dense_1 = nn.Linear(mid, out)

    def forward(self, h, dtype):
        return linear(F.silu(linear(h, self.Dense_0, dtype)), self.Dense_1, dtype)

    def forward_f32(self, h):
        """float32 throughout, as make_pallas_apply's _type_mlp."""
        h = F.silu(F.linear(h.float(), self.Dense_0.weight.float(), self.Dense_0.bias.float()))
        return F.linear(h, self.Dense_1.weight.float(), self.Dense_1.bias.float())


class EGNNDynamics(nn.Module):
    """eps-prediction network over (pharmacophore, pocket) padded clouds.

    forward(xh_phar [B,Np,3+Fp], xh_pocket [B,Nq,3+Fq], t [B,1],
            mask_phar [B,Np], mask_pocket [B,Nq])
      -> (eps_phar [B,Np,3+Fp], eps_pocket [B,Nq,3+Fq])
    """

    def __init__(self, cfg: DynamicsConfig):
        super().__init__()
        if cfg.mode != "egnn_dynamics":
            raise NotImplementedError(f"dynamics mode {cfg.mode!r} is not ported yet")
        self.cfg = cfg
        self.phar_encoder = TypeMLP(cfg.phar_nf, 2 * cfg.phar_nf, cfg.joint_nf)
        self.residue_encoder = TypeMLP(cfg.residue_nf, 2 * cfg.residue_nf, cfg.joint_nf)
        in_nf = cfg.joint_nf + int(cfg.condition_time)
        self.egnn = EGNN(cfg.egnn, in_nf, cfg.joint_nf + 1)
        self.phar_decoder = TypeMLP(cfg.joint_nf, 2 * cfg.phar_nf, cfg.phar_nf)
        self.residue_decoder = TypeMLP(cfg.joint_nf, 2 * cfg.residue_nf, cfg.residue_nf)

    def _inputs(self, xh_phar, xh_pocket, t, mask_phar, mask_pocket, encode):
        """Encoded joint cloud: (h, x, mask, edge_mask, update_coords_mask)."""
        cfg = self.cfg
        nd = cfg.n_dims
        h_phar = encode(self.phar_encoder, xh_phar[..., nd:])
        h_pocket = encode(self.residue_encoder, xh_pocket[..., nd:])
        x = torch.cat([xh_phar[..., :nd], xh_pocket[..., :nd]], dim=-2)
        h = torch.cat([h_phar, h_pocket], dim=-2)
        mask = torch.cat([mask_phar, mask_pocket], dim=-1)
        if cfg.condition_time:
            h_time = t[:, None, :].expand(*h.shape[:-1], 1)
            h = torch.cat([h, h_time.to(h.dtype)], dim=-1)
        # adjacency: valid x valid pairs within the cutoff, self-edges kept
        edge_mask = pair_mask(mask, mask)
        if cfg.edge_cutoff is not None:
            d2 = ((x[..., :, None, :] - x[..., None, :, :]) ** 2).sum(-1)
            edge_mask = edge_mask * (d2 <= cfg.edge_cutoff ** 2).to(edge_mask.dtype)
        update_coords_mask = None
        if not cfg.update_pocket_coords:
            update_coords_mask = torch.cat(
                [mask_phar, torch.zeros_like(mask_pocket)], dim=-1)
        return h, x, mask, edge_mask, update_coords_mask

    def _outputs(self, h_final, x_final, x, mask, mask_phar, mask_pocket,
                 decode):
        cfg = self.cfg
        n_phar = mask_phar.shape[-1]
        vel = (x_final - x) * mask[..., None]
        if cfg.condition_time:
            h_final = h_final[..., :-1]
        h_out_phar = decode(self.phar_decoder, h_final[:, :n_phar]).float()
        h_out_pocket = decode(self.residue_decoder, h_final[:, n_phar:]).float()
        # NaN guard: zero velocities if anything blew up
        vel = torch.where(torch.isnan(vel), torch.zeros_like(vel), vel)
        if cfg.update_pocket_coords:
            vel = remove_mean(vel, mask)  # joint model: CoM-free outputs
        eps_phar = torch.cat([vel[:, :n_phar], h_out_phar], dim=-1)
        eps_pocket = torch.cat([vel[:, n_phar:], h_out_pocket], dim=-1)
        return eps_phar * mask_phar[..., None], eps_pocket * mask_pocket[..., None]

    def forward(self, xh_phar, xh_pocket, t, mask_phar, mask_pocket):
        dt = self.cfg.egnn.compute_dtype

        def typed(mlp, v):
            return mlp(v, dt)

        h, x, mask, edge_mask, ucm = self._inputs(
            xh_phar, xh_pocket, t, mask_phar, mask_pocket, typed)
        update_rows = None if self.cfg.update_pocket_coords else xh_phar.shape[-2]
        h_final, x_final = self.egnn(h, x, edge_mask, mask, ucm, update_rows)
        return self._outputs(h_final, x_final, x, mask, mask_phar,
                             mask_pocket, typed)


def make_fused_apply(dynamics: EGNNDynamics) -> Callable:
    """The dynamics forward with the EGNN stack in one K2 launch
    (``ops.egnn_fused``); counterpart of the JAX package's
    ``make_pallas_apply``. The type MLPs and embeddings run in float32, as
    there. Weights are stacked once, here. Inference only."""
    cfg = dynamics.cfg
    ecfg = cfg.egnn
    if ecfg.inv_sublayers != 1:
        raise ValueError("the fused engine supports inv_sublayers=1")
    if ecfg.neighbor_k is None:
        raise ValueError("the fused engine needs neighbor_k")
    if ecfg.aggregation_method != "sum" or not ecfg.attention:
        raise ValueError("the fused engine needs sum aggregation and attention")
    with torch.no_grad():
        params = fused_params(dynamics.egnn, ecfg.compute_dtype)

    def f32(mlp, v):
        return mlp.forward_f32(v)

    def apply_fn(xh_phar, xh_pocket, t, mask_phar, mask_pocket):
        h, x, mask, edge_mask, ucm = dynamics._inputs(
            xh_phar, xh_pocket, t, mask_phar, mask_pocket, f32)
        h_final, x_final = egnn_forward_fused(
            params, h, x, edge_mask, mask, ucm,
            n_layers=ecfg.n_layers, neighbor_k=ecfg.neighbor_k,
            norm_constant=ecfg.norm_constant, coords_range=ecfg.coords_range,
            normalization_factor=ecfg.normalization_factor, tanh=ecfg.tanh,
            update_rows=None if cfg.update_pocket_coords else xh_phar.shape[-2],
            compute_dtype=ecfg.compute_dtype,
        )
        return dynamics._outputs(h_final, x_final, x, mask, mask_phar,
                                 mask_pocket, f32)

    return apply_fn
