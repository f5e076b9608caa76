"""Pocket-conditioned pharmacophore sampling, inference stage 1
(counterpart of ``cmdgen_tpu/pipeline/sample_phars.py``).

Parse a pocket from PDB (explicit residue list, or residues within 8 Å of a
reference ligand), tile it across the batch, sample pharmacophore clouds
with the conditional DDPM, shift them back into the pocket's frame, and
emit the ``{Molecule_i: {family: [[x, y, z], ...]}}`` dict the consensus
stage reads. A joint model samples by RePaint inpainting with the pocket
held fixed (lightning_modules.py:466-486).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from cmdgen_tpu_torch.chem import pdb as pdbmod
from cmdgen_tpu_torch.chem.constants import PHAR_DECODER
from cmdgen_tpu_torch.containers import PointCloud, mask_from_sizes
from cmdgen_tpu_torch.diffusion.cddpm import ConditionalDDPM
from cmdgen_tpu_torch.diffusion.joint import JointDDPM
from cmdgen_tpu_torch.ops.masked import masked_mean
from cmdgen_tpu_torch.utils.profiling import span


def pocket_point_cloud(pdb_file, dataset: str, representation: str,
                       ref_ligand: Optional[str] = None,
                       resi_list: Optional[Sequence[str]] = None,
                       cutoff: float = 8.0):
    """Parse + featurize a pocket -> (coords [N,3], one_hot [N,F])."""
    residues = pdbmod.parse_pdb(pdb_file)
    if resi_list:
        pocket = pdbmod.pocket_by_ids(residues, resi_list)
    elif ref_ligand:
        lig = pdbmod.ligand_atoms(residues, ref_ligand)
        lig_coords = np.stack([a.coord for a in lig])
        pocket = pdbmod.pocket_from_ligand(residues, lig_coords, cutoff)
    else:
        raise ValueError("need ref_ligand or resi_list")
    if not pocket:
        raise ValueError("empty pocket")
    return pdbmod.featurize_pocket(pocket, representation, dataset)


def sample_pharmacophores(
    model: Union[ConditionalDDPM, JointDDPM],
    pocket_coords: np.ndarray,
    pocket_onehot: np.ndarray,
    n_samples: int,
    num_nodes: Optional[np.ndarray] = None,
    n_phar_max: int = 16,
    batch_size: int = 64,
    timesteps: Optional[int] = None,
    pocket_pad_bucket: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]] = None,
) -> Dict[str, Dict[str, List[List[float]]]]:
    """Sample n_samples pharmacophore clouds for one pocket on the model's
    device; returns the JSON-ready dict.

    ``pocket_pad_bucket`` pads the pocket node axis up to a multiple of this
    granularity (mask-exact). Unless ``num_nodes`` gives them, node counts
    come from the model's size prior, p(n | pocket size), drawn from
    ``generator``, or are 5 without a prior; either is clipped to
    [1, n_phar_max]. ``noise``: one draw set per batch, instead of
    ``generator``: the (init, chain, final) triple of
    ``sample_given_pocket``, or for a joint model the ``noise`` of
    ``JointDDPM.inpaint``, which runs with ``resamplings=1`` and
    ``jump_length=1`` from a zero pharmacophore cloud.
    """
    dev = model.device
    nq, nf = pocket_onehot.shape
    nq_real = nq
    if pocket_pad_bucket:
        nq = -(-nq // pocket_pad_bucket) * pocket_pad_bucket
        pad = nq - nq_real
        if pad:
            pocket_coords = np.concatenate(
                [pocket_coords, np.zeros((pad, 3), pocket_coords.dtype)])
            pocket_onehot = np.concatenate(
                [pocket_onehot, np.zeros((pad, nf), pocket_onehot.dtype)])
    mask_row = torch.from_numpy((np.arange(nq) < nq_real).astype(np.float32)).to(dev)
    coords_t = torch.as_tensor(pocket_coords, dtype=torch.float32, device=dev)
    onehot_t = torch.as_tensor(pocket_onehot, dtype=torch.float32, device=dev)
    pocket_com_before = pocket_coords[:nq_real].mean(axis=0)

    out: Dict[str, Dict[str, List[List[float]]]] = {}
    done = 0
    batch_i = 0
    while done < n_samples:
        with span("sampler.batch", request=True):
            b = min(batch_size, n_samples - done)
            pocket = PointCloud(x=coords_t.expand(b, nq, 3), h=onehot_t.expand(b, nq, nf),
                                mask=mask_row.expand(b, nq))
            if num_nodes is None:
                if model.size_prior is None:
                    nn_ = torch.full((b,), 5, device=dev)
                else:
                    nn_ = model.size_prior.sample_conditional_n1(
                        torch.full((b,), nq_real, device=dev), generator)
                nn_ = nn_.clamp(1, n_phar_max)
            else:
                nn_ = torch.as_tensor(np.asarray(num_nodes[done:done + b]), device=dev)
            draws = None if noise is None else noise[batch_i]
            if isinstance(model, JointDDPM):
                phar_mask = mask_from_sizes(nn_, n_phar_max)
                phar_init = PointCloud(x=torch.zeros(b, n_phar_max, 3, device=dev),
                                       h=torch.zeros(b, n_phar_max, model.phar_nf, device=dev),
                                       mask=phar_mask)
                phar, pocket_out = model.inpaint(
                    phar_init, pocket, torch.zeros_like(phar_mask), torch.ones_like(pocket.mask),
                    resamplings=1, jump_length=1, timesteps=timesteps, generator=generator,
                    noise=draws)
            else:
                phar, pocket_out = model.sample_given_pocket(
                    pocket, nn_, n_phar_max, timesteps=timesteps, generator=generator,
                    noise=draws)
            # translate back into the original pocket frame
            pocket_com_after = masked_mean(pocket_out.x, pocket_out.mask).cpu().numpy()
            shift = pocket_com_before[None, :] - pocket_com_after
            x = phar.x.cpu().numpy() + shift[:, None, :]
            h = phar.h.cpu().numpy()
            mask = phar.mask.cpu().numpy()
            for i in range(b):
                mol: Dict[str, List[List[float]]] = {}
                for j in range(x.shape[1]):
                    if mask[i, j] < 0.5:
                        continue
                    fam = PHAR_DECODER[int(np.argmax(h[i, j]))]
                    mol.setdefault(fam, []).append([round(float(v), 4) for v in x[i, j]])
                out[f"Molecule_{done + i}"] = mol
        done += b
        batch_i += 1
    return out


def sample_phars_to_json(model: Union[ConditionalDDPM, JointDDPM], pdb_file, out_json,
                         dataset: str = "crossdock_full",
                         representation: str = "full-atom",
                         ref_ligand: Optional[str] = None,
                         resi_list: Optional[Sequence[str]] = None,
                         n_samples: int = 100, **kwargs):
    """End-to-end stage-1 body: PDB in, point-cloud JSON out."""
    coords, onehot = pocket_point_cloud(pdb_file, dataset, representation,
                                        ref_ligand, resi_list)
    result = sample_pharmacophores(model, coords, onehot, n_samples, **kwargs)
    Path(out_json).write_text(json.dumps(result))
    return result
