"""Pharmacophore-conditioned SMILES generation, inference stage 3
(counterpart of ``cmdgen_tpu/pipeline/generate_smiles.py``).

Load a ``.posp``/``.edgep`` hypothesis, tile it across the batch, sweep the
property-condition grid, run the batched KV-cached decode on the model's
device, and write the (optionally canonicalized and deduplicated) SMILES
list. Random draws (the prior z and the sampling noise) come from the
caller's ``torch.Generator``.
"""
from __future__ import annotations

import itertools
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from cmdgen_tpu_torch.chem.mol import canonical_smiles
from cmdgen_tpu_torch.chem.posp import load_phar_file
from cmdgen_tpu_torch.chem.tokenizer import Tokenizer, syntax_tables
from cmdgen_tpu_torch.models.gcpg import GCPG, generate

# default condition grid (the reference's generate.py:93-99);
# generate_docked.py uses Score=-14 instead of 0
DEFAULT_CONDITIONS = {
    "MW": [400.0],
    "logP": [4.0],
    "QED": [0.6],
    "SAS": [4.0],
    "RotaNumBonds": [4.0],
    "Score": [0.0],
    "Smi": [0.0],
}
CONDITION_ORDER = ["MW", "logP", "QED", "SAS", "RotaNumBonds", "Score", "Smi"]


def condition_grid(overrides: Optional[Dict[str, Sequence[float]]] = None) -> np.ndarray:
    """Cartesian sweep over per-condition value lists -> [G, 7] array."""
    spec = dict(DEFAULT_CONDITIONS)
    if overrides:
        spec.update({k: list(v) for k, v in overrides.items()})
    values = [spec[k] for k in CONDITION_ORDER]
    return np.asarray(list(itertools.product(*values)), dtype=np.float32)


def generate_from_phar(
    model: GCPG,
    tokenizer: Tokenizer,
    phar_file,
    n_per_condition: int = 128,
    conditions: Optional[Dict[str, Sequence[float]]] = None,
    random_sample: bool = True,
    filter_valid: bool = True,
    batch_size: int = 128,
    temperature: float = 1.0,
    constrain: bool = False,
    constrain_valence: bool = False,
    generator: Optional[torch.Generator] = None,
) -> List[str]:
    """Generated SMILES strings (canonical and deduplicated if filtered).

    ``constrain`` enables syntax-constrained decoding (``models.gcpg.
    generate``); ``constrain_valence`` also masks valence-overflow
    continuations (and implies the tables). ``generator`` lives on the
    model's device."""
    dev = model.pos.device
    pp_h, pp_e, pp_mask = (torch.from_numpy(np.asarray(a, np.float32)).to(dev)
                           for a in load_phar_file(phar_file))
    tables = (torch.from_numpy(syntax_tables(tokenizer)).to(dev)
              if constrain or constrain_valence else None)
    out: List[str] = []
    for cond in condition_grid(conditions):
        cond = torch.from_numpy(cond).to(dev)
        remaining = n_per_condition
        while remaining > 0:
            b = min(batch_size, remaining)
            toks = generate(
                model,
                pp_h.expand(b, *pp_h.shape),
                pp_e.expand(b, *pp_e.shape),
                pp_mask.expand(b, *pp_mask.shape),
                cond.expand(b, cond.shape[0]),
                random_sample=random_sample,
                temperature=temperature,
                constraints=tables,
                valence=constrain_valence,
                generator=generator,
            )
            out.extend(tokenizer.get_text(toks.cpu().numpy()))
            remaining -= b
    if filter_valid:
        canon = [canonical_smiles(s) for s in out]
        out = list(dict.fromkeys(c for c in canon if c))
    return out


def generate_to_file(model, tokenizer, phar_file, out_dir, **kwargs) -> Path:
    """CLI body: writes ``{stem}_result.txt``, one SMILES per line."""
    phar_file = Path(phar_file)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    smiles = generate_from_phar(model, tokenizer, phar_file, **kwargs)
    out_path = out_dir / f"{phar_file.stem}_result.txt"
    out_path.write_text("\n".join(smiles) + ("\n" if smiles else ""))
    return out_path
