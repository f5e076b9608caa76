"""DiffPhar configuration dataclasses (counterpart of the DiffPhar half of
``cmdgen_tpu/config.py``). Field names and defaults are the JAX package's,
so a checkpoint's ``config`` dict loads with :func:`from_dict`; the
``compute_dtype`` string maps to a torch dtype."""
from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict, Optional

import torch

from cmdgen_tpu_torch.diffusion.cddpm import DDPMConfig
from cmdgen_tpu_torch.models.dynamics import DynamicsConfig
from cmdgen_tpu_torch.models.egnn import EGNNConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset: str = "crossdock_full"      # 'crossdock_full' | 'crossdock'
    datadir: str = "data/processed"
    pocket_representation: str = "full-atom"  # 'full-atom' | 'CA'
    n_phar_max: int = 16
    n_pocket_max: int = 512


@dataclasses.dataclass(frozen=True)
class DiffPharTrainConfig:
    run_name: str = "crossdocked_full_cond"
    mode: str = "pocket_conditioning"  # 'joint' | 'pocket_conditioning' | 'simple'
    batch_size: int = 8
    lr: float = 1e-4
    n_epochs: int = 100
    clip_grad: bool = False
    eval_epochs: int = 25
    val_epochs: int = 1
    n_eval_samples: int = 100
    seed: int = 0
    dp: Optional[int] = None
    tp: int = 1
    fsdp: bool = False
    steps_per_call: int = 1
    ckpt_epochs: int = 1
    ema_decay: float = 0.0
    resident_data: str = "auto"


@dataclasses.dataclass(frozen=True)
class DiffPharConfig:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    dynamics: DynamicsConfig = dataclasses.field(default_factory=DynamicsConfig)
    ddpm: DDPMConfig = dataclasses.field(default_factory=DDPMConfig)
    train: DiffPharTrainConfig = dataclasses.field(default_factory=DiffPharTrainConfig)


def full_atom_config() -> DiffPharConfig:
    """crossdocked_full_cond.yml equivalents (full-atom pocket, 11 classes)."""
    return DiffPharConfig(
        data=DataConfig(dataset="crossdock_full", pocket_representation="full-atom"),
        dynamics=DynamicsConfig(
            phar_nf=8, residue_nf=11, joint_nf=32, edge_cutoff=6.0,
            update_pocket_coords=False,
            egnn=EGNNConfig(
                hidden_nf=256, n_layers=3, inv_sublayers=1, attention=True,
                tanh=True, norm_constant=1.0, normalization_factor=100.0,
                aggregation_method="sum",
            ),
        ),
        ddpm=DDPMConfig(timesteps=100, noise_schedule="polynomial_2",
                        noise_precision=1e-5, loss_type="l2", norm_x=1.0,
                        norm_h=4.0),
        train=DiffPharTrainConfig(run_name="crossdocked_full_cond", batch_size=8,
                                  lr=1e-4, n_epochs=100, clip_grad=False),
    )


def ca_config() -> DiffPharConfig:
    """crossdocked_ca_cond.yml equivalents (CA pocket, 20 AA classes)."""
    base = full_atom_config()
    return dataclasses.replace(
        base,
        data=DataConfig(dataset="crossdock", pocket_representation="CA",
                        n_pocket_max=256),
        dynamics=dataclasses.replace(
            base.dynamics, residue_nf=20,
            egnn=dataclasses.replace(base.dynamics.egnn, n_layers=5),
        ),
        ddpm=dataclasses.replace(base.ddpm, timesteps=500),
        train=dataclasses.replace(base.train, run_name="crossdocked_ca_cond",
                                  batch_size=4, n_epochs=1000, clip_grad=True),
    )


def from_dict(cls, d: Dict[str, Any]):
    """Build dataclass ``cls`` from a nested dict; keys the port has no
    field for are ignored, a ``compute_dtype`` name maps to a torch dtype."""
    if not dataclasses.is_dataclass(cls):
        return d
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        ftype = hints.get(f.name, f.type)
        if isinstance(ftype, type) and dataclasses.is_dataclass(ftype):
            kwargs[f.name] = from_dict(ftype, v)
        elif f.name == "compute_dtype":
            kwargs[f.name] = DTYPES[v] if isinstance(v, str) else v
        elif isinstance(v, list):
            kwargs[f.name] = tuple(v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)
