"""Configuration dataclasses of DiffPhar and of the GCPG model
(counterparts of ``cmdgen_tpu/config.py``). Field names and defaults are
the JAX package's, so a checkpoint's ``config`` dict loads with
:func:`from_dict` and :func:`to_dict` writes one; the ``compute_dtype``
string maps to a torch dtype."""
from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict, Optional, Tuple

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
    # steps_per_call and resident_data: the JAX package's TPU dispatch
    # settings, read from its configs; the port's trainer feeds every step
    # from the host, one batch plan whatever they say
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


@dataclasses.dataclass(frozen=True)
class GCPGModelConfig:
    """Mirrors MODEL_DEFAULT_SETTINGS (GCPG/train_chembl33_baseline.py:50-65)."""

    max_len: int = 128
    pp_v_dim: int = 8          # 7 type bits + 1 size scalar
    pp_e_dim: int = 1          # bond-path distance
    pp_encoder_n_layer: int = 4
    hidden_dim: int = 384
    n_layers: int = 8
    ff_dim: int = 1024
    n_head: int = 8
    cond_dim: int = 7          # [MW, logP, QED, SAS, RotaNumBonds, Score, Smi]
    non_vae: bool = False
    remove_pp_dis: bool = False
    n_pp_max: int = 8          # MAX_NUM_PP_GRAPHS
    dropout: float = 0.1
    # Replicate the reference's condition-token masking bug (gcpg.py:208-210
    # marks the cond token as padding in every attention mask, so properties
    # never influence generation). Off in production, but switchable so the
    # full forward can be compared against the reference's actual numerics.
    mask_cond_token: bool = False


@dataclasses.dataclass(frozen=True)
class GCPGTrainConfig:
    """The JAX package's GCPG training settings (train_chembl33_baseline.py)."""

    batch_size: int = 128
    n_epochs: int = 32
    lr: float = 3e-4
    grad_clip: float = 5.0
    kl_beta_min: float = 3e-4
    kl_beta_max: float = 1e-2
    cosine_t_max: int = 4  # epochs of the cosine decay, then lr 0
    # condition gate over the 7 scalars: the baseline trains on the first 5;
    # the docking finetune is score-only (train/gcpg_train.py FINETUNE_GATE)
    condition_gate: Tuple[int, ...] = (1, 1, 1, 1, 1, 0, 0)
    save_freq: int = 4  # checkpoint every N epochs
    seed: int = 42
    # 'auto' | 'on' | 'off': an epoch as a plan of rows drawn from
    # resident_variants pre-drawn augmentations per molecule, on the device
    resident_data: str = "auto"
    resident_variants: int = 8
    # fraction of training pp-graphs re-drawn consensus-style
    consensus_noise: float = 0.0


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


def to_dict(obj) -> Dict[str, Any]:
    """A config dataclass as the nested dict :func:`from_dict` reads (a
    torch dtype as its name, tuples as lists)."""
    def plain(v):
        if dataclasses.is_dataclass(v):
            return {f.name: plain(getattr(v, f.name)) for f in dataclasses.fields(v)}
        if isinstance(v, torch.dtype):
            return next(k for k, d in DTYPES.items() if d == v)
        if isinstance(v, (tuple, list)):
            return [plain(x) for x in v]
        return v

    return plain(obj)
