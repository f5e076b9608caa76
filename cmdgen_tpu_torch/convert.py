"""Weights carried across from the JAX package.

A flax parameter tree (nested dicts of numpy arrays, or the same flattened
to ``/``-joined paths) maps onto the port's modules by name: a Dense
``kernel [in, out]`` at ``a/b/kernel`` becomes ``a.b.weight [out, in]``,
a ``bias`` stays a bias. The first pair layer's ``w_i``/``w_j``/``w_e``
split stays three Linears, and ``node_in`` stays one matrix.

A port checkpoint is a directory with ``params.npz`` (the flattened tree)
and ``config.json`` (the JAX checkpoint's ``config``).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from cmdgen_tpu_torch.config import DiffPharConfig, from_dict
from cmdgen_tpu_torch.device import DeviceLike, resolve_device
from cmdgen_tpu_torch.diffusion.cddpm import ConditionalDDPM
from cmdgen_tpu_torch.models.dynamics import EGNNDynamics, make_fused_apply


def flatten_params(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> {"a/b/kernel": array}."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten_params(v, path + "/"))
        else:
            out[path] = np.asarray(v)
    return out


def dynamics_state_dict(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """Map a flax EGNNDynamics parameter tree onto the port's state_dict
    names. Accepts the tree with or without its top-level ``params`` key,
    nested or flattened. Raises KeyError on a leaf it cannot map."""
    flat = flatten_params(flax_params)
    if all(k.startswith("params/") for k in flat):
        flat = {k[len("params/"):]: v for k, v in flat.items()}
    sd = {}
    for path, arr in flat.items():
        *mods, leaf = path.split("/")
        if not mods:
            raise KeyError(f"unmapped flax leaf {path!r}")
        if leaf == "kernel":
            if arr.ndim != 2:
                raise KeyError(f"unmapped flax leaf {path!r}: kernel of rank {arr.ndim}")
            sd[".".join(mods) + ".weight"] = torch.tensor(arr.T)
        elif leaf == "bias":
            sd[".".join(mods) + ".bias"] = torch.tensor(arr)
        else:
            raise KeyError(f"unmapped flax leaf {path!r}")
    return sd


def load_flax_params(dynamics: EGNNDynamics, flax_params: Mapping) -> None:
    """Fill ``dynamics`` from a flax tree. Raises on any flax leaf left
    unmapped, any module weight left unfilled, or a shape mismatch."""
    sd = dynamics_state_dict(flax_params)
    want = dynamics.state_dict()
    missing = sorted(set(want) - set(sd))
    extra = sorted(set(sd) - set(want))
    if missing or extra:
        raise KeyError(f"weights left unfilled: {missing}; flax leaves "
                       f"left unmapped: {extra}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(f"{k}: flax shape {tuple(v.shape)} != "
                             f"module shape {tuple(want[k].shape)}")
    dynamics.load_state_dict(sd, strict=True)


def read_port_checkpoint(ckpt_dir) -> Tuple[DiffPharConfig, Dict[str, np.ndarray]]:
    """(config, flattened flax params) of a port checkpoint directory."""
    ckpt_dir = Path(ckpt_dir)
    cfg = from_dict(DiffPharConfig, json.loads((ckpt_dir / "config.json").read_text()))
    with np.load(ckpt_dir / "params.npz") as npz:
        flat = {k: npz[k] for k in npz.files}
    return cfg, flat


def build_model(cfg: DiffPharConfig, flax_params: Mapping,
                device: DeviceLike = None, engine: str = "msgpass"
                ) -> ConditionalDDPM:
    """The conditional DDPM of ``cfg`` with ``flax_params`` loaded, on
    ``device`` (default ``cuda``; raises without CUDA). ``engine``:
    ``msgpass`` (the module, K1 per GCL) or ``fused`` (K2)."""
    dev = resolve_device(device)
    if cfg.train.mode == "joint":
        raise NotImplementedError("the joint model is not ported yet")
    if engine not in ("msgpass", "fused"):
        raise ValueError(f"unknown engine {engine!r}")
    dynamics = EGNNDynamics(cfg.dynamics)
    load_flax_params(dynamics, flax_params)
    dynamics = dynamics.to(dev).eval()
    apply_fn = make_fused_apply(dynamics) if engine == "fused" else None
    return ConditionalDDPM(cfg.ddpm, dynamics, apply_fn=apply_fn)


def load_port_checkpoint(ckpt_dir, device: DeviceLike = None,
                         engine: str = "msgpass"
                         ) -> Tuple[ConditionalDDPM, DiffPharConfig]:
    """Read a port checkpoint and build its model on ``device``."""
    cfg, flat = read_port_checkpoint(ckpt_dir)
    return build_model(cfg, flat, device, engine), cfg
