"""Weights carried across from the JAX package.

A flax parameter tree (nested dicts of numpy arrays, or the same flattened
to ``/``-joined paths) maps onto the port's modules by name: a Dense
``kernel [in, out]`` at ``a/b/kernel`` becomes ``a.b.weight [out, in]``,
a ``bias`` stays a bias. The first pair layer's ``w_i``/``w_j``/``w_e``
split stays three Linears, and ``node_in`` stays one matrix.

The learned noise schedule's ``gamma_net`` subtree (``l1``/``l2``/``l3``
Dense-like layers and the ``gamma_0``/``gamma_1`` scalars), which the JAX
package keeps beside the dynamics modules, maps onto the model's
``GammaNetwork`` the same way.

A port checkpoint is a directory with ``params.npz`` (the flattened tree),
``config.json`` (the JAX checkpoint's ``config``) and optionally
``size_distribution.npy`` (the size prior's histogram).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from cmdgen_tpu_torch.config import DiffPharConfig, from_dict
from cmdgen_tpu_torch.device import DeviceLike, resolve_device
from cmdgen_tpu_torch.diffusion.cddpm import ConditionalDDPM
from cmdgen_tpu_torch.diffusion.size_prior import SizePrior
from cmdgen_tpu_torch.models.dynamics import EGNNDynamics, make_fused_apply

GAMMA_NET = "gamma_net/"


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


def _flat_tree(flax_params: Mapping) -> Dict[str, np.ndarray]:
    """Flattened tree without its top-level ``params`` key."""
    flat = flatten_params(flax_params)
    if all(k.startswith("params/") for k in flat):
        flat = {k[len("params/"):]: v for k, v in flat.items()}
    return flat


def split_gamma_net(flax_params: Mapping):
    """(dynamics leaves, gamma_net leaves without their prefix), flattened."""
    flat = _flat_tree(flax_params)
    gamma = {k[len(GAMMA_NET):]: v for k, v in flat.items() if k.startswith(GAMMA_NET)}
    return {k: v for k, v in flat.items() if not k.startswith(GAMMA_NET)}, gamma


def dynamics_state_dict(flax_params: Mapping,
                        scalars: Tuple[str, ...] = ()) -> Dict[str, torch.Tensor]:
    """Map a flax parameter tree onto the port's state_dict names. Accepts
    the tree with or without its top-level ``params`` key, nested or
    flattened. Leaves named in ``scalars`` (top-level parameters such as
    the gamma network's ``gamma_0``) keep their name. Raises KeyError on a
    leaf it cannot map."""
    flat = _flat_tree(flax_params)
    sd = {}
    for path, arr in flat.items():
        *mods, leaf = path.split("/")
        if not mods:
            if leaf not in scalars:
                raise KeyError(f"unmapped flax leaf {path!r}")
            sd[leaf] = torch.tensor(arr)
        elif leaf == "kernel":
            if arr.ndim != 2:
                raise KeyError(f"unmapped flax leaf {path!r}: kernel of rank {arr.ndim}")
            sd[".".join(mods) + ".weight"] = torch.tensor(arr.T)
        elif leaf == "bias":
            sd[".".join(mods) + ".bias"] = torch.tensor(arr)
        else:
            raise KeyError(f"unmapped flax leaf {path!r}")
    return sd


def load_flax_params(module: torch.nn.Module, flax_params: Mapping,
                     scalars: Tuple[str, ...] = ()) -> None:
    """Fill ``module`` (the dynamics, or the gamma network with its
    ``scalars``) from a flax tree. Raises on any flax leaf left unmapped,
    any module weight left unfilled, or a shape mismatch."""
    sd = dynamics_state_dict(flax_params, scalars)
    want = module.state_dict()
    missing = sorted(set(want) - set(sd))
    extra = sorted(set(sd) - set(want))
    if missing or extra:
        raise KeyError(f"weights left unfilled: {missing}; flax leaves "
                       f"left unmapped: {extra}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(f"{k}: flax shape {tuple(v.shape)} != "
                             f"module shape {tuple(want[k].shape)}")
    module.load_state_dict(sd, strict=True)


def read_port_checkpoint(ckpt_dir) -> Tuple[DiffPharConfig, Dict[str, np.ndarray]]:
    """(config, flattened flax params) of a port checkpoint directory."""
    ckpt_dir = Path(ckpt_dir)
    cfg = from_dict(DiffPharConfig, json.loads((ckpt_dir / "config.json").read_text()))
    with np.load(ckpt_dir / "params.npz") as npz:
        flat = {k: npz[k] for k in npz.files}
    return cfg, flat


def build_model(cfg: DiffPharConfig, flax_params: Mapping,
                device: DeviceLike = None, engine: str = "msgpass",
                size_histogram: Optional[np.ndarray] = None) -> ConditionalDDPM:
    """The conditional DDPM of ``cfg`` with ``flax_params`` loaded, on
    ``device`` (default ``cuda``; raises without CUDA). ``engine``:
    ``msgpass`` (the module, K1 per GCL) or ``fused`` (K2).
    ``size_histogram`` gives the model a size prior."""
    dev = resolve_device(device)
    if cfg.train.mode == "joint":
        raise NotImplementedError("the joint model is not ported yet")
    if engine not in ("msgpass", "fused"):
        raise ValueError(f"unknown engine {engine!r}")
    dyn_params, gamma_params = split_gamma_net(flax_params)
    dynamics = EGNNDynamics(cfg.dynamics)
    load_flax_params(dynamics, dyn_params)
    dynamics = dynamics.to(dev).eval()
    apply_fn = make_fused_apply(dynamics) if engine == "fused" else None
    prior = None if size_histogram is None else SizePrior(size_histogram, dev)
    model = ConditionalDDPM(cfg.ddpm, dynamics, apply_fn=apply_fn, size_prior=prior)
    if model.gamma_net is not None:
        load_flax_params(model.gamma_net, gamma_params, scalars=("gamma_0", "gamma_1"))
    elif gamma_params:
        raise KeyError(f"gamma_net leaves for the {cfg.ddpm.noise_schedule!r} schedule")
    return model


def load_port_checkpoint(ckpt_dir, device: DeviceLike = None,
                         engine: str = "msgpass"
                         ) -> Tuple[ConditionalDDPM, DiffPharConfig]:
    """Read a port checkpoint and build its model on ``device``, with the
    size prior of its ``size_distribution.npy`` where it has one."""
    cfg, flat = read_port_checkpoint(ckpt_dir)
    hist_path = Path(ckpt_dir) / "size_distribution.npy"
    hist = np.load(hist_path) if hist_path.exists() else None
    return build_model(cfg, flat, device, engine, size_histogram=hist), cfg
