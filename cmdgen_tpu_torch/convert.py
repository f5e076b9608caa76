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

A port training run (``train/checkpoint.py``) writes the same layout under
``best/`` and ``last/``, with the optimizer's state (``opt_state.npz``:
``count`` and ``mu``/``nu``/``nu_max`` per flax path) and the EMA of the
weights (``ema_params.npz``) beside it; a reader takes the EMA where there
is one, and a run's directory means its ``best/``. ``optax_state`` and
``port_opt_state`` carry an optax AMSGrad or AdamW state across both ways.

The GCPG model maps the same way by name (``gcpg_state_dict``), with
flax's other leaves: a LayerNorm ``scale`` and an Embed ``embedding``
become ``weight``, a PReLU's scalar ``negative_slope`` the weight [1] of
``nn.PReLU(1)``, and other leaves (``pp_seg``, a GINE layer's ``eps``) keep
their name. A GCPG port checkpoint's ``config.json`` holds ``model`` (the
``GCPGModelConfig``) and ``tokenizer`` (the vocabulary list). A decode-only
GCPG checkpoint (``assets/grun_r5cn/``) may keep the training modules apart,
in ``train_params.npz``, which only fine-tuning reads.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from cmdgen_tpu_torch.chem.tokenizer import Tokenizer
from cmdgen_tpu_torch.config import DiffPharConfig, GCPGModelConfig, from_dict, to_dict
from cmdgen_tpu_torch.device import DeviceLike, resolve_device
from cmdgen_tpu_torch.diffusion.cddpm import ConditionalDDPM
from cmdgen_tpu_torch.diffusion.joint import JointDDPM
from cmdgen_tpu_torch.diffusion.size_prior import SizePrior
from cmdgen_tpu_torch.models.dynamics import EGNNDynamics, make_fused_apply
from cmdgen_tpu_torch.models.gcpg import GCPG, TRAINING_MODULES
from cmdgen_tpu_torch.parallel.mesh import full, shard_like
from cmdgen_tpu_torch.train.checkpoint import eval_params_from_payload

GAMMA_NET = "gamma_net/"
Model = Union[ConditionalDDPM, JointDDPM]


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
    load_state(module, dynamics_state_dict(flax_params, scalars))


def load_state(module: torch.nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    """Load a converted state dict into ``module``. Raises on any entry left
    unmapped, any module weight left unfilled, or a shape mismatch."""
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


def flax_path(module: nn.Module, name: str) -> str:
    """The flax path of ``module``'s parameter ``name``: a Linear's (or
    PositiveLinear's) ``weight`` is a ``kernel``, a LayerNorm's a
    ``scale``, an Embedding's an ``embedding``, a PReLU's a
    ``negative_slope``; other leaves keep their name."""
    *mods, leaf = name.split(".")
    if not mods:
        return leaf
    if leaf == "weight":
        owner = module.get_submodule(".".join(mods))
        leaf = ("scale" if isinstance(owner, nn.LayerNorm)
                else "embedding" if isinstance(owner, nn.Embedding)
                else "negative_slope" if isinstance(owner, nn.PReLU) else "kernel")
    return "/".join(mods + [leaf])


def flax_names(model) -> Dict[str, str]:
    """{parameter name: flax path} of a DDPM (its dynamics, and its gamma
    network as ``gamma_net.`` / ``gamma_net/``) or of any module (the
    GCPG), in the order of ``model.named_parameters()``."""
    if isinstance(model, nn.Module):
        roots = [("", "", model)]
    else:
        roots = [("", "", model.dynamics)]
        if model.gamma_net is not None:
            roots.append(("gamma_net.", GAMMA_NET, model.gamma_net))
    return {tp + name: fp + flax_path(root, name)
            for tp, fp, root in roots for name, _ in root.named_parameters()}


def to_flax(path: str, v: torch.Tensor) -> np.ndarray:
    """A port tensor as the flax leaf at ``path`` (kernels transposed, a
    PReLU slope a scalar): a copy, which later updates of ``v`` leave as
    it is."""
    arr = v.detach().float().cpu().numpy().copy()
    if path.endswith("/kernel"):
        return arr.T
    if path.endswith("/negative_slope"):
        return arr.reshape(())
    return arr


def from_flax(path: str, arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`to_flax`, shaped, typed and placed as ``like``."""
    arr = np.asarray(arr)
    if path.endswith("/kernel"):
        arr = arr.T
    return torch.as_tensor(np.array(arr).reshape(like.shape), dtype=like.dtype,
                           device=like.device)


def model_leaves(model, tensors: Optional[Mapping[str, torch.Tensor]] = None
                 ) -> Dict[str, np.ndarray]:
    """The model's weights as flattened flax leaves; or, with ``tensors``
    ({parameter name: tensor of its shape}, e.g. gradients or an EMA),
    those in the same layout. Sharded weights, and tensors that are the
    local parts of sharded weights, are gathered whole (``parallel.mesh``;
    every rank calls it)."""
    params = dict(model.named_parameters())
    src = params if tensors is None else tensors
    return {path: to_flax(path, full(src[name], like=params[name]))
            for name, path in flax_names(model).items()}


def leaves_to_tensors(model, leaves: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flattened flax leaves as {parameter name: tensor} shaped and placed
    as the model's parameters; raises on a leaf missing or left over."""
    names = flax_names(model)
    missing = sorted(set(names.values()) - set(leaves))
    extra = sorted(set(leaves) - set(names.values()))
    if missing or extra:
        raise KeyError(f"parameters left unfilled: {missing}; leaves left unmapped: {extra}")
    params = dict(model.named_parameters())
    return {name: from_flax(path, leaves[path], params[name]) for name, path in names.items()}


def load_leaves(model, leaves: Mapping[str, np.ndarray]) -> None:
    """Copy flattened flax leaves into the model's parameters."""
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, v in leaves_to_tensors(model, leaves).items():
            params[name].copy_(v)


_MOMENTS = ("mu", "nu", "nu_max")


def optimizer_arrays(model, optimizer) -> Dict[str, np.ndarray]:
    """The port optimizer's state (``train.state.AMSGrad`` or ``AdamW``) as
    flat numpy arrays: ``count`` and ``{mu,nu,nu_max}/<flax path>`` in the
    flax layout, the local parts of sharded weights' state gathered whole."""
    out = {"count": np.asarray(optimizer.count, dtype=np.int32)}
    params = dict(model.named_parameters())
    for name, path in flax_names(model).items():
        st = optimizer.state[params[name]]
        for key in _MOMENTS:
            if key in st:
                out[f"{key}/{path}"] = to_flax(path, full(st[key], like=params[name]))
    return out


def load_optimizer_arrays(model, optimizer, arrays: Mapping[str, np.ndarray]) -> None:
    """Set the port optimizer's state from :func:`optimizer_arrays`' form
    (for a sharded weight, its local part)."""
    count = int(np.asarray(arrays["count"]))
    params = dict(model.named_parameters())
    for name, path in flax_names(model).items():
        p = params[name]
        st = optimizer.state[p]
        st["count"] = count
        for key in _MOMENTS:
            if f"{key}/{path}" in arrays:
                st[key] = shard_like(from_flax(path, arrays[f"{key}/{path}"], p), p)
            elif key != "nu_max" or getattr(optimizer, "amsgrad", False):
                raise KeyError(f"optimizer state {key}/{path} is missing")


def port_opt_state(optax_state) -> Dict[str, np.ndarray]:
    """An optax ``reference_optimizer`` (AMSGrad) or ``gcpg_optimizer``
    (AdamW) state, as numpy, in :func:`optimizer_arrays`' form: its first
    element's ``count`` and moments; the chain's other states carry the
    same count or nothing."""
    first = optax_state[0]
    out = {"count": np.asarray(first.count, dtype=np.int32)}
    for key in _MOMENTS:
        if hasattr(first, key):
            out.update({f"{key}/{path}": v
                        for path, v in _flat_tree(getattr(first, key)).items()})
    return out


def optax_state(arrays: Mapping[str, np.ndarray], template):
    """The optax state of the same optimizer as ``template`` (its ``init``
    of the params), filled from :func:`optimizer_arrays`' form: every
    ``count`` field of the chain takes ``count``."""
    def fill(state):
        if isinstance(state, tuple) and hasattr(state, "_fields"):
            vals = {}
            for key in state._fields:
                v = getattr(state, key)
                if key == "count":
                    vals[key] = np.asarray(arrays["count"], dtype=np.int32)
                elif key in _MOMENTS:
                    vals[key] = _unflatten({p[len(key) + 1:]: a for p, a in arrays.items()
                                            if p.startswith(key + "/")}, v)
                else:
                    vals[key] = v
            return type(state)(**vals)
        if isinstance(state, tuple):
            return type(state)(fill(x) for x in state)
        return state

    return fill(template)


def _unflatten(flat: Mapping[str, np.ndarray], like):
    """Flattened leaves into the nesting of the tree ``like`` (with or
    without its top-level ``params`` key)."""
    def build(node, prefix):
        if isinstance(node, Mapping):
            return {k: build(v, f"{prefix}{k}/") for k, v in node.items()}
        return np.asarray(flat[prefix[:-1]], dtype=np.asarray(node).dtype)

    if isinstance(like, Mapping) and set(like) == {"params"}:
        return {"params": build(like["params"], "")}
    return build(like, "")


def write_port_checkpoint(ckpt_dir, cfg: DiffPharConfig, model) -> Path:
    """Write ``model``'s weights (the dynamics and, for the learned
    schedule, the gamma network) and ``cfg`` as a port checkpoint
    directory, which :func:`load_port_checkpoint` reads back."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    np.savez(ckpt_dir / "params.npz", **model_leaves(model))
    (ckpt_dir / "config.json").write_text(json.dumps(to_dict(cfg), indent=1))
    return ckpt_dir


def checkpoint_dir(ckpt_dir) -> Path:
    """A port checkpoint directory, or a training run's ``best/`` where
    ``ckpt_dir`` is the run's directory."""
    ckpt_dir = Path(ckpt_dir)
    if not (ckpt_dir / "params.npz").exists() and (ckpt_dir / "best" / "params.npz").exists():
        return ckpt_dir / "best"
    return ckpt_dir


def read_leaves(ckpt_dir) -> Dict[str, np.ndarray]:
    """The weights to evaluate with of a checkpoint directory, by
    ``train.checkpoint.eval_params_from_payload``'s rule (its EMA where it
    has one); only that file is read."""
    files = {p.stem: p for p in Path(ckpt_dir).glob("*.npz")}
    with np.load(eval_params_from_payload(files)) as npz:
        return {k: npz[k] for k in npz.files}


def read_port_checkpoint(ckpt_dir) -> Tuple[DiffPharConfig, Dict[str, np.ndarray]]:
    """(config, flattened flax params) of a port checkpoint directory (or
    of a training run's ``best/``): the EMA weights where there are some."""
    ckpt_dir = checkpoint_dir(ckpt_dir)
    cfg = from_dict(DiffPharConfig, json.loads((ckpt_dir / "config.json").read_text()))
    return cfg, read_leaves(ckpt_dir)


def build_model(cfg: DiffPharConfig, flax_params: Mapping,
                device: DeviceLike = None, engine: str = "msgpass",
                size_histogram: Optional[np.ndarray] = None) -> Model:
    """The DDPM of ``cfg`` with ``flax_params`` loaded, on ``device``
    (default ``cuda``; raises without CUDA): a ``JointDDPM`` when
    ``cfg.train.mode`` is ``joint`` (its dynamics move the pocket too),
    else a ``ConditionalDDPM``. ``engine``: ``msgpass`` (the module, K1 per
    GCL) or ``fused`` (K2). ``size_histogram`` gives the model a size
    prior."""
    dev = resolve_device(device)
    if engine not in ("msgpass", "fused"):
        raise ValueError(f"unknown engine {engine!r}")
    dyn_params, gamma_params = split_gamma_net(flax_params)
    dynamics = EGNNDynamics(cfg.dynamics)
    load_flax_params(dynamics, dyn_params)
    dynamics = dynamics.to(dev).eval()
    apply_fn = make_fused_apply(dynamics) if engine == "fused" else None
    prior = None if size_histogram is None else SizePrior(size_histogram, dev)
    model = (JointDDPM if cfg.train.mode == "joint" else ConditionalDDPM)(
        cfg.ddpm, dynamics, apply_fn=apply_fn, size_prior=prior)
    if model.gamma_net is not None:
        load_flax_params(model.gamma_net, gamma_params, scalars=("gamma_0", "gamma_1"))
    elif gamma_params:
        raise KeyError(f"gamma_net leaves for the {cfg.ddpm.noise_schedule!r} schedule")
    return model


def load_port_checkpoint(ckpt_dir, device: DeviceLike = None,
                         engine: str = "msgpass"
                         ) -> Tuple[Model, DiffPharConfig]:
    """Read a port checkpoint and build its model on ``device``, with the
    size prior of its ``size_distribution.npy`` where it has one."""
    ckpt_dir = checkpoint_dir(ckpt_dir)
    cfg, flat = read_port_checkpoint(ckpt_dir)
    hist_path = ckpt_dir / "size_distribution.npy"
    hist = np.load(hist_path) if hist_path.exists() else None
    return build_model(cfg, flat, device, engine, size_histogram=hist), cfg


# ------------------------------------------------------------------- GCPG

# the top-level modules the prior decode reads: all a decode-only
# checkpoint holds (TRAINING_MODULES serve the posterior path and training)
DECODE_MODULES = ("cond_embedding", "pp_v_init", "pp_e_init", "pp_encoder", "pp_seg",
                  "expand", "zz_seg", "dencoder", "decoder", "word_embed", "word_pred")
# beside a decode-only checkpoint's params.npz: the leaves of TRAINING_MODULES
TRAIN_PARAMS = "train_params.npz"
_GCPG_LEAVES = {"kernel": "weight", "scale": "weight", "embedding": "weight",
                "negative_slope": "weight"}


def gcpg_state_dict(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """Map a flax GCPG parameter tree (with or without its top-level
    ``params`` key, nested or flattened) onto the port's ``GCPG``
    state_dict names."""
    sd = {}
    for path, arr in _flat_tree(flax_params).items():
        *mods, leaf = path.split("/")
        if leaf == "kernel":
            if arr.ndim != 2:
                raise KeyError(f"unmapped flax leaf {path!r}: kernel of rank {arr.ndim}")
            arr = arr.T
        elif leaf == "negative_slope":
            arr = arr.reshape(1)
        name = ".".join(mods + [_GCPG_LEAVES.get(leaf, leaf)])
        if name in sd:
            raise KeyError(f"unmapped flax leaf {path!r}: {name} is filled already")
        sd[name] = torch.tensor(arr)
    return sd


def build_gcpg(cfg: GCPGModelConfig, flax_params: Mapping, vocab_size: int,
               device: DeviceLike = None) -> GCPG:
    """The GCPG of ``cfg`` with ``flax_params`` loaded, in eval mode, on
    ``device`` (default ``cuda``; raises without CUDA). A tree without the
    training-only modules (``TRAINING_MODULES``) gives a decode-only model.
    Raises on any leaf left unmapped or weight left unfilled."""
    dev = resolve_device(device)
    sd = gcpg_state_dict(flax_params)
    training = any(k.split(".")[0] in TRAINING_MODULES for k in sd)
    model = GCPG(cfg, vocab_size, training_modules=training)
    load_state(model, sd)
    return model.to(dev).eval()


def _training_modules_missing(leaves: Mapping[str, np.ndarray]):
    return sorted(set(TRAINING_MODULES) - {path.split("/")[0] for path in leaves})


def read_port_gcpg(ckpt_dir, with_training: bool = False
                   ) -> Tuple[GCPGModelConfig, Tokenizer, Dict[str, np.ndarray]]:
    """(model config, tokenizer, flattened flax params) of a GCPG port
    checkpoint directory (or of a training run's ``best/``).

    ``with_training``: the leaves must hold the training modules
    (``TRAINING_MODULES``) too, as fine-tuning needs. A decode-only
    checkpoint takes them from the ``train_params.npz`` beside its
    ``params.npz``; without that file it raises, naming the modules."""
    ckpt_dir = checkpoint_dir(ckpt_dir)
    meta = json.loads((ckpt_dir / "config.json").read_text())
    leaves = read_leaves(ckpt_dir)
    if with_training and _training_modules_missing(leaves):
        extra = ckpt_dir / TRAIN_PARAMS
        if extra.exists():
            with np.load(extra) as npz:
                leaves.update({k: npz[k] for k in npz.files})
        missing = _training_modules_missing(leaves)
        if missing:
            raise KeyError(f"{ckpt_dir} holds the prior decode's modules only: the training "
                           f"modules {missing} are missing, and {extra}, which would supply "
                           f"them, is {'incomplete' if extra.exists() else 'not there'}")
    return (from_dict(GCPGModelConfig, meta["model"]), Tokenizer.from_list(meta["tokenizer"]),
            leaves)


def load_port_gcpg(ckpt_dir, device: DeviceLike = None) -> Tuple[GCPG, Tokenizer]:
    """Read a GCPG port checkpoint (``params.npz`` + ``config.json``) and
    build its model on ``device``: (model, tokenizer)."""
    cfg, tokenizer, flat = read_port_gcpg(ckpt_dir)
    return build_gcpg(cfg, flat, len(tokenizer), device), tokenizer
