"""DiffPhar training at given layouts, with plain data in and out: the runs
that hold a step on a mesh to the single-process step.

``run_jobs`` takes a list of jobs (dicts) and runs them in order on every
rank of the default process group; rank 0 returns their results, the
other ranks ``None``. A ``steps`` job takes a few train steps from given
flax-layout weights on given global batches and draws, at ``layout``
(``None`` for the plain single-process step, else ``{"dp", "tp",
"fsdp"}``); a ``train`` job runs ``train_diffphar``. A job whose run raises
ValueError (a batch that does not divide by dp, a mesh that does not fill
the world) returns ``{"ValueError": message}``. The multi-process tests
spawn it (``parallel.launch.spawn``); ``chip_smoke.py`` calls it on the
card at world one.
"""
from __future__ import annotations

import time
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from cmdgen_tpu_torch import convert
from cmdgen_tpu_torch.config import DiffPharConfig, from_dict
from cmdgen_tpu_torch.containers import PointCloud
from cmdgen_tpu_torch.device import DeviceLike, resolve_device
from cmdgen_tpu_torch.parallel import mesh as pmesh
from cmdgen_tpu_torch.train import diffphar_train
from cmdgen_tpu_torch.train import state as tstate


def _device(device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dist.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def clouds(arrays: Sequence[np.ndarray], device) -> tuple:
    """(phar, pocket) PointClouds from (px, ph, pm, qx, qh, qm) arrays."""
    t = [torch.as_tensor(np.asarray(a)).to(device) for a in arrays]
    return PointCloud(*t[:3]), PointCloud(*t[3:])


def placements(p: torch.Tensor) -> Dict[str, str]:
    """{mesh axis: placement} of a sharded weight; {} for a plain one."""
    if not isinstance(p, DTensor):
        return {}
    return dict(zip(p.device_mesh.mesh_dim_names, map(str, p.placements)))


def steps(cfg: Mapping, leaves: Mapping[str, np.ndarray], batches: Sequence[Sequence],
          draws: Sequence[Sequence], layout: Optional[Mapping] = None, ema_decay: float = 0.0,
          lr: float = 1e-3, device: DeviceLike = None) -> Dict:
    """Train steps, with the adaptive clip, from ``leaves`` (flat flax
    paths) on each global batch with its draws (the arguments of
    ``loss_given_noise`` after the clouds), on ``device`` (default
    ``cuda``). Returns the weights (after each step, and at the end), the
    EMA (with ``ema_decay``), the optimizer state, the grad-norm queue,
    each step's loss, norm and wall ms (to its loss on the host), all as
    numpy, and each weight's placements by flax path."""
    dev = _device(device)
    model = convert.build_model(from_dict(DiffPharConfig, dict(cfg)), leaves, dev)
    plan = None
    if layout is not None:
        mesh = pmesh.make_mesh(layout.get("dp"), layout.get("tp", 1), dev.type)
        plan = diffphar_train.shard_model(model, mesh, layout.get("fsdp", False))
    optimizer = tstate.reference_optimizer(model.parameters(), lr)
    state = tstate.init_state(model, optimizer, ema=ema_decay > 0, plan=plan)
    step = tstate.make_diffusion_train_step(True, ema_decay)
    losses, norms, history, step_ms = [], [], [], []
    for arrays, noise in zip(batches, draws):
        args = clouds(arrays, dev)
        noise = [torch.as_tensor(np.array(d)).to(dev) for d in noise]
        t0 = time.perf_counter()
        met = step(state, *args, noise=noise)
        losses.append(float(met["loss"]))  # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        norms.append(float(met["grad_norm"]))
        history.append(convert.model_leaves(model))
    params = dict(model.named_parameters())
    out = {"params": history[-1], "history": history, "losses": losses, "grad_norms": norms,
           "step_ms": step_ms,
           "queue": state.grad_norms.cpu().numpy(),
           "opt_state": convert.optimizer_arrays(model, optimizer),
           "placements": {path: placements(params[name])
                          for name, path in convert.flax_names(model).items()}}
    if state.ema is not None:
        out["ema"] = convert.model_leaves(model, state.ema)
    return out


def train(cfg: Mapping, datadir: str, out_dir: str, resume_from: Optional[str] = None,
          max_steps: Optional[int] = None, device: DeviceLike = None) -> Dict:
    """``train_diffphar`` on ``datadir`` (on ``device``, default ``cuda``);
    returns the steps taken."""
    state = diffphar_train.train_diffphar(from_dict(DiffPharConfig, dict(cfg)), datadir,
                                          out_dir, max_steps=max_steps,
                                          resume_from=resume_from, device=device)
    return {"step": state.step}


_KINDS = {"steps": steps, "train": train}


def run_jobs(jobs: List[Mapping]) -> Optional[List[Dict]]:
    """Each job's ``kind`` (``steps`` or ``train``) called with its other
    keys, in order, on every rank; rank 0's results (``None`` elsewhere)."""
    results = []
    for job in jobs:
        kw = {k: v for k, v in job.items() if k != "kind"}
        try:
            results.append(_KINDS[job["kind"]](**kw))
        except ValueError as e:
            results.append({"ValueError": str(e)})
    return results if not dist.is_initialized() or dist.get_rank() == 0 else None
