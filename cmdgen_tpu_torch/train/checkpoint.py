"""Checkpoints of a port training run (counterpart of
``cmdgen_tpu/train/checkpoint.py``): ``last`` always, ``best`` where the
monitored value (the validation loss, lower is better) improves.

Each is a directory of numpy arrays in the flax layout (``convert.py``):
``params.npz``, ``opt_state.npz`` (the optimizer's ``count`` and moments),
``ema_params.npz`` where the run keeps an EMA, and ``config.json``; beside
it a sidecar ``{name}.json`` with ``step``, ``epoch``, ``monitor`` and
``config``, as the JAX package writes. ``convert.load_port_checkpoint``
and ``convert.load_port_gcpg`` read such a directory (or the run's, for
its ``best/``), so ``sample-phars`` and ``generate`` take it as it is.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple

import numpy as np


def save_checkpoint(ckpt_dir, payload: Mapping[str, Mapping[str, np.ndarray]], step: int,
                    config: Optional[Dict] = None, monitor_value: Optional[float] = None,
                    keep_best: bool = True, epoch: Optional[int] = None) -> None:
    """Write ``last``; refresh ``best`` where ``monitor_value`` is lower
    than the best one's. ``payload``: {"params": leaves, "opt_state":
    arrays, "ema_params": leaves (optional)}, each a flat {name: array}."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)

    def write(name):
        path = ckpt_dir / name
        if path.exists():
            shutil.rmtree(path)
        path.mkdir()
        for key, arrays in payload.items():
            np.savez(path / f"{key}.npz", **arrays)
        if config is not None:
            (path / "config.json").write_text(json.dumps(config, indent=1))
        meta = {"step": int(step)}
        if epoch is not None:
            meta["epoch"] = int(epoch)  # epochs completed: the resume coordinate
        if monitor_value is not None:
            meta["monitor"] = float(monitor_value)
        if config is not None:
            meta["config"] = config
        (ckpt_dir / f"{name}.json").write_text(json.dumps(meta))

    write("last")
    if keep_best and monitor_value is not None:
        best_meta = ckpt_dir / "best.json"
        prev = (json.loads(best_meta.read_text()).get("monitor", np.inf)
                if best_meta.exists() else np.inf)
        if monitor_value < prev:
            write("best")


def load_checkpoint(ckpt_dir, name: str = "last") -> Tuple[Dict[str, Dict[str, np.ndarray]],
                                                          Dict]:
    """(payload, meta): the arrays of every ``*.npz`` of ``ckpt_dir/name``
    keyed by file stem, and the sidecar's dict."""
    ckpt_dir = Path(ckpt_dir)
    payload = {}
    for path in sorted((ckpt_dir / name).glob("*.npz")):
        with np.load(path) as npz:
            payload[path.stem] = {k: npz[k] for k in npz.files}
    meta_path = ckpt_dir / f"{name}.json"
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    return payload, meta


def eval_params_from_payload(payload: Mapping):
    """The weights to evaluate with, the EMA where the checkpoint has one:
    ``payload["ema_params"]`` if present, else ``payload["params"]`` (the
    entries may be arrays or the files holding them)."""
    return payload.get("ema_params") or payload["params"]
