"""Metrics logging (counterpart of ``cmdgen_tpu/utils/logging.py``): one JSON
object per line in ``{run_name}.metrics.jsonl``, echoed to stderr; and a
PNG render of one point cloud."""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, logdir, run_name: str = "run", also_print: bool = True):
        self.dir = Path(logdir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / f"{run_name}.metrics.jsonl"
        self.also_print = also_print
        self._fh = open(self.path, "a")
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict, split: Optional[str] = None):
        rec = {"step": int(step), "t": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            key = f"{k}/{split}" if split else k
            try:
                rec[key] = float(v)
            except (TypeError, ValueError):
                rec[key] = v
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self.also_print:
            print(json.dumps(rec), file=sys.stderr)

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def visualize_molecule_png(out_path, coords, types=None, type_names=None, title: str = ""):
    """A 3-D scatter of one point cloud ([N, 3] coordinates, optional [N]
    class indices coloured per class and named by ``type_names``) written
    to ``out_path`` as a PNG."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    coords = np.asarray(coords)
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")
    if types is not None:
        types = np.asarray(types)
        for t in np.unique(types):
            sel = types == t
            ax.scatter(*coords[sel].T, label=type_names[int(t)] if type_names else str(t), s=60)
        ax.legend(loc="upper right", fontsize=8)
    else:
        ax.scatter(*coords.T, s=60)
    ax.set_title(title)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
