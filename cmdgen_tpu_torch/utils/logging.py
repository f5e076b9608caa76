"""Metrics logging (counterpart of ``cmdgen_tpu/utils/logging.py``): one JSON
object per line in ``{run_name}.metrics.jsonl``, echoed to stderr."""
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
