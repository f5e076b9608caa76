#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

  python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout on a machine with the GPUs the cell asks for.
It builds the cell's model and inputs from the seed, warms up, measures
for S seconds (``--trace 0``: the cell's end-to-end metrics; ``--trace
1``: its per-layer metrics, from the window's first chain, profiled),
runs a chain of the window drawn from the seed again and compares it with
the timed one and, step by step, with the plain reference, prints the
numbers compared on standard error and, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device`` (and ``breakdown`` when traced), then ``checks``.
It exits non-zero, printing no result, without CUDA or enough GPUs, and
when JAX or the JAX package is loaded once the window has closed.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the program's and PyTorch's kernel caches: fixed directories inside the
# checkout, so that only a cell's first run in a checkout builds
CACHE = ROOT / ".cache" / "perfbench"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def pin_dispatch():
    """Pin the calling thread, the one that dispatches the device's work, to
    the last core the process may use, so that the scheduler does not move
    it between cores during the window. The threads that exist already (the
    CUDA driver's, PyTorch's) keep the cores they had."""
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {cores[-1]})
    log(f"dispatching thread pinned to core {cores[-1]} of {len(cores)}")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    # one process with few threads: the host dispatch is one thread, and
    # idle worker threads only contend for the host's cores
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench.harness import spec

    cell = spec.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        import cmdgen_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"the program under test is missing from the checkout: {e}")
        return 3
    from perfbench.harness import cell as cellmod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    out = cellmod.run(cell, args.seed, args.seconds, bool(args.trace), T0, device, log,
                      pin=pin_dispatch)
    loaded = cellmod.forbidden_modules()
    if loaded:
        log(f"modules that a run of the port may not load were loaded: {loaded}")
        return 4
    cellmod.print_result(out, log)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 - the run fails with its traceback, no result
        traceback.print_exc()
        sys.exit(1)
