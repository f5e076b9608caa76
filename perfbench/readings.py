#!/usr/bin/env python3
"""The readings that a cell's comparison limits are set from.

  python3 perfbench/readings.py --workload NAME --seeds S1 S2 ...

For each seed, at the cell's own size: one chain of the program through the
window's path (``sample_pharmacophores``), run again and checked as a run
checks it, step by step against the float32 reference (the lower
reading); the control, the reference with its products in TF32 put in
the program's place (the upper reading); and beside it the program's own
bfloat16 path (``compute_dtype``). Prints one JSON line a seed: the worst
value of each number compared. The benchmark's runs never run this.
"""
import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def worst(per_cloud):
    return {k: float(v.max()) for k, v in per_cloud.items()}


def program_chain(cell, seed, device, log):
    """Chain 0 of the program through the window's path, then run again and
    checked as a run checks it: (session, per-cloud numbers, the tap)."""
    from perfbench.harness import cell as cellmod, check

    session = cellmod.Session(cell, seed, device, log)
    session.warm_up()
    session.call(0)
    tap, checked = session.rerun(0, check.recorded_calls(session.steps, session.timesteps))
    outputs = session.release()
    per_cloud = check.chain_gaps(cell, seed, 0, tap, checked, outputs[0], session.steps,
                                 session.weights, session.pocket_x, session.pocket_h, device)
    return session, per_cloud, tap


def as_program(ref_states, ref_final, T):
    """The reference's outputs in the form ``check.program_states`` gives
    the program's: (states, eps)."""
    states = {"start": ref_states["start"],
              **{s: v[0] for s, v in ref_states.items() if s != "start"}}
    eps = {**{s: v[1] for s, v in ref_states.items() if s != "start"},
           T: (ref_final["eps"], ref_final.get("eps_pocket"))}
    return states, eps


def readings(cell, seed, device, log, bf16=True):
    """One seed's readings: {"program", "tf32_reference", "bf16_program"
    (with ``bf16``)}, each the worst value of every number compared."""
    import copy

    import torch

    from perfbench.harness import check, inputs

    t0 = time.perf_counter()
    session, per_cloud, tap = program_chain(cell, seed, device, log)
    T = cell.config["ddpm"]["timesteps"]
    b = cell.traffic["batch"]
    noise = session.noise(0)
    nodes = torch.from_numpy(inputs.node_counts(cell.traffic, seed, 0))
    args = (cell, session.weights, session.pocket_x, session.pocket_h, noise, nodes,
            tap.records, session.steps)
    out = {"seed": seed, "steps": len(session.steps), "clouds": b,
           "program": worst(per_cloud)}
    ref_states, ref_final = check.reference_outputs(*args)
    tf_states, tf_final = check.reference_outputs(*args, tf32=True)
    types = torch.nn.functional.one_hot(tf_final["type_logits"].argmax(-1),
                                        tf_final["type_logits"].shape[-1])
    out["tf32_reference"] = worst(check.gaps(
        *as_program(tf_states, tf_final, T),
        (tf_final["x"], types, tf_final["mask"], tf_final["pocket_x"]),
        ref_states, ref_final, nodes, cell.config))
    if not bf16:
        out["seconds"] = time.perf_counter() - t0
        return out
    config = copy.deepcopy(cell.config)
    config["dynamics"]["egnn"]["compute_dtype"] = "bfloat16"
    low = dataclasses.replace(cell, config=config)
    _, low_cloud, _ = program_chain(low, seed, device, log)
    out["bf16_program"] = worst(low_cloud)
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--bf16-seeds", type=int, default=None,
                   help="read the bfloat16 path on the first N seeds only (default: all)")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench.harness import spec

    cell = spec.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("readings need a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n_bf16 = len(args.seeds) if args.bf16_seeds is None else args.bf16_seeds
    for i, seed in enumerate(args.seeds):
        out = readings(cell, seed, torch.device("cuda", 0),
                       lambda *a: print(*a, file=sys.stderr, flush=True), bf16=i < n_bf16)
        print(json.dumps({"workload": args.workload, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
