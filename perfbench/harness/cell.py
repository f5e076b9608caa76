"""One run of one cell: set-up, the measured window, the traced chain, the
comparison with the reference, and the result line.

The window drives ``pipeline.sample_phars.sample_pharmacophores``, the
entry of ``sample-phars``, one batch of clouds at a time on the cell's
pocket in a closed loop, on the model that ``convert.build_model``
builds, until the chain running when ``seconds`` are up has ended. A thin
wrapper keeps what ``sample_given_pocket`` returned (the clouds before the
entry rounds them); nothing else of the program is touched. After the
window one chain drawn from the seed runs again with a tap on its
denoiser (``check``), the reference follows it step by step, and the run
is ``correct`` when every number compared is within its limit. A traced
run profiles the window's first chain and counts its work on a second
run of it.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench.harness import check, inputs, spec, trace, work
from perfbench.harness.pockets import make_pocket

# top-level module names that may not be loaded in a run of the port
FORBIDDEN = ("jax", "jaxlib", "flax", "cmdgen_tpu")


@dataclasses.dataclass
class Run:
    """What a run measured: the readers in ``perfbench/metrics`` take it."""

    cell: spec.Cell
    setup_s: float = 0.0
    window_s: float = 0.0
    clouds: int = 0
    window_peak_bytes: int = 0
    peak_bytes: int = 0
    trace: Optional[trace.ChainTrace] = None
    graphs: List[work.Graph] = dataclasses.field(default_factory=list)

    @property
    def dtype(self) -> str:
        return self.cell.config["dynamics"]["egnn"]["compute_dtype"]

    @property
    def neighbor_k(self) -> Optional[int]:
        return self.cell.traffic.get("neighbor_k")

    @property
    def events(self) -> Optional[trace.Events]:
        """The traced chain's events, or None in a run without one."""
        return None if self.trace is None else self.trace.events


class Recorder:
    """Keeps each (phar, pocket_out) that the model's
    ``sample_given_pocket`` returns."""

    def __init__(self, model):
        self.outputs: list = []
        self._sample = model.sample_given_pocket
        model.sample_given_pocket = self

    def __call__(self, *args, **kwargs):
        out = self._sample(*args, **kwargs)
        self.outputs.append(out)
        return out


def model_config(cell: spec.Cell):
    """The program's configuration object: the file's, with the cell's
    neighbour count set as ``--neighbor-k`` sets it."""
    from cmdgen_tpu_torch.config import DiffPharConfig, from_dict

    cfg = from_dict(DiffPharConfig, cell.config)
    k = cell.traffic.get("neighbor_k")
    if k:
        egnn = dataclasses.replace(cfg.dynamics.egnn, neighbor_k=k)
        cfg = dataclasses.replace(cfg, dynamics=dataclasses.replace(cfg.dynamics, egnn=egnn))
    return cfg


def check_cutoff_exact(cell: spec.Cell, pocket_x: np.ndarray) -> int:
    """The largest in-cutoff neighbour count a pocket atom can reach (its
    pocket neighbours and every pharmacophore slot); for a traffic that
    asks for a cutoff-exact K it has to be within K. Returns it."""
    cutoff = cell.config["dynamics"]["edge_cutoff"]
    x = torch.from_numpy(pocket_x)
    degree = int(((torch.cdist(x, x) <= cutoff).sum(-1)).max())
    reach = degree + cell.traffic["n_phar_max"]
    k = cell.traffic.get("neighbor_k")
    if cell.traffic.get("cutoff_exact") and k and reach > k:
        raise ValueError(f"pocket atoms reach {reach} in-cutoff neighbours (pocket "
                         f"{degree} + {cell.traffic['n_phar_max']} slots), past K={k}")
    return degree


class Session:
    """A cell's system under test on one seed: the model that
    ``convert.build_model`` builds from the seed's weights, the pocket, and
    ``call(chain)``, one batch of clouds through ``sample_pharmacophores``
    with that chain's node counts and noise. ``recorder.outputs`` holds
    what each call's ``sample_given_pocket`` returned."""

    def __init__(self, cell: spec.Cell, seed: int, device: torch.device, log=print):
        from cmdgen_tpu_torch.convert import build_model

        traffic = cell.traffic
        self.cell, self.seed, self.device = cell, seed, device
        cfg = model_config(cell)
        self.timesteps = cfg.ddpm.timesteps
        self.shape = (traffic["batch"], traffic["n_phar_max"],
                      cfg.dynamics.n_dims + cfg.dynamics.phar_nf)
        self.weights = inputs.make_weights(cell.config, seed, device)
        self.model = build_model(cfg, {k: v.cpu().numpy() for k, v in self.weights.items()},
                                 device, traffic["engine"])
        self.pocket_x, self.pocket_h = make_pocket(
            traffic["pocket"],
            np.random.RandomState(inputs.sub_seed(seed, "pocket") % 2 ** 32))
        degree = check_cutoff_exact(cell, self.pocket_x)
        log(f"pocket: {self.pocket_x.shape[0]} atoms, largest in-cutoff neighbour count "
            f"{degree} (+{traffic['n_phar_max']} pharmacophore slots)")
        self.recorder = Recorder(self.model)
        self.steps = check.steps_to_check(self.timesteps, seed)

    def noise(self, chain: int, steps: Optional[int] = None):
        return inputs.chain_noise(self.shape, steps or self.timesteps, self.seed, chain,
                                  self.device)

    def call(self, chain: int, noise=None, timesteps: Optional[int] = None,
             model=None) -> None:
        from cmdgen_tpu_torch.pipeline.sample_phars import sample_pharmacophores

        t = self.cell.traffic
        sample_pharmacophores(
            self.model if model is None else model, self.pocket_x, self.pocket_h, t["batch"],
            num_nodes=inputs.node_counts(t, self.seed, chain), n_phar_max=t["n_phar_max"],
            batch_size=t["batch"], timesteps=timesteps,
            noise=[self.noise(chain, timesteps) if noise is None else noise])

    def warm_up(self) -> None:
        """Every op of a chain at the cell's shapes: two chains of T=2."""
        for chain in (-1, -2):
            self.call(chain, timesteps=2)
        self.recorder.outputs.clear()

    def rerun(self, chain: int, calls=(), on_call=None):
        """Run ``chain`` again through the entry on a sampler built by
        ``ConditionalDDPM``'s documented constructor around the model's
        dynamics and engine (``convert.build_model``'s: the module, or
        ``make_fused_apply`` for K2), with a ``check.Tap`` on its
        ``apply_fn``: (the tap, what ``sample_given_pocket`` returned)."""
        from cmdgen_tpu_torch.diffusion.cddpm import ConditionalDDPM
        from cmdgen_tpu_torch.models.dynamics import make_fused_apply

        dynamics = self.model.dynamics
        fused = self.cell.traffic["engine"] == "fused"
        engine = make_fused_apply(dynamics) if fused else dynamics
        tap = check.Tap(engine, calls, on_call)
        model = ConditionalDDPM(self.model.cfg, dynamics, apply_fn=tap)
        recorder = Recorder(model)
        self.call(chain, model=model)
        return tap, recorder.outputs[0]

    def release(self) -> list:
        """Free the program's model; returns the recorded outputs."""
        outputs = self.recorder.outputs
        del self.model, self.recorder
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return outputs


def check_run(session: Session, chains: int, log=print):
    """Run the chain drawn from the seed again with its tap; free the
    program; hold it against the reference: (checks, clouds failed)."""
    chain = check.chain_to_check(chains, session.seed)
    tap, checked = session.rerun(chain, check.recorded_calls(session.steps, session.timesteps))
    outputs = session.release()
    per_cloud = check.chain_gaps(session.cell, session.seed, chain, tap, checked,
                                 outputs[chain], session.steps, session.weights,
                                 session.pocket_x, session.pocket_h, session.device)
    log(f"checked chain {chain} of {chains}: run again, {len(session.steps)} steps, the "
        f"start and the final decode of {session.cell.traffic['batch']} clouds")
    return check.judge(per_cloud, session.cell.limits)


def host_state() -> str:
    """The host's load and the card's clocks and power limit, for the log."""
    import os
    import subprocess

    load = " ".join(f"{v:.2f}" for v in os.getloadavg())
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,power.limit,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        card = f"nvidia-smi: {e}"
    return f"load average {load}; card (sm MHz, mem MHz, W, W limit, C): {card}"


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, t0: float,
        device: torch.device, log=print, pin=None) -> dict:
    """One run; returns the result line's object. ``pin``, where given, is
    called once set-up is done (``run.py`` pins the dispatching thread to
    one core there)."""
    marks = [("imports", time.perf_counter())]
    session = Session(cell, seed, device, log)
    marks.append(("CUDA context, weights, model and pocket", time.perf_counter()))
    result = Run(cell)
    session.warm_up()
    marks.append(("warm-up chains", time.perf_counter()))
    first = session.noise(0)
    if traced:
        trace.ChainTrace.warm_up(device)
        result.trace = trace.ChainTrace()
    if pin is not None:
        pin()
    setup_peak = memory_peak(device, reset=True)
    result.setup_s = time.perf_counter() - t0
    log("set-up: " + ", ".join(f"{name} {t - prev:.2f} s" for (name, t), prev
                                in zip(marks, [t0] + [t for _, t in marks])))
    before = host_state() if device.type == "cuda" else ""

    start = time.perf_counter()
    chain, ends = 0, []
    while True:
        if result.trace is not None and chain == 0:
            result.trace.start()
        session.call(chain, first if chain == 0 else None)
        if result.trace is not None and chain == 0:
            result.trace.stop()
        chain += 1
        ends.append(time.perf_counter() - start)
        if ends[-1] >= seconds:
            break
    result.window_s = time.perf_counter() - start
    result.clouds = chain * cell.traffic["batch"]
    result.window_peak_bytes = memory_peak(device)
    result.peak_bytes = max(setup_peak, result.window_peak_bytes)
    log(f"window: {chain} chains of {cell.traffic['batch']} clouds in "
        f"{result.window_s:.3f} s; chains ended at {[round(e, 3) for e in ends]} s")
    if device.type == "cuda":
        log(f"host before the window: {before}; after: {host_state()}")

    if result.trace is not None and result.trace.events is not None:
        lengths = np.diff([0.0] + ends)
        names = collections.Counter(name for name, *_ in result.trace.events.api)
        log(f"traced chain 0: {lengths[0]:.3f} s, the others' median "
            f"{float(np.median(lengths[1:])) if chain > 1 else float('nan'):.3f} s; host API "
            f"calls {dict(names)}; launch counters {result.trace.counters}")
        d = cell.config["dynamics"]

        def count(z, xh_pocket, mask_phar, mask_pocket):
            result.graphs.append(work.graph(z[..., :3], xh_pocket[..., :3], mask_phar,
                                            mask_pocket, d["edge_cutoff"], result.neighbor_k))

        session.rerun(0, on_call=count)
        g = result.graphs
        log("traced chain's in-cutoff edges (pharmacophore rows / all) at its first, middle "
            "and last call: " + ", ".join(f"{g[i].moving_edges} / {g[i].edges}"
                                          for i in (0, len(g) // 2, len(g) - 1)))
    del first
    t_check = time.perf_counter()
    checks, failed = check_run(session, chain, log)
    log(f"run again, reference and comparison: {time.perf_counter() - t_check:.1f} s")
    return finish(result, checks, failed, device, traced)


def memory_peak(device: torch.device, reset: bool = False) -> int:
    """The device's peak allocation since the last reset (0 off CUDA)."""
    if device.type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    if reset:
        torch.cuda.reset_peak_memory_stats(device)
    return peak


def forbidden_modules() -> List[str]:
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(FORBIDDEN))


def finish(result: Run, checks: Dict[str, dict], failed: int, device: torch.device,
           traced: bool) -> dict:
    """The result line's object: metrics read by the cell's readers, the
    device, the breakdown of a traced run and the checks, last."""
    cell = result.cell
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = m.reader(cell.root)(result)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
           "count": cell.chips, "memory_peak_bytes": result.peak_bytes}
    out = {"correct": all(c["ok"] for c in checks.values()),
           "attempted": result.clouds,
           "failed": failed,
           "metrics": metrics, "device": dev}
    if traced and result.events is not None:
        ev = result.events
        dev["busy_s"] = sum(e - s for s, e in trace.busy_intervals(ev)) / 1e9
        dev["window_s"] = (ev.end - ev.start) / 1e9
        out["breakdown"] = trace.breakdown(ev)
    out["checks"] = {k: {"value": v["value"], "limit": v["limit"]} for k, v in checks.items()}
    return out


def print_result(out: dict, log=print) -> None:
    for name, c in out["checks"].items():
        log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
