"""What decides ``correct``: one chain of the window, drawn from the seed,
run again after the window and followed step by step by the plain
reference from the program's own states.

A whole chain cannot be compared end to end: the neighbour rule is
discontinuous (an edge enters at the 6 A cutoff, or at the K-th nearest),
rounding moves a pair across it now and then, and the chain amplifies
that one edge's difference (up to alpha_0 / alpha_T over the chain). So
the timed window runs the program untouched, and once it has closed the
drawn chain runs again through the same entry with the same inputs, on a
sampler that the documented ``apply_fn`` argument of the configuration's
sampler class (``ConditionalDDPM`` or ``JointDDPM``, ``harness/samplers``)
builds around the model's own dynamics and engine, with a ``Tap`` on that
argument: it keeps the state handed to the denoiser and the denoiser's eps
of both clouds at the calls checked. The clouds of that run have to be the
timed chain's clouds, bit for bit; the reference then computes each
checked stage again from the program's state before it, on every cloud of
the chain:

- the start: z_T and the pocket from the chain's first draw;
- ``CHECK_STEPS`` reverse steps (in the joint model, inpainting ops: a
  denoise step and the known pocket spliced in) drawn from the seed (the
  first among them): state i to state i + 1, which is the input of the
  next call, so the handing on of the state is checked with the step;
- the final decode: the last state to the clouds returned.

The numbers compared, each against its limit in ``perfbench/limits/<cell>``:

- ``rerun_gap``: the largest difference between the timed chain's clouds
  (coordinates, types, mask) and the checked run's (exact: limit 0);
- ``eps_gap``: over the checked steps and the decode, the largest
  difference between the program's and the reference's eps on the same
  state, coordinates and features each over their own largest reference
  entry; the pharmacophore's eps, and in the joint model the pocket's too,
  each over its own entries;
- ``step_gap``: over the start and the steps, the largest difference
  between the program's and the reference's next state, coordinates (the
  pharmacophore nodes' and the pocket's) over their largest entry (at
  least 1) and features over theirs (at least 1; the pocket's apart);
- ``x_gap``: the final clouds' largest coordinate difference in the
  pocket's frame (the entry adds the pocket's centre back), over the
  cloud's largest reference coordinate (at least 1 A);
- ``type_gap``: the largest amount by which the reference's logit of the
  type the program chose lies below the reference's best, over the
  cloud's largest logit (at least 1);
- ``mask_mismatch``: slots whose validity differs from the node counts
  (exact: limit 0);
- ``calls_mismatch``: how far the checked run's denoiser calls are from its
  T reverse steps (in the joint model T denoise ops: one resampling, no
  jump) and one final decode (exact: limit 0); where they differ
  the states are not the ones checked, and every other number reads
  infinite.

A value that is not finite fails.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from perfbench.harness import inputs, samplers
from perfbench.reference import sampler as ref

# (z, pocket, eps, pocket eps): a call's input state and the denoiser's eps
# of both clouds on it
Record = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
State = Tuple[torch.Tensor, torch.Tensor]
# (eps, pocket eps): the pocket's is None where the pocket does not move
Eps = Tuple[torch.Tensor, Optional[torch.Tensor]]
# reverse steps checked a chain (all of them where T is smaller)
CHECK_STEPS = 32
# eps_gap's least scale: a part of eps this small is compared absolutely
EPS_FLOOR = 1e-3


def steps_to_check(steps: int, seed: int) -> List[int]:
    """The reverse steps to check, drawn from the seed, the first always
    among them; the final decode is call ``steps``."""
    n = min(CHECK_STEPS, steps)
    rng = np.random.RandomState(inputs.sub_seed(seed, "steps") % 2 ** 32)
    picked = {0} | {int(i) for i in rng.choice(steps, n - 1, replace=False)} if n > 1 else {0}
    return sorted(picked)


def chain_to_check(chains: int, seed: int) -> int:
    """The window's chain to check, drawn from the seed."""
    return int(np.random.RandomState(inputs.sub_seed(seed, "chain") % 2 ** 32).randint(chains))


class Tap:
    """A denoiser with the signature of the samplers' ``apply_fn`` that
    calls ``apply_fn``, counts the calls, keeps (state, pocket, eps, pocket
    eps) copies of calls ``calls``, and hands every call's inputs to
    ``on_call`` (when given)."""

    def __init__(self, apply_fn, calls: Sequence[int] = (),
                 on_call: Optional[Callable] = None):
        self.apply_fn = apply_fn
        self.calls = frozenset(calls)
        self.on_call = on_call
        self.records: Dict[int, Record] = {}
        self.n = 0

    def __call__(self, z, xh_pocket, t, mask_phar, mask_pocket):
        out = self.apply_fn(z, xh_pocket, t, mask_phar, mask_pocket)
        if self.n in self.calls:
            self.records[self.n] = (z.clone(), xh_pocket.clone(), out[0].clone(),
                                    out[1].clone())
        if self.on_call is not None:
            self.on_call(z, xh_pocket, mask_phar, mask_pocket)
        self.n += 1
        return out


def recorded_calls(steps: Sequence[int], total: int) -> List[int]:
    """The calls whose records the check reads: each checked step's and the
    next one's, the first, and the final decode (call ``total``)."""
    return sorted({0, total} | {i for s in steps for i in (s, s + 1)})


def reference_outputs(cell, weights, pocket_x: np.ndarray, pocket_h: np.ndarray,
                      noise, nodes: torch.Tensor, records: Dict[int, Record],
                      steps: Sequence[int], tf32: bool = False):
    """The reference's start, its (next state, eps) at each checked step
    from the program's state, and its final clouds from the program's last
    state, by the configuration's sampler (``samplers.Sampler.reference``):
    ({"start": State, step: (State, Eps), ...}, final dict). With ``tf32``
    its products run in TF32, a precision below the configuration's (the
    control)."""
    ref.check_chain(cell.config)
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        with torch.no_grad():
            return samplers.of(cell.config).reference(cell, weights, pocket_x, pocket_h, noise,
                                                      nodes, records, steps)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _part_gap(got, want, mask, floor):
    """Per cloud: the largest difference over real nodes, over the largest
    reference entry (at least ``floor``)."""
    m = mask[..., None]
    diff = ((got - want).abs() * m).amax((1, 2))
    return diff / (want.abs() * m).amax((1, 2)).clamp_min(floor)


def state_gap(got: State, want: State, mask_phar: torch.Tensor, nd: int) -> torch.Tensor:
    """Per cloud: the largest difference of the coordinates (pharmacophore
    nodes and pocket) over their largest entry, of the pharmacophore
    features over theirs and of the pocket's features over theirs (each at
    least 1); the largest of the three. (The conditional sampler hands the
    pocket's features on unchanged: that part reads 0 there.)"""
    x_scale = torch.maximum((want[0][..., :nd].abs() * mask_phar[..., None]).amax((1, 2)),
                            want[1][..., :nd].abs().amax((1, 2))).clamp_min(1.0)
    dx = torch.maximum(((got[0][..., :nd] - want[0][..., :nd]).abs()
                        * mask_phar[..., None]).amax((1, 2)),
                       (got[1][..., :nd] - want[1][..., :nd]).abs().amax((1, 2)))
    dh = _part_gap(got[0][..., nd:], want[0][..., nd:], mask_phar, 1.0)
    dq = _part_gap(got[1][..., nd:], want[1][..., nd:], _every_row(got[1]), 1.0)
    return torch.maximum(torch.maximum(dx / x_scale, dh), dq)


def _every_row(v: torch.Tensor) -> torch.Tensor:
    """A mask of every row of the pocket ([R, Nq]): its padded rows are 0
    on both sides."""
    return torch.ones(v.shape[:2], device=v.device)


def eps_gap(got: Eps, want: Eps, mask_phar: torch.Tensor, nd: int) -> torch.Tensor:
    """Per cloud: the eps difference of coordinates and of features, each
    over its largest reference entry (at least ``EPS_FLOOR``); the
    pharmacophore's, and the pocket's where the reference has one."""
    gap = torch.maximum(_part_gap(got[0][..., :nd], want[0][..., :nd], mask_phar, EPS_FLOOR),
                        _part_gap(got[0][..., nd:], want[0][..., nd:], mask_phar, EPS_FLOOR))
    if want[1] is None:
        return gap
    rows = _every_row(want[1])
    return torch.maximum(gap, torch.maximum(
        _part_gap(got[1][..., :nd], want[1][..., :nd], rows, EPS_FLOOR),
        _part_gap(got[1][..., nd:], want[1][..., nd:], rows, EPS_FLOOR)))


def _in_pocket_frame(x, pocket_x):
    return x - pocket_x.mean(1, keepdim=True)


def final_gaps(phar_x, phar_types, phar_mask, pocket_x, want: Dict[str, torch.Tensor],
               nodes: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per cloud: x_gap, type_gap and mask_mismatch of final clouds against
    the reference's ``want``."""
    mask = want["mask"]
    dev = mask.device
    wanted = ref.phar_mask(nodes.to(dev), mask.shape[1])
    xp = _in_pocket_frame(phar_x.float(), pocket_x.float())
    xr = _in_pocket_frame(want["x"], want["pocket_x"])
    dx = ((xp - xr).norm(dim=-1) * mask).amax(1)
    x_scale = (xr.norm(dim=-1) * mask).amax(1).clamp_min(1.0)
    logits = want["type_logits"]
    chosen = logits.gather(-1, phar_types.float().argmax(-1, keepdim=True))[..., 0]
    below = ((logits.amax(-1) - chosen) * mask).amax(1)
    l_scale = (logits.abs().amax(-1) * mask).amax(1).clamp_min(1.0)
    return {"x_gap": dx / x_scale, "type_gap": below / l_scale,
            "mask_mismatch": (phar_mask.float() != wanted).sum(1).float()}


def rerun_gap(timed, checked) -> torch.Tensor:
    """Per cloud: the largest difference between two runs' (phar, pocket)
    outputs, coordinates, types and mask."""
    (p, q), (p2, q2) = timed, checked
    parts = [(p.x - p2.x).abs().amax((1, 2)), (p.h - p2.h).abs().amax((1, 2)),
             (p.mask - p2.mask).abs().amax(1), (q.x - q2.x).abs().amax((1, 2))]
    return torch.stack(parts).amax(0)


def program_states(records: Dict[int, Record], steps: Sequence[int], T: int):
    """The program's state after the start and after each checked step (the
    inputs of the calls that follow them), and its eps at each checked step
    and at the decode: ({"start" or step: State}, {step or T: Eps})."""
    states = {"start": records[0][:2], **{s: records[s + 1][:2] for s in steps if s < T}}
    eps = {s: records[s][2:] for s in [*steps, T] if s <= T}
    return states, eps


def gaps(states, eps, final, ref_states, ref_final, nodes: torch.Tensor,
         cfg: dict) -> Dict[str, torch.Tensor]:
    """Per cloud, every number compared against the reference: ``states``
    and ``eps`` as ``program_states`` gives them, ``final`` (x, types, mask,
    pocket_x)."""
    nd = cfg["dynamics"]["n_dims"]
    mask = ref_final["mask"]
    step = torch.stack([state_gap(states["start"], ref_states["start"], mask, nd)]
                       + [state_gap(states[s], ref_states[s][0], mask, nd)
                          for s in ref_states if s != "start"]).amax(0)
    want_eps = {**{s: v[1] for s, v in ref_states.items() if s != "start"},
                max(eps): (ref_final["eps"], ref_final.get("eps_pocket"))}
    e = torch.stack([eps_gap(eps[s], want_eps[s], mask, nd) for s in want_eps]).amax(0)
    return {"eps_gap": e, "step_gap": step, **final_gaps(*final, ref_final, nodes)}


def judge(per_cloud: Dict[str, torch.Tensor], limits: Dict[str, float]):
    """({name: {"value", "limit", "ok"}}, clouds outside a limit)."""
    checks = {}
    failed = torch.zeros_like(next(iter(per_cloud.values())), dtype=torch.bool)
    for name, v in per_cloud.items():
        bad = ~torch.isfinite(v) | (v > limits[name])
        failed |= bad
        worst = float(v.max()) if bool(torch.isfinite(v).all()) else float("inf")
        checks[name] = {"value": worst, "limit": limits[name], "ok": not bool(bad.any())}
    return checks, int(failed.sum())


def chain_gaps(cell, seed: int, chain: int, tap: Tap, checked, timed, steps, weights,
               pocket_x, pocket_h, device, tf32: bool = False):
    """Per cloud, every number compared for the program's ``chain``: ``tap``
    ran on its checked run, whose outputs are ``checked``; ``timed`` are
    the timed chain's."""
    T = cell.config["ddpm"]["timesteps"]
    b = cell.traffic["batch"]
    mismatch = torch.full((b,), float(abs(tap.n - (T + 1))), device=device)
    again = rerun_gap(timed, checked).to(device)
    if mismatch.any() or set(recorded_calls(steps, T)) - set(tap.records):
        inf = torch.full((b,), float("inf"), device=device)
        return {"rerun_gap": again, "eps_gap": inf, "step_gap": inf, "x_gap": inf,
                "type_gap": inf, "mask_mismatch": inf, "calls_mismatch": mismatch}
    phar, pocket = checked
    noise = samplers.of(cell.config).draws(cell, seed, chain, T, device)
    nodes = torch.from_numpy(inputs.node_counts(cell.traffic, seed, chain))
    ref_states, ref_final = reference_outputs(cell, weights, pocket_x, pocket_h, noise, nodes,
                                              tap.records, steps, tf32)
    states, eps = program_states(tap.records, steps, T)
    return {"rerun_gap": again,
            **gaps(states, eps, (phar.x, phar.h, phar.mask, pocket.x), ref_states, ref_final,
                   nodes, cell.config),
            "calls_mismatch": mismatch}
