"""What depends on the sampler that a configuration's ``train.mode`` picks.

- ``pocket_conditioning``: ``ConditionalDDPM.sample_given_pocket``; the
  pocket is context and only the pharmacophore rows move;
- ``joint``: ``JointDDPM.inpaint``, RePaint with the pocket held fixed;
  every row moves, and each op splices the known pocket back in.

The entry is the same for both: ``sample_pharmacophores`` sends a
``JointDDPM`` to ``inpaint`` (one resampling, a jump length of one) and a
``ConditionalDDPM`` to ``sample_given_pocket``. Each ``Sampler`` gives the
rest: the method the ``Recorder`` wraps, the chain's draws from the seed,
the rerun's sampler built by the program's documented constructor around
the tap, and the reference that follows the chain from the program's
recorded states. ``of`` refuses any other mode by name, before set-up.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence

import torch

from perfbench.harness import inputs
from perfbench.reference import joint as refjoint
from perfbench.reference import sampler as ref

# the reference's working set per row of a block, in units of
# (receivers x sources x hidden) float32 values
REFERENCE_LIVE = 8


@dataclasses.dataclass(frozen=True)
class Sampler:
    """One configuration mode's sampler, as the harness drives and checks it.

    ``method``: the model's method that the entry calls once a batch.
    ``draws(cell, seed, chain, steps, device)``: a chain's draws, the
    method's ``noise``. ``rerun(ddpm_cfg, dynamics, apply_fn)``: the sampler
    around ``apply_fn``. ``reference(cell, weights, pocket_x, pocket_h,
    noise, nodes, records, steps)``: the reference's start, its (next
    state, (eps, pocket eps or None)) at each checked step from the
    program's state before it, and its final clouds from the program's
    last state (with ``eps`` and, where the pocket moves, ``eps_pocket``)."""

    method: str
    draws: Callable
    rerun: Callable
    reference: Callable


def reference_block(cell, rows: int) -> int:
    """Rows of a reference block: what fits in half the device's free
    memory (a quarter of 4 GiB off CUDA) at the cell's edges a row."""
    cfg, traffic = cell.config, cell.traffic
    n = traffic["n_phar_max"] + traffic["pocket"]["atoms"]
    sources = traffic.get("neighbor_k") or n
    per_row = REFERENCE_LIVE * 4 * n * min(sources, n) * cfg["dynamics"]["egnn"]["hidden_nf"]
    free = torch.cuda.mem_get_info()[0] if torch.cuda.is_available() else 2 ** 32
    return max(1, min(rows, int(0.5 * free // per_row)))


def in_blocks(fn: Callable, args: Sequence[torch.Tensor], block: int):
    """``fn`` over blocks of ``block`` rows of ``args`` (all [rows, ...]),
    its outputs (tensors in tuples and dicts) joined along the rows."""
    parts = [fn(*(a[i:i + block] for a in args)) for i in range(0, args[0].shape[0], block)]

    def join(items):
        if isinstance(items[0], torch.Tensor):
            return torch.cat(items)
        if isinstance(items[0], dict):
            return {key: join([p[key] for p in items]) for key in items[0]}
        return tuple(join(list(z)) for z in zip(*items))

    return join(parts)


def _chain_inputs(cell, pocket_x, pocket_h, nodes, device, b):
    """(gamma, the pharmacophore mask, the pocket's coordinates, types and
    mask for ``b`` clouds) on ``device``."""
    cfg = cell.config
    ddpm = cfg["ddpm"]
    gamma = ref.gamma_table(ddpm["noise_schedule"], ddpm["timesteps"],
                            ddpm["noise_precision"]).to(device)
    mask = ref.phar_mask(nodes.to(device), cell.traffic["n_phar_max"])
    px = torch.from_numpy(pocket_x).to(device).expand(b, *pocket_x.shape)
    ph = torch.from_numpy(pocket_h).to(device).expand(b, *pocket_h.shape)
    return gamma, mask, px, ph, torch.ones(b, pocket_x.shape[0], device=device)


def _phar_shape(cell):
    d = cell.config["dynamics"]
    return (cell.traffic["batch"], cell.traffic["n_phar_max"], d["n_dims"] + d["phar_nf"])


# ------------------------------------------------------------ conditional


def conditional_draws(cell, seed: int, chain: int, steps: int, device: torch.device):
    return inputs.chain_noise(_phar_shape(cell), steps, seed, chain, device)


def conditional_rerun(ddpm_cfg, dynamics, apply_fn):
    from cmdgen_tpu_torch.diffusion.cddpm import ConditionalDDPM

    return ConditionalDDPM(ddpm_cfg, dynamics, apply_fn=apply_fn)


def conditional_reference(cell, weights, pocket_x, pocket_h, noise, nodes, records,
                          steps: Sequence[int]):
    cfg, k = cell.config, cell.traffic.get("neighbor_k")
    T = cfg["ddpm"]["timesteps"]
    init, chain, last = noise
    b = init.shape[0]
    gamma, mask, px, ph, pmask = _chain_inputs(cell, pocket_x, pocket_h, nodes, init.device, b)
    out: Dict[object, object] = {"start": ref.initial(cfg, px, ph, pmask, mask, init)}
    rows = [s for s in steps if s < T]
    if rows:
        z = torch.cat([records[s][0] for s in rows])
        step = torch.tensor(rows, device=init.device).repeat_interleave(b)
        args = (z, torch.cat([records[s][1] for s in rows]), step,
                torch.cat([chain[s] for s in rows]), mask.repeat(len(rows), 1),
                pmask.repeat(len(rows), 1))
        (nz, npk), neps = in_blocks(
            lambda *a: ref.reverse(weights, cfg, gamma, *a, k), args,
            reference_block(cell, z.shape[0]))
        for j, s in enumerate(rows):
            sl = slice(j * b, (j + 1) * b)
            out[s] = ((nz[sl], npk[sl]), (neps[sl], None))
    final = in_blocks(lambda *a: ref.final(weights, cfg, gamma, *a, k),
                      (*records[T][:2], last, mask, pmask), reference_block(cell, b))
    return out, final


# ------------------------------------------------------------------ joint


def joint_draws(cell, seed: int, chain: int, steps: int, device: torch.device):
    d = cell.config["dynamics"]
    b = cell.traffic["batch"]
    pocket = (b, cell.traffic["pocket"]["atoms"], d["n_dims"] + d["residue_nf"])
    return inputs.joint_noise(_phar_shape(cell), pocket,
                              inputs.node_counts(cell.traffic, seed, chain), steps, seed,
                              chain, device, d["n_dims"])


def joint_rerun(ddpm_cfg, dynamics, apply_fn):
    from cmdgen_tpu_torch.diffusion.joint import JointDDPM

    return JointDDPM(ddpm_cfg, dynamics, apply_fn=apply_fn)


def joint_reference(cell, weights, pocket_x, pocket_h, noise, nodes, records,
                    steps: Sequence[int]):
    cfg, k = cell.config, cell.traffic.get("neighbor_k")
    T = cfg["ddpm"]["timesteps"]
    init, ops, last = noise
    b = init[0].shape[0]
    gamma, mask, px, ph, pmask = _chain_inputs(cell, pocket_x, pocket_h, nodes,
                                               init[0].device, b)
    known = refjoint.known_pocket(cfg, px, ph, pmask)
    out: Dict[object, object] = {"start": init}
    rows = [s for s in steps if s < T]
    if rows:
        n = len(rows)
        step = torch.tensor(rows, device=mask.device).repeat_interleave(b)
        args = (*(torch.cat([records[s][i] for s in rows]) for i in (0, 1)), step,
                *(torch.cat([ops[s][j][i] for s in rows]) for j in (0, 1) for i in (0, 1)),
                known.repeat(n, 1, 1), mask.repeat(n, 1), pmask.repeat(n, 1))

        def op(zp, zq, st, dp, dq, sp, sq, kn, mp, mq):
            return refjoint.reverse(weights, cfg, gamma, (zp, zq), st, (dp, dq), (sp, sq), kn,
                                    mp, mq, k)

        (nz, nq), (ep, eq) = in_blocks(op, args, reference_block(cell, n * b))
        for j, s in enumerate(rows):
            sl = slice(j * b, (j + 1) * b)
            out[s] = ((nz[sl], nq[sl]), (ep[sl], eq[sl]))

    def decode(zp, zq, lp, lq, mp, mq):
        return refjoint.final(weights, cfg, gamma, (zp, zq), (lp, lq), mp, mq, k)

    final = in_blocks(decode, (*records[T][:2], *last, mask, pmask), reference_block(cell, b))
    return out, final


SAMPLERS = {
    "pocket_conditioning": Sampler("sample_given_pocket", conditional_draws, conditional_rerun,
                                   conditional_reference),
    "joint": Sampler("inpaint", joint_draws, joint_rerun, joint_reference),
}


def of(config: dict) -> Sampler:
    """The sampler of a configuration file's ``train.mode``; ValueError for
    a mode the harness has no sampler for."""
    mode = config["train"]["mode"]
    if mode not in SAMPLERS:
        raise ValueError(f"train.mode {mode!r}: the benchmark drives no sampler for it; "
                         f"known: {sorted(SAMPLERS)}")
    return SAMPLERS[mode]
