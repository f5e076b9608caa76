"""Everything a run feeds the program and the reference, made from the seed.

Sub-seeds come from a hash of (seed, what, index), so any whole number is
a seed and each input has a stream of its own: the weights, the pocket, the
node counts and each chain's noise. Weights and noise are drawn on the
device in one call each; the pocket and the node counts on the host (the
sampler's entry takes them as arrays).
"""
from __future__ import annotations

import hashlib
from typing import Dict, Tuple

import numpy as np
import torch


def sub_seed(seed: int, what: str, index: int = 0) -> int:
    """A 63-bit seed for input ``what`` (and chain ``index``) of run ``seed``."""
    digest = hashlib.sha256(f"{seed}:{what}:{index}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def weight_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Flattened flax leaves of the EGNN dynamics of a configuration file,
    in the layout the program's checkpoints hold (``a/b/kernel`` [in, out],
    ``a/b/bias`` [out])."""
    d = cfg["dynamics"]
    e = d["egnn"]
    h, j = e["hidden_nf"], d["joint_nf"]
    shapes: Dict[str, Tuple[int, ...]] = {}

    def dense(path, n_in, n_out, bias=True):
        shapes[f"{path}/kernel"] = (n_in, n_out)
        if bias:
            shapes[f"{path}/bias"] = (n_out,)

    for name, nf in (("phar", d["phar_nf"]), ("residue", d["residue_nf"])):
        dense(f"{name}_encoder/Dense_0", nf, 2 * nf)
        dense(f"{name}_encoder/Dense_1", 2 * nf, j)
    in_nf = j + int(d["condition_time"])
    dense("egnn/embedding", in_nf, h)
    for layer in range(e["n_layers"]):
        for sub in range(e["inv_sublayers"]):
            g = f"egnn/e_block_{layer}/gcl_{sub}"
            dense(f"{g}/edge_in/w_i", h, h, bias=False)
            dense(f"{g}/edge_in/w_j", h, h)
            dense(f"{g}/edge_in/w_e", 2, h, bias=False)
            dense(f"{g}/edge_out", h, h)
            if e["attention"]:
                dense(f"{g}/att", h, 1)
            dense(f"{g}/node_in", 2 * h, h)
            dense(f"{g}/node_out", h, h)
        c = f"egnn/e_block_{layer}/coord_update"
        dense(f"{c}/coord_in/w_i", h, h, bias=False)
        dense(f"{c}/coord_in/w_j", h, h)
        dense(f"{c}/coord_in/w_e", 2, h, bias=False)
        dense(f"{c}/coord_mid", h, h)
        dense(f"{c}/coord_gate", h, 1, bias=False)
    dense("egnn/embedding_out", h, in_nf)
    for name, nf in (("phar", d["phar_nf"]), ("residue", d["residue_nf"])):
        dense(f"{name}_decoder/Dense_0", j, 2 * nf)
        dense(f"{name}_decoder/Dense_1", 2 * nf, nf)
    return shapes


def make_weights(cfg: dict, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """Random weights of the configuration on ``device``, float32, from one
    draw: every kernel and bias normal with std 1/sqrt(fan_in), clipped at
    2 std. The coordinate gate gets that scale too (not the published
    initialisation's 1e-6 variance), so that a layer moves the
    pharmacophore nodes and a wrong displacement shows.

    A random network does not denoise, and the sampler amplifies whatever
    its eps leaves of the noise by up to alpha_0 / alpha_T over the chain.
    The configuration's ``seeded_weights`` group damps that: the coordinate
    gate's kernel is scaled by ``coord_gate_spread`` and shifted by
    ``coord_gate_mean`` / fan_in (a gate that pushes a node away from its
    neighbours gives an eps that the chain takes back, so the cloud holds
    together), and the pharmacophore type decoder's last layer is scaled by
    ``type_decoder_scale`` (its eps on the features, fed back through the
    encoder, would otherwise grow without bound)."""
    shapes = weight_shapes(cfg)
    sizes = [int(np.prod(s)) for s in shapes.values()]
    fan_in = [shapes[path.rsplit("/", 1)[0] + "/kernel"][0] for path in shapes]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    flat = torch.randn(sum(sizes), generator=gen, device=device).clamp_(-2.0, 2.0)
    flat *= torch.repeat_interleave(
        torch.tensor([f ** -0.5 for f in fan_in], device=device),
        torch.tensor(sizes, device=device))
    weights = {path: t.view(shape) for (path, shape), t in zip(shapes.items(), flat.split(sizes))}
    damp = cfg.get("seeded_weights", {})
    for path, w in weights.items():
        if path.endswith("/coord_gate/kernel"):
            w.mul_(damp.get("coord_gate_spread", 1.0)).add_(
                damp.get("coord_gate_mean", 0.0) / w.shape[0])
        elif path.startswith("phar_decoder/Dense_1/"):
            w.mul_(damp.get("type_decoder_scale", 1.0))
    return weights


def node_counts(traffic: dict, seed: int, chain: int) -> np.ndarray:
    """The pharmacophore node counts of one chain's clouds, uniform over
    the traffic's [lo, hi]."""
    lo, hi = traffic["nodes"]
    rng = np.random.RandomState(sub_seed(seed, "nodes", chain) % 2 ** 32)
    return rng.randint(lo, hi + 1, traffic["batch"]).astype(np.int64)


def chain_noise(shape: Tuple[int, int, int], steps: int, seed: int, chain: int,
                device: torch.device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(init [B, Np, F], chain [T, B, Np, F], final [B, Np, F]): one chain's
    standard-normal draws, ``sample_given_pocket``'s ``noise``."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "noise", chain))
    draws = torch.randn((steps + 2, *shape), generator=gen, device=device)
    return draws[0], draws[1:-1], draws[-1]
