"""The work a denoiser call needs, counted from its inputs, and the chip's
peaks: the benchmark's yardstick for rooflines and MFU.

Edges are the directed in-cutoff pairs of real nodes (self-edges
included), capped at the K nearest of each receiver where the cell sets
K: what the inputs need, not the B x N x K slots a kernel may compute.
The count is the same whichever engine runs (dense, K1 or K2): it takes
no engine. The coordinate update's rows and edges are those of the rows
that move: the pharmacophore rows of the conditional model, every row of
the joint one (``update_pocket_coords``). Operations are the
multiply-adds of the model's dense layers (2 flops each) and the
attention dot and coordinate gate of each edge; the elementwise work is
left out. Bytes count each input read once and
each output written once.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# NVIDIA H100 SXM, dense rates (data sheet): the card's power limit is
# reported beside every share
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
ELEMENT_BYTES = {"float32": 4, "bfloat16": 2}


@dataclasses.dataclass(frozen=True)
class Graph:
    """One denoiser call's counts, summed over its batch."""

    nodes: int        # real nodes (pharmacophore and pocket)
    moving: int       # real nodes whose coordinates move
    pocket: int       # real pocket nodes
    edges: int        # in-cutoff edges of real receivers
    moving_edges: int  # of those, the edges of moving receivers
    phar: int         # real pharmacophore nodes


def graph(x_phar: torch.Tensor, x_pocket: torch.Tensor, mask_phar: torch.Tensor,
          mask_pocket: torch.Tensor, dynamics: dict, neighbor_k: Optional[int]) -> Graph:
    """Counts of one call from its coordinates [B, Np, 3], [B, Nq, 3] and
    masks [B, Np], [B, Nq], under a configuration file's ``dynamics``
    group: its ``edge_cutoff``, and its ``update_pocket_coords``, which
    makes the pocket's rows move beside the pharmacophore's."""
    cutoff, all_rows_move = dynamics["edge_cutoff"], dynamics["update_pocket_coords"]
    x = torch.cat([x_phar, x_pocket], dim=1).float()
    mask = torch.cat([mask_phar, mask_pocket], dim=1).float()
    d2 = ((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1)
    e = mask[:, :, None] * mask[:, None, :]
    if cutoff is not None:
        e = e * (d2 <= cutoff ** 2).float()
    degree = e.sum(-1)
    if neighbor_k is not None:
        degree = degree.clamp(max=neighbor_k)
    n_phar = x_phar.shape[1]
    phar, edges = int(mask_phar.sum()), int(degree.sum())
    return Graph(nodes=int(mask.sum()), moving=int(mask.sum()) if all_rows_move else phar,
                 pocket=int(mask_pocket.sum()), edges=edges,
                 moving_edges=edges if all_rows_move else int(degree[:, :n_phar].sum()),
                 phar=phar)


def k1(g: Graph, hidden: int, dtype: str):
    """(flops, bytes) of one K1 launch: one GCL's messages and their sum."""
    es = ELEMENT_BYTES[dtype]
    flops = 2 * g.edges * hidden * hidden + 2 * g.edges * hidden
    nbytes = (3 * g.nodes * hidden * es          # w_i h, w_j h in; the sum out
              + g.edges * (4 + 2 * es)          # index, radial, dist0 of each edge
              + (hidden * hidden + 4 * hidden + 1) * es)  # W2, w_e, biases, att
    return flops, nbytes


def layer_flops(g: Graph, hidden: int) -> int:
    """One EGNN block (a GCL and the coordinate update) at width H."""
    h2 = hidden * hidden
    gcl = (2 * 2 * g.nodes * h2                  # w_i h, w_j h
           + 2 * g.edges * h2 + 2 * g.edges * hidden  # edge_out, attention
           + 2 * g.nodes * 2 * h2 + 2 * g.nodes * h2)  # node_in, node_out
    coord = (2 * g.moving * h2 + 2 * g.nodes * h2      # coord_in w_i, w_j
             + 2 * g.moving_edges * h2 + 2 * g.moving_edges * hidden)  # coord_mid, gate
    return gcl + coord


def k2(g: Graph, hidden: int, layers: int, dtype: str):
    """(flops, bytes) of one K2 launch: the whole layer stack."""
    es = ELEMENT_BYTES[dtype]
    flops = layers * layer_flops(g, hidden)
    nbytes = (g.nodes * hidden * es + g.nodes * hidden * 4   # h in, h out
              + 2 * g.nodes * 3 * 4                          # x in, x out
              + g.edges * (4 + 4 + 4)                        # index, mask, dist0
              + layers * (9 * hidden * hidden + 12 * hidden + 1) * es)
    return flops, nbytes


def denoiser_flops(g: Graph, cfg: dict) -> int:
    """The model's operations for one call of the EGNN dynamics of a
    configuration file, at its widths."""
    d = cfg["dynamics"]
    e = d["egnn"]
    hidden, j = e["hidden_nf"], d["joint_nf"]
    p, r = d["phar_nf"], d["residue_nf"]
    in_nf = j + int(d["condition_time"])
    typed = (g.phar * 2 * (p * 2 * p + 2 * p * j + j * 2 * p + 2 * p * p)
             + g.pocket * 2 * (r * 2 * r + 2 * r * j + j * 2 * r + 2 * r * r))
    return (typed + 2 * g.nodes * in_nf * hidden * 2
            + e["n_layers"] * layer_flops(g, hidden))


def roofline_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)
