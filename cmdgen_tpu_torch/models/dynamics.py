"""Two-node-type denoiser around the EGNN (counterpart of
``cmdgen_tpu/models/dynamics.py``).

Pharmacophore and pocket nodes are encoded by per-type MLPs, concatenated,
conditioned on the diffusion time, run through the EGNN over a 6 Å cutoff
adjacency (self-edges included) and decoded per type. Velocity = coordinate
displacement.

``EGNNDynamics`` is the module (the JAX package's flax path, with the K1
kernel on the neighbor-list engine); ``make_fused_apply`` is the
counterpart of ``make_pallas_apply``: the same function with the EGNN
stack in the K2 kernel. The ``gnn_dynamics`` mode replaces the EGNN with
the plain ``GNN``: coordinates go in as node features and the velocities
are read from the first 3 output channels (not E(3)-equivariant).

**CUDA graphs.** On the neighbor-list engine with K1 in every GCL and K3
in every coordinate update (CUDA inputs, outside autograd), the module's
call replays its whole forward pass as one CUDA graph
(``graphed_forward``): captured at the first call of each input shape
(``graph_key``), replayed on that call and every later one. The graph holds the same kernels on the same data as the op-by-op
pass (``EGNNDynamics.eager_forward``): the host launches it once, with
the inputs' copies in and the outputs' copies out, in place of each of
its kernels. Every other call runs op by op (``graph_refusal``).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cmdgen_tpu_torch.models.egnn import EGNN, GNN, EGNNConfig, linear
from cmdgen_tpu_torch.ops.egnn_coord import coord_update_agg
from cmdgen_tpu_torch.ops.egnn_fused import check_fused_shape, egnn_forward_fused, fused_params
from cmdgen_tpu_torch.ops.egnn_msgpass import gcl_message_agg, kernel_route
from cmdgen_tpu_torch.ops.masked import pair_mask, remove_mean
from cmdgen_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class DynamicsConfig:
    phar_nf: int = 8
    residue_nf: int = 20
    joint_nf: int = 32
    n_dims: int = 3
    condition_time: bool = True
    update_pocket_coords: bool = False  # False => conditional model
    edge_cutoff: Optional[float] = 6.0  # Å; None => complete graph
    mode: str = "egnn_dynamics"  # 'egnn_dynamics' | 'gnn_dynamics'
    egnn: EGNNConfig = dataclasses.field(default_factory=EGNNConfig)


class TypeMLP(nn.Module):
    """Per-type 2-layer encoder/decoder."""

    def __init__(self, in_nf: int, mid: int, out: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_nf, mid)
        self.Dense_1 = nn.Linear(mid, out)

    def forward(self, h, dtype):
        return linear(F.silu(linear(h, self.Dense_0, dtype)), self.Dense_1, dtype)

    def forward_f32(self, h):
        """float32 throughout, as make_pallas_apply's _type_mlp."""
        h = F.silu(F.linear(h.float(), self.Dense_0.weight.float(), self.Dense_0.bias.float()))
        return F.linear(h, self.Dense_1.weight.float(), self.Dense_1.bias.float())


class EGNNDynamics(nn.Module):
    """eps-prediction network over (pharmacophore, pocket) padded clouds.

    forward(xh_phar [B,Np,3+Fp], xh_pocket [B,Nq,3+Fq], t [B,1],
            mask_phar [B,Np], mask_pocket [B,Nq])
      -> (eps_phar [B,Np,3+Fp], eps_pocket [B,Nq,3+Fq])
    """

    def __init__(self, cfg: DynamicsConfig):
        super().__init__()
        self.cfg = cfg
        self.phar_encoder = TypeMLP(cfg.phar_nf, 2 * cfg.phar_nf, cfg.joint_nf)
        self.residue_encoder = TypeMLP(cfg.residue_nf, 2 * cfg.residue_nf, cfg.joint_nf)
        in_nf = cfg.joint_nf + int(cfg.condition_time)
        if cfg.mode == "gnn_dynamics":
            self.gnn = GNN(cfg.egnn, cfg.n_dims + in_nf, cfg.n_dims + in_nf)
        elif cfg.mode == "egnn_dynamics":
            self.egnn = EGNN(cfg.egnn, in_nf, cfg.joint_nf + 1)
        else:
            raise ValueError(f"unknown dynamics mode {cfg.mode!r}")
        self.phar_decoder = TypeMLP(cfg.joint_nf, 2 * cfg.phar_nf, cfg.phar_nf)
        self.residue_decoder = TypeMLP(cfg.joint_nf, 2 * cfg.residue_nf, cfg.residue_nf)
        self.graphs = DenoiserGraphs()

    def _inputs(self, xh_phar, xh_pocket, t, mask_phar, mask_pocket, encode):
        """Encoded joint cloud: (h, x, mask, edge_mask, update_coords_mask)."""
        cfg = self.cfg
        nd = cfg.n_dims
        h_phar = encode(self.phar_encoder, xh_phar[..., nd:])
        h_pocket = encode(self.residue_encoder, xh_pocket[..., nd:])
        x = torch.cat([xh_phar[..., :nd], xh_pocket[..., :nd]], dim=-2)
        h = torch.cat([h_phar, h_pocket], dim=-2)
        mask = torch.cat([mask_phar, mask_pocket], dim=-1)
        if cfg.condition_time:
            h_time = t[:, None, :].expand(*h.shape[:-1], 1)
            h = torch.cat([h, h_time.to(h.dtype)], dim=-1)
        # adjacency: valid x valid pairs within the cutoff, self-edges kept
        edge_mask = pair_mask(mask, mask)
        if cfg.edge_cutoff is not None:
            d2 = ((x[..., :, None, :] - x[..., None, :, :]) ** 2).sum(-1)
            edge_mask = edge_mask * (d2 <= cfg.edge_cutoff ** 2).to(edge_mask.dtype)
        update_coords_mask = None
        if not cfg.update_pocket_coords:
            update_coords_mask = torch.cat(
                [mask_phar, torch.zeros_like(mask_pocket)], dim=-1)
        return h, x, mask, edge_mask, update_coords_mask

    def _outputs(self, h_final, vel, mask, mask_phar, mask_pocket, decode):
        cfg = self.cfg
        n_phar = mask_phar.shape[-1]
        if cfg.condition_time:
            h_final = h_final[..., :-1]
        h_out_phar = decode(self.phar_decoder, h_final[:, :n_phar]).float()
        h_out_pocket = decode(self.residue_decoder, h_final[:, n_phar:]).float()
        # NaN guard: zero velocities if anything blew up
        vel = torch.where(torch.isnan(vel), torch.zeros_like(vel), vel)
        if cfg.update_pocket_coords:
            vel = remove_mean(vel, mask)  # joint model: CoM-free outputs
        eps_phar = torch.cat([vel[:, :n_phar], h_out_phar], dim=-1)
        eps_pocket = torch.cat([vel[:, n_phar:], h_out_pocket], dim=-1)
        return eps_phar * mask_phar[..., None], eps_pocket * mask_pocket[..., None]

    def forward(self, xh_phar, xh_pocket, t, mask_phar, mask_pocket):
        with span("denoiser"):
            return graphed_forward(self, xh_phar, xh_pocket, t, mask_phar, mask_pocket)

    def update_rows(self, xh_phar) -> Optional[int]:
        """The rows whose coordinates move: the pharmacophore rows of the
        conditional model, every row (None) of the joint one."""
        return None if self.cfg.update_pocket_coords else xh_phar.shape[-2]

    def eager_forward(self, xh_phar, xh_pocket, t, mask_phar, mask_pocket):
        """The forward pass op by op: what ``forward`` replays as a CUDA
        graph where it can, and runs where it cannot."""
        dt = self.cfg.egnn.compute_dtype

        def typed(mlp, v):
            return mlp(v, dt)

        h, x, mask, edge_mask, ucm = self._inputs(
            xh_phar, xh_pocket, t, mask_phar, mask_pocket, typed)
        nd = self.cfg.n_dims
        if self.cfg.mode == "gnn_dynamics":
            # [x ‖ h] in, [vel ‖ h] out; no update-coords mask, as the
            # reference (the conditional DDPM never reads pocket eps)
            out = self.gnn(torch.cat([x.to(h.dtype), h], dim=-1), edge_mask, mask)
            vel, h_final = out[..., :nd] * mask[..., None], out[..., nd:]
        else:
            h_final, x_final = self.egnn(h, x, edge_mask, mask, ucm, self.update_rows(xh_phar))
            vel = (x_final - x) * mask[..., None]
        return self._outputs(h_final, vel, mask, mask_phar, mask_pocket, typed)


# ---------------------------------------------------------------- CUDA graphs

# graphs a module keeps, the least recently used dropped first; a sampler
# calls with one shape, and pockets padded by pocket_pad_bucket give few
GRAPH_CAPACITY = 8


def graph_refusal(dyn: EGNNDynamics, xh_phar: torch.Tensor) -> Optional[str]:
    """Why a call of ``dyn`` runs op by op, or None where it replays a CUDA
    graph: only on the neighbor-list engine whose GCLs all take K1 and whose
    coordinate updates all take K3 (sum aggregation, the two raw edge
    scalars, outside autograd: ``models.egnn.GCL``, ``EquivariantUpdate``),
    on CUDA inputs. The dense engine stays op by op: its pair tensors are
    the memory's largest, and a graph's pool beside them would double
    them."""
    cfg = dyn.cfg
    ecfg = cfg.egnn
    if not kernel_route():
        return "autograd"
    if cfg.mode != "egnn_dynamics":
        return "gnn_dynamics"
    if ecfg.neighbor_k is None:
        return "dense engine"
    if ecfg.aggregation_method != "sum" or ecfg.sin_embedding:
        return "torch message path"
    if xh_phar.device.type != "cuda":
        return "not on CUDA"
    return None


def graph_key(dyn: EGNNDynamics, inputs: Tuple[torch.Tensor, ...]) -> tuple:
    """What a captured graph is valid for: the inputs' shapes and dtypes,
    the device, the moving rows, the float32 matmul precision and the
    parameters' storage (a parameter replaced, by ``.to()`` or a
    ``load_state_dict`` into new tensors, moves it; an in-place update does
    not, and the graph reads the updated values)."""
    return (tuple((v.shape, v.dtype) for v in inputs), inputs[0].device,
            dyn.update_rows(inputs[0]), torch.get_float32_matmul_precision(),
            tuple(p.data_ptr() for p in dyn.parameters()))


# the kernels whose wrappers count their launches (``.launches``): a replay
# adds the launches its graph holds
COUNTED_KERNELS = (gcl_message_agg, coord_update_agg)


class _Graph:
    """One captured forward pass: the graph, its static inputs and outputs,
    and the launches of each of ``COUNTED_KERNELS`` it holds."""

    def __init__(self, graph, inputs, outputs, launches: Tuple[int, ...]):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.launches = launches

    def replay(self, inputs) -> Tuple[torch.Tensor, torch.Tensor]:
        """The forward pass on ``inputs``; the outputs are the caller's."""
        for static, v in zip(self.inputs, inputs):
            static.copy_(v)
        self.graph.replay()
        for fn, n in zip(COUNTED_KERNELS, self.launches):
            fn.launches += n
        return tuple(o.clone() for o in self.outputs)


class DenoiserGraphs:
    """A module's CUDA graphs by ``graph_key``, at most ``GRAPH_CAPACITY``,
    sharing one memory pool and one capture stream; and the keys whose
    capture failed, with the error (``refused``), which stay op by op. A
    deep copy of the module (the training loop's evaluation copies) starts
    with none."""

    def __init__(self):
        self.graphs: "collections.OrderedDict[tuple, _Graph]" = collections.OrderedDict()
        self.refused: Dict[tuple, str] = {}
        self.pool = self.stream = None

    def __deepcopy__(self, memo):
        return DenoiserGraphs()

    def run(self, dyn: EGNNDynamics, inputs) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """The replayed forward pass, captured first at a new key; None
        where the key's capture failed."""
        key = graph_key(dyn, inputs)
        entry = self.graphs.get(key)
        if entry is not None:
            self.graphs.move_to_end(key)
            return entry.replay(inputs)
        if key in self.refused:
            return None
        # graphs of other parameters wait for storage that is gone; with
        # none left, the next capture starts a pool of its own
        for old in [k for k in self.graphs if k[-1] != key[-1]]:
            del self.graphs[old]
        if not self.graphs:
            self.pool = self.stream = None
        while len(self.graphs) >= GRAPH_CAPACITY:
            self.graphs.popitem(last=False)
        try:
            entry = self._capture(dyn, inputs)
        except RuntimeError as e:
            self.refused[key] = f"{type(e).__name__}: {e}"
            return None
        graphed_forward.captures += 1
        self.graphs[key] = entry
        return entry.replay(inputs)

    def _capture(self, dyn: EGNNDynamics, inputs) -> _Graph:
        """Capture ``dyn.eager_forward`` on static copies of ``inputs``: one
        call on the capture stream first (the kernels' libraries, cuBLAS's
        handle and workspace for that stream and the allocator's blocks are
        set up outside the capture), then the capture on it into the shared
        pool. The kernels' counters keep only the first call's launches: the
        captured ones have not run."""
        dev = inputs[0].device
        static = tuple(torch.empty(v.shape, dtype=v.dtype, device=dev).copy_(v) for v in inputs)
        if self.pool is None:
            self.pool, self.stream = torch.cuda.graph_pool_handle(), torch.cuda.Stream(dev)
        self.stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self.stream):
            dyn.eager_forward(*static)
        torch.cuda.current_stream(dev).wait_stream(self.stream)
        ran = tuple(fn.launches for fn in COUNTED_KERNELS)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                outputs = dyn.eager_forward(*static)
            return _Graph(graph, static, outputs,
                          tuple(fn.launches - n for fn, n in zip(COUNTED_KERNELS, ran)))
        finally:
            for fn, n in zip(COUNTED_KERNELS, ran):
                fn.launches = n


def graphed_forward(dyn: EGNNDynamics, xh_phar, xh_pocket, t, mask_phar, mask_pocket):
    """``EGNNDynamics.forward``: the forward pass replayed as a CUDA graph
    where ``graph_refusal`` allows and the capture worked, else op by op.
    Counts, as K1 counts its launches: ``captures`` (graphs captured),
    ``replays``, ``eager_calls`` and, for each, why (``eager_reasons``: a
    ``graph_refusal``, or "capture failed" for a key whose capture raised:
    ``DenoiserGraphs.refused`` keeps its error)."""
    inputs = (xh_phar, xh_pocket, t, mask_phar, mask_pocket)
    why = graph_refusal(dyn, xh_phar)
    if why is None:
        out = dyn.graphs.run(dyn, inputs)
        if out is not None:
            graphed_forward.replays += 1
            return out
        why = "capture failed"
    graphed_forward.eager_calls += 1
    graphed_forward.eager_reasons[why] += 1
    return dyn.eager_forward(*inputs)


graphed_forward.captures = 0
graphed_forward.replays = 0
graphed_forward.eager_calls = 0
graphed_forward.eager_reasons = collections.Counter()


def make_fused_apply(dynamics: EGNNDynamics) -> Callable:
    """The dynamics forward with the EGNN stack in one K2 launch
    (``ops.egnn_fused``); counterpart of the JAX package's
    ``make_pallas_apply``. The type MLPs and embeddings run in float32, as
    there. Weights are stacked once, here. Inference only. Refuses what
    ``make_pallas_apply`` refuses (the mode, ``sin_embedding``,
    ``inv_sublayers``, no ``neighbor_k``, aggregation other than sum) and a
    model without attention, whose ``att`` weights the kernel reads, as the
    JAX kernel does; and a width past the kernels' widest stack, 1024
    (``check_fused_shape``)."""
    cfg = dynamics.cfg
    ecfg = cfg.egnn
    if cfg.mode != "egnn_dynamics" or ecfg.sin_embedding:
        raise ValueError("the fused engine supports the egnn mode without sin_embedding")
    if ecfg.inv_sublayers != 1:
        raise ValueError("the fused engine supports inv_sublayers=1")
    if ecfg.neighbor_k is None:
        raise ValueError("the fused engine needs neighbor_k")
    if ecfg.aggregation_method != "sum" or not ecfg.attention:
        raise ValueError("the fused engine needs sum aggregation and attention")
    check_fused_shape(ecfg.hidden_nf, ecfg.compute_dtype)
    with torch.no_grad():
        params = fused_params(dynamics.egnn, ecfg.compute_dtype)

    def f32(mlp, v):
        return mlp.forward_f32(v)

    def apply_fn(xh_phar, xh_pocket, t, mask_phar, mask_pocket):
        with span("denoiser"):
            h, x, mask, edge_mask, ucm = dynamics._inputs(
                xh_phar, xh_pocket, t, mask_phar, mask_pocket, f32)
            h_final, x_final = egnn_forward_fused(
                params, h, x, edge_mask, mask, ucm,
                n_layers=ecfg.n_layers, neighbor_k=ecfg.neighbor_k,
                norm_constant=ecfg.norm_constant, coords_range=ecfg.coords_range,
                normalization_factor=ecfg.normalization_factor, tanh=ecfg.tanh,
                update_rows=dynamics.update_rows(xh_phar),
                compute_dtype=ecfg.compute_dtype,
            )
            return dynamics._outputs(h_final, (x_final - x) * mask[..., None], mask,
                                     mask_phar, mask_pocket, f32)

    return apply_fn
