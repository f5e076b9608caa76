"""DiffPhar training (counterpart of ``cmdgen_tpu/train/diffphar_train.py``):
AdamW with amsgrad at lr 1e-4 (``train.state.AMSGrad``), optional adaptive
gradient clipping and an EMA of the weights, validation with the loss
monitored, best and last checkpoints, and eval-epoch sampling metrics (the
sampled type histogram's KL from the training distribution, the clouds'
spread).

The training forward pass takes the model's torch path (the kernels have
no backward pass); eval-epoch sampling runs under ``no_grad`` on a copy
holding the evaluation weights (the EMA where there is one), through K1
on the neighbor-list engine or K2 with ``eval_engine="fused"``, built anew
on that copy each time.

Batch order comes from ``np.random.RandomState(seed)`` as in the JAX
package, so both packages see the same batches. The diffusion times and
noise come from a ``torch.Generator`` seeded per epoch, so a resumed run
draws what a continuous one would have drawn.

With ``dp``, ``tp`` or ``fsdp`` set, or under ``torchrun``, the run joins
the process group (``parallel.launch``; a world of one outside
``torchrun``) and trains on a ``(dp, tp)`` mesh (``parallel.mesh``; dp
None takes the world size): every rank reads the same batches and draws,
keeps its rows (``train.state``), and a step equals the single-process
step on the global batch. Validation, eval-epoch sampling and logging run
on rank 0, on whole weights gathered into an unsharded copy that only
rank 0 builds (from a template on the ``meta`` device); rank 0
writes checkpoints of whole arrays in the single-process format, so
``sample-phars`` reads them and a resume may change the world size or
the layout (the arrays are loaded whole, then sharded).
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from cmdgen_tpu_torch import config as cfgmod
from cmdgen_tpu_torch import convert
from cmdgen_tpu_torch.chem.constants import DATASET_PARAMS
from cmdgen_tpu_torch.chem.metrics import categorical_kl
from cmdgen_tpu_torch.containers import PointCloud
from cmdgen_tpu_torch.data.dataset import DiffPharDataset
from cmdgen_tpu_torch.data.prefetch import prefetch
from cmdgen_tpu_torch.device import DeviceLike, resolve_device
from cmdgen_tpu_torch.diffusion.cddpm import ConditionalDDPM
from cmdgen_tpu_torch.diffusion.joint import JointDDPM
from cmdgen_tpu_torch.diffusion.size_prior import SizePrior
from cmdgen_tpu_torch.models.dynamics import EGNNDynamics, make_fused_apply
from cmdgen_tpu_torch.models.egnn import EquivariantBlock
from cmdgen_tpu_torch.models.init import init_dynamics_, init_gamma_net_
from cmdgen_tpu_torch.parallel import launch
from cmdgen_tpu_torch.parallel import mesh as pmesh
from cmdgen_tpu_torch.train import checkpoint as ckpt
from cmdgen_tpu_torch.train import state as tstate


def build_model(cfg: cfgmod.DiffPharConfig, size_histogram: Optional[np.ndarray] = None,
                device: DeviceLike = None, generator: Optional[torch.Generator] = None):
    """The DDPM of ``cfg`` on ``device`` (default ``cuda``) with fresh
    weights from flax's initializers drawn from ``generator`` (a CPU
    generator; seed 0 when None), and the size prior of
    ``size_histogram``: a ``JointDDPM`` for ``train.mode="joint"``."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    dynamics = EGNNDynamics(cfg.dynamics)
    init_dynamics_(dynamics, gen)
    dynamics = dynamics.to(dev)
    prior = None if size_histogram is None else SizePrior(size_histogram, dev)
    if cfg.train.mode == "joint":
        if not cfg.dynamics.update_pocket_coords:
            raise ValueError("joint mode needs dynamics.update_pocket_coords")
        model = JointDDPM(cfg.ddpm, dynamics, size_prior=prior)
    else:
        model = ConditionalDDPM(cfg.ddpm, dynamics, size_prior=prior)
    if model.gamma_net is not None:
        init_gamma_net_(model.gamma_net, gen)
    return model


def to_clouds(batch: Dict[str, np.ndarray], device) -> tuple:
    """A padded batch dict -> (phar, pocket) PointClouds on ``device``."""
    def t(k):
        return torch.from_numpy(np.asarray(batch[k])).to(device)

    return (PointCloud(x=t("phar_x"), h=t("phar_h"), mask=t("phar_mask")),
            PointCloud(x=t("pocket_x"), h=t("pocket_h"), mask=t("pocket_mask")))


@torch.no_grad()
def evaluate(model, dataset: DiffPharDataset, batch_size: int,
             generator: Optional[torch.Generator] = None, max_batches: int = 10) -> float:
    """Mean validation NLL (the vlb, ``training=False``) over up to
    ``max_batches`` batches in dataset order."""
    losses = []
    batches = dataset.iter_batches(batch_size, np.random.RandomState(0), shuffle=False,
                                   drop_last=False)
    for i, batch in enumerate(batches):
        if i >= max_batches:
            break
        phar, pocket = to_clouds(batch, model.device)
        nll, _ = model.loss(phar, pocket, training=False, generator=generator)
        losses.append(nll.mean())
    return float(torch.stack(losses).mean()) if losses else float("nan")


@torch.no_grad()
def sampling_metrics(model, dataset: DiffPharDataset, generator: Optional[torch.Generator] = None,
                     n_samples: int = 16, dataset_name: str = "crossdock_full"
                     ) -> Dict[str, float]:
    """Sample clouds for the first ``n_samples`` pockets of ``dataset`` at
    their own pharmacophore sizes: the KL of the sampled type histogram
    from the training one (``kl_types``) and the clouds' mean largest
    pairwise distance (``spread_gen``)."""
    batch = dataset.padded_batch(list(range(min(n_samples, len(dataset)))))
    phar, pocket = to_clouds(batch, model.device)
    nn_ = phar.size.long().clamp_min(1)
    out, _ = model.sample_given_pocket(pocket, nn_, dataset.n_phar_max, generator=generator)
    h = out.h.cpu().numpy()
    mask = out.mask.cpu().numpy() > 0.5
    hist = np.bincount(h[mask].argmax(-1), minlength=h.shape[-1])
    ref_hist = np.asarray(list(DATASET_PARAMS[dataset_name]["phar_hist"].values()),
                          dtype=float)[: h.shape[-1]]
    x = out.x.cpu().numpy()
    spreads = []
    for s in range(x.shape[0]):
        pts = x[s][mask[s]]
        if len(pts) > 1:
            spreads.append(float(np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1)).max()))
    return {"kl_types": categorical_kl(hist, ref_hist),
            "spread_gen": float(np.mean(spreads)) if spreads else float("nan")}


def eval_model(state: tstate.TrainState, engine: str = "msgpass"):
    """The evaluation copy of the model (``train.state.eval_model``: None
    on a sharded model's ranks past 0), with K2's engine built on it for
    ``engine="fused"``."""
    if engine not in ("msgpass", "fused"):
        raise ValueError(f"unknown engine {engine!r}")
    model = tstate.eval_model(state)
    if model is not None and engine == "fused":
        model._apply = make_fused_apply(model.dynamics)
    return model


def checkpoint_payload(state: tstate.TrainState) -> Dict[str, Dict[str, np.ndarray]]:
    """params, opt_state and (where kept) ema_params as flax-layout arrays."""
    model = state.model
    payload = {"params": convert.model_leaves(model),
               "opt_state": convert.optimizer_arrays(model, state.optimizer)}
    if state.ema is not None:
        payload["ema_params"] = convert.model_leaves(model, state.ema)
    return payload


def shard_model(model, mesh, fsdp: bool = False) -> pmesh.MeshPlan:
    """Lay the model's dynamics out on ``mesh``, in place: eligible Dense
    layers column-split over ``tp``, then, with ``fsdp``, FSDP2 over
    ``dp`` with each EGNN block its own unit. The gamma network stays
    replicated (its gradient averaged over dp). Returns the step's plan."""
    pmesh.tp_shard(model.dynamics, mesh)
    if fsdp:
        pmesh.fsdp_shard(model.dynamics, mesh, blocks=(EquivariantBlock,))
    return pmesh.MeshPlan(mesh)


def epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The generator of one epoch's times, noise and evaluation draws."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + epoch)


def train_diffphar(cfg: cfgmod.DiffPharConfig, datadir, out_dir,
                   max_steps: Optional[int] = None,
                   log_fn: Callable[[int, Dict], None] = lambda step, m: None,
                   resume_from=None, device: DeviceLike = None,
                   eval_engine: str = "msgpass"):
    """Train DiffPhar on ``datadir``'s ``train.npz`` (validating on
    ``val.npz``; the size prior from ``size_distribution.npy`` where there
    is one), writing checkpoints to ``out_dir``. Returns the final
    ``TrainState``.

    ``resume_from``: a run directory whose ``last`` checkpoint restarts
    training: weights, optimizer state and EMA (seeded from the weights
    where the checkpoint has none; dropped for a run without EMA), its
    step, and the epochs it covered skipped with their batch-order draws
    replayed. ``eval_engine``: the engine of eval-epoch sampling. Under a
    mesh ``device`` names the device type (rank r of ``torchrun`` takes
    ``cuda:LOCAL_RANK``) and the returned state is this rank's."""
    tc = cfg.train
    mesh, rank0 = None, True
    if tc.fsdp or tc.dp is not None or tc.tp > 1 or launch.under_torchrun():
        world = launch.init_process_group(device)
        dev, rank0 = world.device, world.rank == 0
        mesh = pmesh.make_mesh(tc.dp, tc.tp, dev.type)
    else:
        dev = resolve_device(device)
    if not rank0:
        log_fn = lambda step, m: None  # noqa: E731 -- rank 0 logs
    datadir, out_dir = Path(datadir), Path(out_dir)
    train_ds = DiffPharDataset(datadir / "train.npz")
    val_ds = DiffPharDataset(datadir / "val.npz")
    hist_path = datadir / "size_distribution.npy"
    size_hist = np.load(hist_path) if hist_path.exists() else None

    model = build_model(cfg, size_hist, dev, torch.Generator().manual_seed(tc.seed))
    # the noise floor at t=0 must not straddle one normalized one-hot unit
    model.check_norm_values()
    start_step, start_epoch = 0, None
    if resume_from is not None:
        payload, meta = ckpt.load_checkpoint(resume_from, "last")
        convert.load_leaves(model, payload["params"])  # whole, before sharding
    plan = template = None
    if mesh is not None:
        template = tstate.unsharded_template(model)
        plan = shard_model(model, mesh, tc.fsdp)
    optimizer = tstate.reference_optimizer(model.parameters(), tc.lr)
    state = tstate.init_state(model, optimizer, ema=tc.ema_decay > 0, plan=plan,
                              template=template)
    train_step = tstate.make_diffusion_train_step(tc.clip_grad, tc.ema_decay)
    if resume_from is not None:
        convert.load_optimizer_arrays(model, optimizer, payload["opt_state"])
        if tc.ema_decay > 0:
            # from the restored weights where the checkpoint has no EMA,
            # never from the fresh initialisation
            ema = convert.leaves_to_tensors(model, payload.get("ema_params", payload["params"]))
            params = dict(model.named_parameters())
            state.ema = {n: pmesh.shard_like(t, params[n]) for n, t in ema.items()}
        else:
            state.ema = None  # a run without EMA must not evaluate a stale one
        state.step = start_step = int(meta["step"])
        start_epoch = meta.get("epoch")

    bs = tc.batch_size
    nb0 = max(1, len(train_ds) // bs)
    np_rng = np.random.RandomState(tc.seed)
    step = 0
    val_loss = float("nan")
    t0 = time.time()
    for epoch in range(tc.n_epochs):
        if resume_from is not None and (
                epoch < start_epoch if start_epoch is not None
                else step + nb0 <= start_step):
            # covered by the checkpoint: replay the epoch's batch-order draw
            np_rng.shuffle(np.arange(len(train_ds)))
            step += nb0
            continue
        gen = epoch_generator(tc.seed, epoch, dev)
        metrics = None
        for batch in prefetch(train_ds.iter_batches(bs, np_rng)):
            metrics = train_step(state, *to_clouds(batch, dev), generator=gen)
            step += 1
            if step % 50 == 0:
                log_fn(step, {k: float(v) for k, v in metrics.items()})
            if max_steps and step >= max_steps:
                break
        stop = bool(max_steps and step >= max_steps)
        last = epoch + 1 == tc.n_epochs or stop
        ckpt_now = (epoch + 1) % max(1, tc.ckpt_epochs) == 0 or last
        val_now = (epoch + 1) % max(1, tc.val_epochs) == 0
        sample_now = (tc.eval_epochs and (epoch + 1) % tc.eval_epochs == 0
                      and isinstance(model, ConditionalDDPM))
        if val_now or ckpt_now or sample_now:
            em = eval_model(state, eval_engine)  # every rank gathers; rank 0 gets the copy
            if val_now or ckpt_now:
                val_loss = evaluate(em, val_ds, bs, gen) if rank0 else 0.0
                if mesh is not None:  # rank 0's number on every rank
                    box = [val_loss]
                    dist.broadcast_object_list(box, src=0)
                    val_loss = box[0]
                log_fn(step, {"loss/val": val_loss, "epoch": epoch,
                              "elapsed_s": time.time() - t0})
            if sample_now and rank0:
                sm = sampling_metrics(em, val_ds, gen, n_samples=min(tc.n_eval_samples, 16),
                                      dataset_name=cfg.data.dataset)
                log_fn(step, {f"sampling/{k}": v for k, v in sm.items()})
            del em
        if ckpt_now:
            payload = checkpoint_payload(state)  # every rank: the arrays are gathered
            if rank0:
                ckpt.save_checkpoint(out_dir, payload, step=step, config=cfgmod.to_dict(cfg),
                                     monitor_value=val_loss, epoch=epoch + 1)
            if mesh is not None:
                dist.barrier()
        if stop:
            break
    return state
