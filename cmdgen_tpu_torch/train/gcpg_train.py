"""GCPG training (counterpart of ``cmdgen_tpu/train/gcpg_train.py``): the loss
LM + beta * KL + the weighted mapping BCE, the 3-phase KL-beta annealer,
the per-type rarity weights of the mapping head, the condition gate
([1,1,1,1,1,0,0]; score-only [0,0,0,0,0,1,0] for the docking finetune),
AdamW with a cosine learning rate and clipping of the global norm at 5.

``gcpg_optimizer`` is ``optax.adamw(cosine_decay_schedule(lr, T),
weight_decay=1e-6)``: the schedule is read at the count before each step
and clamps at T = ``cosine_t_max`` epochs, after which the learning rate
stays 0 (PyTorch's ``CosineAnnealingLR`` would rise again).

The model trains in ``train()`` mode (dropout on, drawn from the epoch's
generator) and is put in ``eval()`` mode for in-training generation.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from cmdgen_tpu_torch import convert
from cmdgen_tpu_torch.chem.tokenizer import Tokenizer, gen_vocabs
from cmdgen_tpu_torch.config import GCPGModelConfig, GCPGTrainConfig, to_dict
from cmdgen_tpu_torch.data.dataset import GCPGSmilesDataset
from cmdgen_tpu_torch.data.prefetch import prefetch
from cmdgen_tpu_torch.device import DeviceLike, resolve_device
from cmdgen_tpu_torch.models.gcpg import GCPG
from cmdgen_tpu_torch.models.init import init_gcpg_
from cmdgen_tpu_torch.models.transformer import set_dropout_generator
from cmdgen_tpu_torch.train import checkpoint as ckpt
from cmdgen_tpu_torch.train.state import AdamW, clip_by_scale, cosine_decay, global_norm

# the dataset's property rows [MW, logP, QED, SAS, HBA, HBD, RotaNumBonds,
# Score, Smi] -> the model's 7 conditions (HBA and HBD are never conditioned on)
COND_IDX = np.asarray([0, 1, 2, 3, 6, 7, 8])

# rarity weights per pharmacophore type (train_chembl33_baseline.py:39-40)
PP_TYPE_WEIGHT = (
    1.4891304347826086, 1.0, 8.058823529411764, 1.0378787878787878,
    1.8026315789473686, 2.174603174603175, 17.125,
)

FINETUNE_GATE = (0, 0, 0, 0, 0, 1, 0)  # score-only (finetune_docking_epoch1.py:154)


def gen_beta(start: float, end: float, t1: int, t2: int, t3: int) -> Iterator[float]:
    """3-phase KL-beta annealer: hold, log-ramp, linear ramp, hold."""
    for _ in range(t1):
        yield start
    log_s, log_e = np.log(start), np.log(end)
    at = t3 - t1
    cur = start
    for i in range(t2 - t1):
        cur = float(np.exp(log_s + (log_e - log_s) / at * i))
        yield cur
    t = t3 - t2
    delta = (end - cur) / t
    for _ in range(t):
        cur += delta
        yield cur
    while True:
        yield end


def default_beta_schedule(cfg: GCPGTrainConfig) -> Iterator[float]:
    return gen_beta(cfg.kl_beta_min, cfg.kl_beta_max, 6, 18, 24)


def mapping_bce(mapping_scores: torch.Tensor, mappings: torch.Tensor,
                pp_type: torch.Tensor) -> torch.Tensor:
    """Weighted mapping BCE. mapping_scores [B, S, 8] sigmoid outputs;
    mappings [B, S, 8] targets in {0, 1}, -100 = ignore; pp_type [B, 8, 7]
    type one-hots (for the rarity weights)."""
    w_type = torch.tensor(PP_TYPE_WEIGHT, dtype=torch.float32, device=pp_type.device)
    sample_weight = pp_type @ w_type  # [B, 8]
    is_pos = (mappings == 1.0).float()
    is_valid = (mappings != -100.0).float()
    pos_count = is_pos.sum(1, keepdim=True)  # [B, 1, 8]
    weight = is_pos * (8.0 / (0.001 + pos_count)) + is_valid * sample_weight[:, None, :]
    target = mappings.clamp(0.0, 1.0)
    p = mapping_scores.clamp(1e-7, 1 - 1e-7)
    bce = -(target * torch.log(p) + (1 - target) * torch.log(1 - p))
    return (weight * bce).mean()


def gcpg_optimizer(model: GCPG, cfg: GCPGTrainConfig, steps_per_epoch: int = 1000) -> AdamW:
    """AdamW(weight_decay=1e-6) on the cosine decay over cosine_t_max epochs."""
    return AdamW(model.parameters(),
                 cosine_decay(cfg.lr, max(cfg.cosine_t_max * steps_per_epoch, 1)),
                 weight_decay=1e-6)


def make_gcpg_train_step(condition_gate: Tuple[int, ...], grad_clip: float = 5.0):
    """step(model, optimizer, batch, beta, generator=None, eps=None) ->
    metrics: one optimizer step on LM + beta * KL + mapping BCE, the
    gradient clipped to global norm ``grad_clip``. ``batch``: tensors on
    the model's device (``GCPGSmilesDataset.padded_batch``'s keys);
    ``eps`` [B, H], the posterior's standard-normal draw, replaces the draw
    from ``generator``. Metrics are detached tensors."""
    gate = torch.tensor(condition_gate, dtype=torch.float32)
    cond_idx = torch.from_numpy(COND_IDX)

    def step(model: GCPG, optimizer: AdamW, batch: Dict[str, torch.Tensor], beta: float,
             generator: Optional[torch.Generator] = None,
             eps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        dev = batch["props"].device
        params = list(model.parameters())
        for p in params:
            p.grad = None
        conds = batch["props"][:, cond_idx.to(dev)] * gate.to(dev)[None, :]
        _, scores, lm, kl = model(batch["inputs"], batch["input_valid"], batch["pp_h"],
                                  batch["pp_e"], batch["pp_mask"], batch["targets"], conds,
                                  eps=eps, generator=generator)
        mp = mapping_bce(scores, batch["mapping"], batch["pp_h"][..., :7])
        total = lm + kl * beta + mp
        total.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        gnorm = global_norm(grads)
        scaled = clip_by_scale(grads, torch.clamp(grad_clip / (gnorm + 1e-12), max=1.0))
        for p, g in zip(params, scaled):
            p.grad = g
        optimizer.step()
        return {"loss": total.detach(), "lm_loss": lm.detach(), "kl_loss": kl.detach(),
                "mapping_loss": mp.detach(), "grad_norm": gnorm.detach()}

    return step


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A padded batch dict as tensors on ``device``: ids int64, the rest float32."""
    ints = ("inputs", "targets")
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.long if k in ints else torch.float32,
                               device=device) for k, v in batch.items()}


def resident_batch(data: Dict[str, torch.Tensor], rows: torch.Tensor, pad_id: int):
    """One batch gathered from ``stacked_variants`` arrays on the device,
    back at full precision (``input_valid`` = inputs != PAD)."""
    inputs = data["inputs"][rows].long()
    return {"inputs": inputs, "input_valid": (inputs != pad_id).float(),
            "targets": data["targets"][rows].long(), "pp_h": data["pp_h"][rows],
            "pp_e": data["pp_e"][rows], "pp_mask": data["pp_mask"][rows],
            "mapping": data["mapping"][rows].float(), "props": data["props"][rows]}


def _finetune_dir(path) -> Path:
    """A run directory's ``last/``, or a checkpoint directory itself."""
    path = Path(path)
    return path / "last" if (path / "last" / "params.npz").exists() else path


def train_gcpg(model_cfg: GCPGModelConfig, train_cfg: GCPGTrainConfig,
               smiles_list: Sequence[str], properties: Dict, out_dir,
               val_smiles: Optional[Sequence[str]] = None, max_steps: Optional[int] = None,
               finetune_from=None, log_fn: Callable[[int, Dict], None] = lambda step, m: None,
               gen_eval_every: int = 0, gen_eval_n: int = 32, device: DeviceLike = None):
    """Train the GCPG on ``smiles_list`` (with ``properties``, the dataset's
    property columns), writing checkpoints with the tokenizer to
    ``out_dir``. ``finetune_from``: a port GCPG checkpoint (or run
    directory, for its ``last/``) whose model config, whole weights
    (``read_port_gcpg`` with the training modules) and tokenizer start the
    run, with a fresh AdamW state (a token outside its vocabulary reads as
    ``<mask>``): a fine-tune keeps its checkpoint's architecture, and
    ``model_cfg`` is not read then. ``gen_eval_every``: epochs between
    in-training generation evals (``pipeline.evaluate.eval_gcpg`` on
    ``val_smiles``). Without ``max_steps`` a corpus whose pre-drawn
    variants fit 1.5 GB trains from rows on the device
    (``resident_data``). Returns (model, tokenizer)."""
    dev = resolve_device(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if finetune_from is not None:
        model_cfg, tokenizer, leaves = convert.read_port_gcpg(_finetune_dir(finetune_from),
                                                              with_training=True)
    else:
        tokenizer = Tokenizer(gen_vocabs(smiles_list))
    data = GCPGSmilesDataset(smiles_list, properties, tokenizer, max_len=model_cfg.max_len,
                             use_random_input_smiles=True, corrupt=True, seed=train_cfg.seed,
                             consensus_noise=train_cfg.consensus_noise)
    model = GCPG(model_cfg, len(tokenizer))
    init_gcpg_(model, torch.Generator().manual_seed(train_cfg.seed))
    model = model.to(dev).train()
    if finetune_from is not None:
        convert.load_leaves(model, leaves)
    bs = train_cfg.batch_size
    steps_per_epoch = max(len(data) // bs, 1)
    optimizer = gcpg_optimizer(model, train_cfg, steps_per_epoch)
    step_fn = make_gcpg_train_step(train_cfg.condition_gate, train_cfg.grad_clip)

    # the JAX package draws one batch to initialise its model: the same
    # draw keeps the dataset's random streams, and so the batches, in step
    if next(data.iter_batches(min(bs, len(data))), None) is None:
        raise ValueError("no valid training molecules")

    n_variants = train_cfg.resident_variants
    est_bytes = len(data) * n_variants * (
        model_cfg.max_len * (2 + 2 + 8) + 8 * 8 * 4 * 2 + 8 * 4 + 9 * 4)
    resident = max_steps is None and (
        train_cfg.resident_data == "on"
        or (train_cfg.resident_data == "auto" and est_bytes <= (3 << 29)))
    stacked = data.stacked_variants(n_variants) if resident else None
    if stacked is not None:
        resident_data = {k: torch.from_numpy(v).to(dev) for k, v in stacked.items()}
        n_rows = int(stacked["inputs"].shape[0])
        idx_rng = np.random.RandomState(train_cfg.seed + 1)

    beta_it = default_beta_schedule(train_cfg)
    config = {"model": to_dict(model_cfg), "train": to_dict(train_cfg),
              "tokenizer": tokenizer.to_list()}
    step = 0
    for epoch in range(train_cfg.n_epochs):
        beta = next(beta_it)
        gen = torch.Generator(device=dev).manual_seed(train_cfg.seed * 1_000_003 + epoch)
        set_dropout_generator(model, gen)
        losses = []
        if stacked is not None:
            idx = idx_rng.randint(0, n_rows, size=(steps_per_epoch, bs))
            for rows in torch.from_numpy(idx).to(dev):
                metrics = step_fn(model, optimizer, resident_batch(
                    resident_data, rows, tokenizer.PAD), beta, generator=gen)
                losses.append(metrics["loss"])
                step += 1
            log_fn(step, {k: float(v) for k, v in metrics.items()})
        else:
            for batch in prefetch(data.iter_batches(bs)):
                metrics = step_fn(model, optimizer, batch_to_device(batch, dev), beta,
                                  generator=gen)
                losses.append(metrics["loss"])  # on the device: no sync per step
                step += 1
                if step % 100 == 0:
                    log_fn(step, {k: float(v) for k, v in metrics.items()})
                if max_steps and step >= max_steps:
                    break
        mean_loss = float(torch.stack(losses).mean()) if losses else float("nan")
        log_fn(step, {"epoch": epoch, "beta": beta, "loss/train": mean_loss})
        if gen_eval_every and (epoch + 1) % gen_eval_every == 0:
            from cmdgen_tpu_torch.pipeline.evaluate import eval_gcpg

            model.eval()
            ev = eval_gcpg(model, tokenizer, val_smiles or smiles_list, n_molecules=gen_eval_n,
                           match_workers=1, generator=gen)
            model.train()
            log_fn(step, {f"gen/{k}": v for k, v in ev.items() if isinstance(v, (int, float))})
        last_epoch = epoch == train_cfg.n_epochs - 1 or bool(max_steps and step >= max_steps)
        if epoch % train_cfg.save_freq != 0 and not last_epoch:
            continue
        ckpt.save_checkpoint(out_dir, {"params": convert.model_leaves(model),
                                       "opt_state": convert.optimizer_arrays(model, optimizer)},
                             step=step, config=config, monitor_value=mean_loss, epoch=epoch + 1)
        if max_steps and step >= max_steps:
            break
    return model.eval(), tokenizer
