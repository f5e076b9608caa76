#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``cmdgen_tpu_torch``) on one GPU.

  python3 chip_smoke.py [--timesteps 500] [--kernels-only]

Run from the repository root on a machine with an NVIDIA Hopper GPU and
``nvcc``. It

1. builds every CUDA kernel of the port from ``cmdgen_tpu_torch/csrc``;
2. holds each kernel's wrapper against its plain PyTorch version at the
   flagship shape (B=48, N=8+110, K=12, H=256, 5 layers), in float32 and
   bfloat16, and times both (CUDA events) beside the card's bound for the
   work; for each also the kernel alone (``kernel_ms``: for K1 without the
   wrapper's checks and casts, for K2 without its neighbor list and
   embeddings), the grid it launched, and a bf16 run at B=132; K1's
   stages' shares of block 0's clock over its tiles, K2's phases' shares of
   one launch and the bf16 versions' distance from the float32 one; and
   K3, the coordinate update on the neighbor list, against its plain
   version in float32 at the joint cell's shape (B=64, N=16+110, every row
   moving, K=12) and the full-atom one's (B=16, N=16+506, 16 rows moving,
   K=160), and in bf16 at the flagship sampling's (B=48, N=8+110, 8 rows
   moving) and the joint phase's (B=48, every one of the 118 rows moving)
   on the mma.sync and the block_gemm routes, with seeded faults the
   comparison must catch, the wrapper, the kernel alone and the plain
   version timed;
3. samples pharmacophores at the flagship CA configuration (hidden 256,
   5 layers, K=12, bf16, random weights from a seed) through
   ``ConditionalDDPM.sample_given_pocket`` with the msgpass engine (K1 in
   every GCL) and the fused engine (K2), counting kernel launches, then
   profiles a few steps of each (``torch.profiler``: the device's busy
   share of the wall time and the kernels that take most of it);
4. runs the ``sample-phars`` CLI entry on the trained ``qrun_aa`` weights
   and a synthetic CA pocket, and holds the trained denoiser on the card
   against the same denoiser on the CPU;
5. the consensus stage: samples 1,024 clouds from ``qrun_aa`` (msgpass
   engine, K1 counted, T=100, clamp 8), runs ``get-phar`` through the CLI
   in every method (GMM, KMeans, DBSCAN) and mode (dual-target GMM, DBSCAN
   and per-molecule, against the cloud moved by a known rigid motion less
   every 10th molecule; selectivity) on them, each method's first call
   and one warm call timed between two synchronizes, checks the output
   files, recovers the motion with ``register_clouds`` (its multi-start
   ICP), and holds the clustering and Kabsch functions on the card
   against the CPU with the same explicit initialisation;
6. holds stage 1's other options (``sin_embedding``, the GNN mode, the
   learned noise schedule) on the card against the CPU at the flagship
   widths in float32, and the chain sampler (the reference's: ancestral
   whatever ``ddim_eta`` is) on the card against the CPU, and under
   ``ddim_eta`` against the ancestral chain, bit for bit;
   Then the ``widths`` phase (``widths_phase``): K1 and K2 against their
   plain versions at the flagship geometry at float32 H=100, 192, 384 and
   bf16 H=48, 320, 384, each timed beside the same kernel at the next
   width it took before every width was (float32 128, 256, 512; bf16 64;
   K2 at bf16 past 256: its H=256 time scaled by (H/256)^2), both routes at
   bf16 H=256, and at the cutoff-exact full-atom shape (16 samples of
   16 + 506 rows, K=160, H=256, float32, 3 layers); K2's bf16
   displacement is held by fixed limits (BF16_DX_LIMITS) to the bf16 and
   the float32 plain versions, beside the readings of seeded faults; then
   ``sample_given_pocket`` at B=48, T=10 through both engines on seeded
   ``ca_config`` models of hidden 192 (float32) and 384 (bf16), launches
   counted and the first denoiser call card vs CPU on all 48 samples
   (bf16: against the CPU's bf16 and float32 denoisers,
   BF16_DENOISER_LIMITS);
7. stage 3, GCPG decode: the trained ``grun_r5cn`` weights decode the
   consensus phase's GMM hypothesis at B=512 (run-all's decode batch),
   sampled at T=1, unconstrained, constrained and with the valence state
   machine (first call timed apart from a warm one; decode positions/s,
   valid SMILES/s, validity, uniqueness), and its validity with the valence
   state machine at T=0.7; the default ``GCPGModelConfig()``
   width with seeded random weights, timed; card against CPU at B=16 at
   both widths (teacher-forced logits, greedy and sampled tokens on the same
   Gumbel noise, rows apart only at counted near ties); a profile of one
   warm decode; the ``generate`` CLI once through;
8. stage 4, alignment: the unique valid SMILES of step 7's decode with the
   valence state machine at T=0.7, matched to its hypothesis and aligned
   at run-all's settings (5 conformers, 100 refinement steps, chunks of 64
   molecules, 16-atom buckets; first chunk timed apart from the warm ones,
   conformers/s, matched, aligned, dropped conformers, the medians of the
   best RMSD and of its bounds violation); ``align_entries`` on one chunk
   on the card against the CPU with the same draws; a warm chunk
   profiled at 100 and at 0 refinement steps (busy share, device ops per
   refinement step); the ``align`` CLI once through, its SDFs and
   ``rmsd_values.npy`` checked;
9. ``run-all`` through the CLI on ``qrun_aa`` + ``grun_r5cn`` and two
   synthetic pockets at round 5's settings cut to the time limit (256
   decodes per hypothesis, not 2,048; 1 pocket, not 8): first K1 and K2
   at the shapes run-all gives them (64 clouds of 8 node slots, 5 used;
   the pocket padded to 48 rows; H=128, K=16, float32), recorded from its
   sampler's call at three steps of the chain, each wrapper call against
   its plain version and the denoiser through each against the CPU, and
   timed; then run-all once with the msgpass engine, once more with
   ``--keep-top-match 0.25``, once with ``--engine fused``; each run's
   stats, validity, aligned molecules/min and kernel launches (K1 303 per
   pocket, K2 101), every written SDF parsed, every RMSD finite, aligned >
   0 and validity >= 0.5;
10. evaluation (between steps 8 and 9): ``eval-diffphar`` with ``qrun_aa``
   (T=100, unclamped) on a synthetic test set of 8 complexes in
   ``DiffPharDataset``'s format, ``eval-gcpg`` with ``grun_r5cn`` on 128 of
   step 8's SMILES, ``align --pose-pdbs`` on pose PDBs of 16 of step 8's
   posed molecules, each through the CLI with its metrics and wall time;
   ``eval_alignment_rmsd_posed`` on those poses, card against CPU on the
   same draws (the same poses fail, RMSDs within 1e-3 Å);
11. the joint model at full width (``ca_config`` with ``train.mode="joint"``
   and ``update_pocket_coords``: hidden 256, 5 layers, K=12, bf16, seeded
   weights; a 110-CA pocket, 8 pharmacophore slots, B=48):
   ``sample_pharmacophores``' joint branch (RePaint with the pocket fixed)
   at T=``--timesteps`` on both engines, launches counted (K1 2,505, K2 501
   at T=500), steps/s and a profile; every K1 and K2 call at three recorded
   steps against its plain version (K2 with every row moving) and the
   middle step's timed; in float32 the denoiser and a T=10 inpaint chain,
   card against CPU; ``sample-phars`` on a joint port checkpoint through
   the CLI;
12. training (between steps 10 and 9), ``train_phase``: DiffPhar at
   ``ca_config``'s width (float32) on synthetic complexes, one train step
   card vs CPU (dense and K=12: loss terms, every gradient, the weights
   after it; K1 launched 0 times, edge_in, edge_out and att with
   gradients), warm steps timed and profiled (dense and K=12 at B=4 and
   32), 50 steps on one batch, ``train-diffphar`` through the CLI and
   ``train_diffphar`` with K=12, EMA and eval sampling (K1 5 x 501 times
   per sampling call, its calls there against their plain versions and
   timed), ``sample-phars`` on the trained ``best/``; the GCPG at its
   default width on step 7's SMILES: one step card vs CPU, ``train-gcpg``
   through the CLI (B=128), steps timed, ``generate`` from its checkpoint;
   ``train-gcpg --finetune-from cmdgen_tpu_torch/assets/grun_r5cn
   --score-only-gate`` on the same SMILES (3 steps at B=128), its first step
   starting from the shipped weights array for array, ``generate`` from it;
13. data parallelism and FSDP (after step 12), ``parallel_phase``: the
   align phase's posed molecules in synthetic pockets of 80-130 residues
   (a CA and a side-chain tip within 8 A of the ligand each, so that
   every residue reaches the model, as in step 12) written as 80 PDB/SDF
   pairs and turned into npz files by ``preprocess`` through the CLI; a
   world of one under NCCL on the card;
   ``ca_config`` with K=12 from seeded weights, 5 steps at B=32 on that
   data as the plain trainer, the dp path and FSDP, on the same batches
   and draws (each one's largest gap from the plain trainer against its
   limit); ``train_diffphar`` with FSDP, EMA and one eval epoch (K1 5 x
   501 times in its sampling) and ``train-diffphar --fsdp`` through the
   CLI; ``sample-phars`` with both engines on the FSDP run's checkpoint;
   the K1 calls of three denoiser calls of the eval sampling and of
   ``sample-phars``, and K2's first call, as that run made them, against
   their plain versions;
   a few sampling steps in ``utils.profiling.device_trace``, the trace
   naming K1's kernel once per launch; receptor and ligand PDBQT of
   posed molecules, scored with qvina2 only where its binary is found.
14. the CLI's default DiffPhar configuration (after step 13),
   ``full_atom_phase``: ``full_atom_config`` at its full width (hidden 256,
   3 layers, 11 element classes, T=100, float32) on the align phase's posed
   molecules in synthetic full-atom pockets (backbone and side-chain heavy
   atoms, 150-512 a pocket): ``preprocess``, ``train-diffphar`` and
   ``sample-phars`` at their defaults (dense, B=8 training, B=64 sampling;
   5 steps, T cut to 4), each train step timed with its peak memory and
   the last profiled; dense sampling on pockets of ~190, ~350 and ~510
   atoms (peak memory by size); K1 (``--neighbor-k 16``) and K2
   (``--engine fused``) on the largest, their calls there against their
   plain versions and timed.

Prints the card, a ``kernels`` JSON line (K3's entry: its checks and
times at its four shapes, ``launches`` and ``launches_by_path`` as K1's;
K1's and K2's: ``launches``, ``ms``,
``plain_ms``, ``bound_ms``: the train path's, K1 in its eval sampling and
K2 in ``sample-phars --engine fused`` on its checkpoint, times at the eval
sampling's shape, ``train_shape`` with ``kernel_ms`` there;
``run_all_shape``: run-all's; ``flagship``: step 2's bf16 times;
``joint``: step 11's; ``launches_by_path``: every path's, step 13's
under ``parallel`` and step 14's under ``full_atom``; step 13's checks
under ``parallel_path``; ``full_atom_shape``: step 14's checks and times;
``widths``: the widths phase's), a ``widths`` JSON line (its sampling runs),
the throughput, a ``consensus`` JSON line, a ``decode`` JSON line, an
``align`` JSON line, a ``run_all`` JSON line, an ``evaluate``, a
``joint``, a ``train``, a ``parallel`` and a ``full_atom`` JSON line, the
card's name and power limit, and as the last line ``{"ok": true,
"device": {...}}``. Any failure raises (exit code != 0).
Without CUDA it exits with code 1 before printing any result.
``--kernels-only`` stops after step 2 and prints the checks as one JSON
line (no ``ok`` line): the quick way to compare two trees' kernels. Such
a run drives no main path and counts no launches, so it never stands for
the full run.

K1's and K3's launches are counted as kernels run (``launch_counts``):
the module replays its forward pass as a CUDA graph on the msgpass engine
(``models.dynamics``), and a sampling run expects each GCL (K1) and each
block's coordinate update (K3) once a denoiser call and once more for each
graph captured in it (``k1_want``: its op-by-op pass before the capture;
``launches_want``); a training step launches neither.
Where the calls into K1 are kept for their checks (``kernel_calls_kept``)
the module runs op by op, so that each call passes through the wrapper.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores and float32
# outside the tensor cores; device memory bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# stated tolerances of kernel vs plain version, each compared quantity on
# its own: max_abs_err <= rel * max|ref|. float32 differs by summation order
# only. bfloat16: K1's agg within one bf16 step of its largest value; K2's h
# and displacement dx at about 3x the largest relative error read on an H100
# (PERF.md), where the tensor cores' f32 summation order flips rare bf16
# roundings that the residual layers carry forward.
TOL_REL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
TOL_REL_FUSED = {"float32": {"h": 1e-4, "dx": 1e-4},
                 "bfloat16": {"h": 2e-2, "dx": 4e-3}}
# trained-weights check: every sampled point within this many Å of the
# pocket centroid (with --clamp-x 8, the repo's end-to-end setting); the
# trained denoiser's outputs, card vs CPU plain (float32), absolute
RADIUS = 30.0
DENOISER_TOL = 1e-3
# bf16 at the widths phase's widths, fixed limits set from this script's
# readings on an H100 (PERF.md, Findings): above every sound reading (the
# kernel; the bf16 plain version or the CPU's bf16 denoiser against
# float32), below the seeded faults' (seeded_column_fault) that they can
# see. There K2's displacement strays from the bf16 plain version past the
# stated 4e-3, and the sampler's bf16 denoiser from the CPU's past 1e-3,
# by the rounding noise of bf16 alone: each is held to the bf16 version on
# the same inputs and to the float32 one, relative to max|ref| (K2) or
# absolute (the denoiser)
BF16_DX_LIMITS = {"bf16 plain": 3e-2, "float32": 0.1}
BF16_DENOISER_LIMITS = {"bf16": 0.035, "float32": 0.04}
B, N_P, N_Q, K, H, L = 48, 8, 110, 12, 256, 5
# consensus phase: clouds sampled (about 5 points each), card vs CPU limit
# (relative to max|CPU value|, same explicit initialisation), and the
# registration's limits on the recovered rotation and translation (Å)
N_CLOUDS, CONS_T = 1024, 100
# DBSCAN on raw sampled clouds (Å): the trained model's clouds spread ~9 Å
# per axis, so 12 neighbours lie within 2 Å only in the denser sites
DBSCAN_EPS = 2.0
CONS_REL = 1e-4
REG_TOL = 1e-3
# get-phar calls timed after each method's first call
WARM_CALLS = 1
# the decode at T=0.7 whose unique valid SMILES the align, evaluate and
# train phases take: its calls of B=512 rows (2,048 rows)
T07_CALLS = 4
# K1's launches in the flagship msgpass run at the default T=500: (T + 1)
# denoiser calls of 5 GCLs each; the width rule must not send any away.
# K3's as many: 5 blocks of one GCL each
K1_FLAGSHIP_LAUNCHES = 2505
# stage 3: run-all's decode batch; rows held card vs CPU; the validity below
# which the constrained trained decode is garbage (the JAX package read
# 0.90-0.91 on real pockets); logits card vs CPU relative to max|CPU|;
# a row's tokens may part only where the CPU's top two scores lie closer
DECODE_B = 512
DECODE_CHECK_B = 16
DECODE_VALID_MIN = 0.5
DECODE_LOGIT_REL = 1e-4
DECODE_TIE = 1e-3
# stage 1's options on the card vs the CPU (float32): the trained
# denoiser's limit
OPTION_TOL = 1e-3
# stage 4 at run-all's settings: conformers per molecule, refinement steps,
# molecules per align call, atom-count bucket; card vs CPU on one chunk
# with the same draws: the RMSD of every conformer both keep (Å) and its
# coordinates (relative to max|CPU|), float32 through 100 steps
ALIGN_C, ALIGN_STEPS, ALIGN_CHUNK, ALIGN_BUCKET = 5, 100, 64, 16
ALIGN_RMSD_TOL = 1e-3
ALIGN_REL = 1e-3
# run-all on one synthetic pocket: round 5's end-to-end settings
# (runs/summary_triple_target_r5.json) with 256 decodes per hypothesis for
# its 2,048 and 1 pocket for its 8, to fit the time limit
RUN_ALL_ARGS = ["--n-clouds", "64", "--timesteps", "100", "--clamp-x", "8",
                "--neighbor-k", "16", "--cluster-counts", "4", "5", "6",
                "--smiles-per-hypothesis", "256", "--constrain-decode",
                "--constrain-valence", "--decode-temperature", "0.7"]
RUN_ALL_POCKETS = 1
RUN_ALL_VALID_MIN = 0.5
# evaluate phase: pose PDBs written from the align phase's posed molecules
EVAL_POSES = 16
# train phase: the batches timed; warm-up, timed and profiled steps; one
# step card vs CPU: loss terms within 1e-4 of max(1, |CPU|), each gradient
# leaf within 1e-3 of its largest |g| (plus 1e-5 of the tree's largest),
# the weights after it within 1e-6 absolute for all but 0.5% of them and
# within 2 lr for every one (Adam's first step moves each weight by about
# lr times the sign of its gradient, which rounding may flip where the
# gradient is near 0); the GCPG's batch, steps and check batch
TRAIN_B = (4, 32)
TRAIN_CHECK_B = 2  # card vs CPU (the CPU's dense step at full width sets it)
TRAIN_WARM, TRAIN_TIMED, TRAIN_PROFILED = 3, 6, 3
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 1e-3
TRAIN_WEIGHT_ATOL = 1e-6
GCPG_TRAIN_B, GCPG_TRAIN_STEPS, GCPG_CHECK_B = 128, 3, 8
# train-gcpg without --max-steps (its default device-resident plan): the
# molecules and epochs, at B=128 one step an epoch
GCPG_RESIDENT_SMILES, GCPG_RESIDENT_EPOCHS = 128, 1
TRAIN_CLI_STEPS = 20  # train-diffphar through the CLI, dense, B=4
# parallel phase: complexes written as PDB/SDF pairs for preprocess
# (pockets of 80-130 residues around the align phase's posed molecules;
# 16 val pockets, so that eval sampling runs B=16 as in the train phase);
# the steps taken three ways at K=12 B=32 (weights within 1e-5 and losses
# within 1e-4 of the plain trainer's: the CPU tests' tolerances of the
# multi-process steps); train-diffphar --fsdp through the CLI; the
# sampling steps traced; the posed molecules written as PDBQT
PAR_TRAIN, PAR_VAL, PAR_B, PAR_STEPS = 64, 16, 32, 5
PAR_W_ATOL, PAR_LOSS_RTOL = 1e-5, 1e-4
PAR_CLI_STEPS, PAR_TRACE_T, PAR_PDBQT = 2, 4, 4
K1_KERNEL = "gcl_message_agg_kernel"  # csrc/egnn_msgpass.cu's __global__ functions
K3_KERNEL = "coord_update_agg_kernel"
# full_atom phase: the CLI's defaults end to end at full_atom_config's width
# (hidden 256, 3 layers, 11 element classes, T=100, dense, B=8, float32) on
# synthetic full-atom complexes (the align phase's posed molecules in pockets
# of backbone and side-chain heavy atoms, FA_ATOMS[0]-FA_ATOMS[1] a pocket, the
# first at the most): preprocess, train-diffphar (FA_STEPS steps: the first
# warm, the last profiled), then sample-phars at sample_pharmacophores' default
# batch of 64 with --timesteps cut from 100 to FA_T: dense on pockets of
# FA_DENSE_ATOMS atoms (peak memory by size), K1 (--neighbor-k FA_K) and K2
# (--neighbor-k FA_K --engine fused) on the largest
FA_TRAIN, FA_VAL, FA_STEPS, FA_K, FA_T, FA_SAMPLES = 40, 8, 5, 16, 2, 64
FA_ATOMS = (160, 512)
FA_DENSE_ATOMS = (192, 352, 512)
FA_RESIDUES = 80  # residues drawn around a ligand before the 8 A rule and the cap
# train-gcpg --finetune-from the shipped grun_r5cn: steps at GCPG_TRAIN_B
GCPG_FT_STEPS = 3
# widths phase: K1 and K2 at the flagship geometry at widths that are not
# a power of two (float32) or a multiple of 32 (bf16), or past 256 (bf16),
# each beside the same kernel at the next width it took before every width
# was (K2 at bf16 past 256 has none: its H=256 time scaled by (H/256)^2);
# K1 and K2 at the cutoff-exact full-atom shape (full_atom_config's 6 A
# cutoff: K=160 bounds every receiver's in-cutoff count); the sampling
# path at WIDTH_T steps through both engines at two of these widths
WIDTHS = {"float32": (100, 192, 384), "bfloat16": (48, 320, 384)}
NEXT_WIDTH = {("float32", 100): 128, ("float32", 192): 256, ("float32", 384): 512,
              ("bfloat16", 48): 64}
WIDTH_SAMPLING = (("float32", 192), ("bfloat16", 384))
WIDTH_T = 10
FA_CUT_B, FA_CUT_K, FA_CUT_ATOMS = 16, 160, 506


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps):
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def seeded_init(module, seed):
    """Random weights from a seed: normal kernels of std 1/sqrt(fan_in)
    (clipped at 2 std) and zero biases. The coordinate gate gets the same
    scale, not the JAX package's variance of 1e-6 / fan_avg, so that the
    coordinate pass moves the pharmacophore nodes by about an angstrom and
    a wrong displacement shows in the checks."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in module.modules():
            if not isinstance(mod, torch.nn.Linear):
                continue
            w = torch.randn(mod.weight.shape, generator=g).clamp_(-2.0, 2.0)
            mod.weight.copy_(w / mod.weight.shape[1] ** 0.5)
            if mod.bias is not None:
                mod.bias.zero_()


def compare(name, out, ref, rel):
    """max|out - ref| against rel * max|ref|; raises beyond it."""
    err = (out.float() - ref.float()).abs().max().item()
    ref_max = ref.float().abs().max().item()
    if not ref_max > 0:
        raise AssertionError(f"{name}: the plain version gave all zeros, nothing to compare")
    tol = rel * ref_max
    log(f"  {name}: max_abs_err={err:.3e} tol={tol:.3e} max|ref|={ref_max:.4g} "
        f"mean|ref|={ref.float().abs().mean().item():.4g}")
    if not (np.isfinite(err) and err <= tol):
        raise AssertionError(f"{name} disagrees with its plain version: {err} > {tol}")
    return {"quantity": name, "max_abs_err": err, "tol": tol, "ref_max": ref_max,
            "ref_mean_abs": ref.float().abs().mean().item()}


def seeded_column_fault(dyn, linear, hidden):
    """A copy of the dynamics ``dyn`` with the last real output column of
    every layer's ``linear`` (``edge_out`` or ``coord_mid``) zeroed, as a
    kernel that dropped that column at a padded width would compute: a
    seeded fault for the bf16 limits' readings."""
    import copy

    import torch

    faulty = copy.deepcopy(dyn)
    with torch.no_grad():
        for mod in faulty.modules():
            lin = getattr(mod, linear, None)
            if isinstance(lin, torch.nn.Linear):
                lin.weight[hidden - 1] = 0
                if lin.bias is not None:
                    lin.bias[hidden - 1] = 0
    return faulty


def flagship_geometry(seed, b, dev):
    """Pockets of 110 CA atoms (realistic_ca_pocket) and 8 pharmacophore
    points near their centre: (pocket PointCloud, x [B,N,3], edge_mask)."""
    import torch

    from cmdgen_tpu_torch.containers import PointCloud
    from cmdgen_tpu_torch.utils.synthetic import realistic_ca_pocket

    rng = np.random.RandomState(seed)
    pk = np.stack([realistic_ca_pocket(np.random.RandomState(i), N_Q) for i in range(8)])
    pk = np.tile(pk, (b // 8 + 1, 1, 1))[:b]
    onehot = np.eye(20, dtype=np.float32)[rng.randint(0, 20, (b, N_Q))]
    pocket = PointCloud(x=torch.from_numpy(pk).to(dev), h=torch.from_numpy(onehot).to(dev),
                        mask=torch.ones(b, N_Q, device=dev))
    xp = (rng.randn(b, N_P, 3) * 2.0).astype(np.float32)
    x = torch.from_numpy(np.concatenate([xp, pk], axis=1)).to(dev)
    d2 = ((x[:, :, None] - x[:, None]) ** 2).sum(-1)
    edge_mask = (d2 <= 36.0).float()
    return pocket, x, edge_mask


def flagship_dynamics(dev, dtype, joint=False, hidden=H):
    """The flagship configuration (``ca_config`` with K=12 in ``dtype``, of
    width ``hidden``) and its dynamics with seeded weights on ``dev``;
    ``joint``: the joint model's (``train.mode="joint"``,
    ``update_pocket_coords``), the same weights. Returns (config,
    dynamics)."""
    import dataclasses

    from cmdgen_tpu_torch.config import ca_config
    from cmdgen_tpu_torch.models.dynamics import EGNNDynamics

    cfg = ca_config()
    egnn = dataclasses.replace(cfg.dynamics.egnn, compute_dtype=dtype, neighbor_k=K,
                               hidden_nf=hidden)
    dyn_cfg = dataclasses.replace(cfg.dynamics, egnn=egnn, update_pocket_coords=joint)
    cfg = dataclasses.replace(cfg, dynamics=dyn_cfg)
    if joint:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, mode="joint"))
    dyn = EGNNDynamics(dyn_cfg)
    seeded_init(dyn, seed=0)
    return cfg, dyn.to(dev).eval()


def timed_check(dtype_name, checks, ms, plain_ms, flops, nbytes):
    """One dtype's check: the comparisons, the times and the card's bound
    for the work (the larger of its operations over the peak rate and its
    bytes over the memory rate)."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
    bound = max(t_ops, t_bytes) * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    log(f"  ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound:.5f} ({by})")
    return dict(dtype=dtype_name, comparisons=checks, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes)


def k1_work(b, n, k, h, es):
    """K1's operations and bytes for b samples of n nodes, k neighbours
    each, width h, es bytes an element (every slot, masked ones too: the
    bound of a kernel that computes them all, kept for comparison; the
    kernel takes only the live ones, ``live_share`` of them)."""
    edges = b * n * k
    flops = 2 * edges * h * h + 2 * edges * h
    nbytes = 3 * b * n * h * es + 4 * edges * 4 + (h * h + 2 * h + h) * es + (h + 1) * 4
    return flops, nbytes


def k2_work(b, n, r, k, h, layers, es):
    """K2's operations and bytes: layers of width h over b samples of n
    nodes, k neighbours each, r of them moved."""
    per_layer = (2 * 2 * n * h * h            # edge w_i, w_j
                 + 2 * n * k * h * h + 2 * n * k * h   # edge_out, att
                 + 3 * 2 * n * h * h          # node_in (two halves), node_out
                 + 2 * n * h * h + 2 * r * h * h      # coord w_j, w_i
                 + 2 * r * k * h * h + 2 * r * k * h)  # coord_mid, gate
    nbytes = (b * n * h * es + b * n * 3 * 4 + 3 * b * n * k * 4 + b * n * 4
              + layers * (9 * h * h + 6 * h) * es + layers * (7 * h) * 4
              + b * n * h * 4 + b * n * 3 * 4)
    return b * layers * per_layer, nbytes


def check_k1(dev, dtype_name, b=B, h=H, route=None):
    """K1's wrapper at the flagship shape (batch b, width h) on layer-0 weights,
    called as the msgpass engine calls it (``models/egnn.py: GCL``): the
    transposed ``nn.Linear`` weights as they lie, radial and dist0 as slices
    of the edge features in the compute dtype, kmask in it too, int64
    neighbor indices; the radial from moved coordinates and dist0 from the
    entry ones, so the two edge-feature rows are told apart. Kernel vs
    plain; times the wrapper (``ms``) and the kernel alone on prepared
    arguments (``kernel_ms``), reports the grid and each stage's share of
    block 0's clock. ``route``: ``launch_plan``'s (the wrapper then is
    ``prepare_launch`` on that route)."""
    import torch

    from cmdgen_tpu_torch.models.egnn import build_neighbor_list
    from cmdgen_tpu_torch.ops.egnn_msgpass import (
        STAGES, gather_rows, gcl_message_agg, gcl_message_agg_plain, prepare_launch,
        stage_shares)

    cdt = getattr(torch, dtype_name)
    _, dyn = flagship_dynamics(dev, cdt, hidden=h)
    gcl = dyn.egnn.e_block_0.gcl_0
    _, x0, edge_mask = flagship_geometry(1, b, dev)
    g = torch.Generator(device=dev).manual_seed(2)
    kmask, idx = build_neighbor_list(x0, edge_mask, K)
    x = x0 + 0.5 * torch.randn(x0.shape, generator=g, device=dev)
    radial = ((x[:, :, None] - gather_rows(x, idx)) ** 2).sum(-1, keepdim=True)
    dist0 = ((x0[:, :, None] - gather_rows(x0, idx)) ** 2).sum(-1, keepdim=True)
    edge_attr = torch.cat([radial.to(cdt), dist0.to(cdt)], dim=-1)
    hin = torch.randn(b, N_P + N_Q, h, generator=g, device=dev)
    wi, wj = gcl.edge_in.project(hin, cdt)
    args = (wi, wj, idx, edge_attr[..., 0], edge_attr[..., 1], kmask.to(cdt),
            gcl.edge_in.w_e.weight.t(), gcl.edge_out.weight.t(),
            gcl.edge_out.bias, (gcl.att.weight.reshape(h), gcl.att.bias), 100.0, cdt)
    log(f"K1 {dtype_name} B={b} H={h}" + (f" on the {route} route:" if route else ":"))

    def wrapper():
        if route is None:
            return gcl_message_agg(*args)
        return prepare_launch(*args, route=route)()

    with torch.no_grad():
        out = wrapper()
        ref = gcl_message_agg_plain(*args)
        torch.cuda.synchronize()
        checks = [compare("agg", out, ref, TOL_REL[dtype_name])]
        ms = cuda_ms(wrapper, 50)
        run = prepare_launch(*args, route=route)
        kernel_ms = cuda_ms(run, 100)
        stamps = torch.zeros(len(STAGES) + 1, dtype=torch.int64, device=dev)
        rows0 = gcl_message_agg.edge_rows()
        run(stamps)
        rows1 = gcl_message_agg.edge_rows()
        stages = stage_shares(stamps)
        plain_ms = cuda_ms(lambda: gcl_message_agg_plain(*args), 10)
    plan = run.plan
    grid = {"blocks": plan["grid"], "threads": 512, "route": plan["route"],
            "rows": plan["rows"], "hp": plan["hp"],
            "live_share": (rows1[0] - rows0[0]) / max(rows1[1] - rows0[1], 1)}
    log(f"  grid: {grid}")
    es = 4 if dtype_name == "float32" else 2
    flops, nbytes = k1_work(b, N_P + N_Q, K, h, es)
    out = timed_check(dtype_name, checks, ms, plain_ms, flops, nbytes)
    log(f"  kernel alone: kernel_ms={kernel_ms:.4f} ({kernel_ms / out['bound_ms']:.1f}x its bound)")
    log(f"  stages, share of block 0's clock over its {stages['tiles']} tiles "
        f"(ms at kernel_ms): " + ", ".join(
            f"{name} {stages[name]:.1%} ({stages[name] * kernel_ms:.4f})" for name in STAGES))
    out.update(kernel_ms=kernel_ms, grid=grid, batch=b, hidden=h, stage_shares=stages)
    return out


# K3's shapes (H, K=12 on the CA pockets): float32, the joint cell's, 16
# pharmacophore slots and a 110-residue CA pocket with every row moving,
# and the full-atom one's, 16 pharmacophore rows moving over a 506-atom
# pocket, K=160 (cutoff-exact); bf16, the flagship sampling's conditional
# shape (B=48, its 8 pharmacophore rows moving over 110 residues) and the
# joint phase's (B=48, every one of the 118 rows moving), each on the
# mma.sync route and on block_gemm (the route of bf16 past H=256)
K3_SHAPES = {
    "joint": dict(b=64, n_p=16, n_q=110, k=12, moving=None, full_atom=False, dtype="float32"),
    "full_atom": dict(b=16, n_p=16, n_q=506, k=160, moving=16, full_atom=True,
                      dtype="float32"),
    "flagship_bf16": dict(b=B, n_p=N_P, n_q=N_Q, k=K, moving=N_P, full_atom=False,
                          dtype="bfloat16"),
    "joint_bf16": dict(b=B, n_p=N_P, n_q=N_Q, k=K, moving=None, full_atom=False,
                       dtype="bfloat16"),
}


def k3_work(b, n, r, k, h, es):
    """K3's operations and bytes for b samples of n nodes, r of them moving
    with k neighbours each, width h, es bytes an element (every slot of the
    moving rows, masked ones too, as ``k1_work`` counts them)."""
    edges = b * r * k
    flops = 2 * edges * h * h + 2 * edges * h
    nbytes = ((b * r + b * n) * h * es + edges * (8 + 2 * es) + 2 * b * n * 3 * 4
              + (h * h + 2 * h) * es + 2 * h * 4)
    return flops, nbytes


def check_k3(dev, shape_name):
    """K3's wrapper (``ops/egnn_coord.py``) at one of ``K3_SHAPES``, on
    block-0 weights of the flagship configuration in the shape's dtype (its
    joint twin where every row moves), called as the msgpass engine calls it
    (``models/egnn.py: EquivariantUpdate``): the coord_in projections, the
    transposed ``nn.Linear`` weights as they lie, dist0 and kmask in the
    compute dtype, int64 neighbour indices from the 6 A cutoff, the
    conditional model's update-coordinates mask where only the pharmacophore
    rows move. Kernel vs plain on the displacement (float32 1e-4, bf16
    2**-7 of its largest value, K1's limits); in bf16 the block_gemm route
    too. Seeded faults must fail the same comparison: coord_mid's last
    column zeroed, and the gate's tanh left out, in the plain version.
    Times the wrapper (``ms``), the kernel alone on prepared arguments
    (``kernel_ms``) and the plain version (``plain_ms``, the same PyTorch
    ops the sublayer ran before K3); ``launches``: the wrapper's counter
    over the check."""
    import torch

    from cmdgen_tpu_torch.models.egnn import build_neighbor_list
    from cmdgen_tpu_torch.ops.egnn_coord import (
        coord_update_agg, coord_update_agg_plain, prepare_launch)
    from cmdgen_tpu_torch.ops.egnn_msgpass import STAGES, gather_rows, stage_shares
    from cmdgen_tpu_torch.utils.synthetic import realistic_ca_pocket

    shape = K3_SHAPES[shape_name]
    b, n_p, n_q, k, moving = (shape[key] for key in ("b", "n_p", "n_q", "k", "moving"))
    dtype_name = shape["dtype"]
    cdt = getattr(torch, dtype_name)
    _, dyn = flagship_dynamics(dev, cdt, joint=moving is None)
    upd = dyn.egnn.e_block_0.coord_update
    rng = np.random.RandomState(3)
    geo = dict(r_lo=4.0, r_hi=16.0, min_sep=1.5) if shape["full_atom"] else {}
    pk = np.stack([realistic_ca_pocket(np.random.RandomState(i), n_q, **geo)
                   for i in range(min(b, 8))])
    pk = np.tile(pk, (b // len(pk) + 1, 1, 1))[:b]
    xp = pk.mean(1, keepdims=True) + rng.randn(b, n_p, 3) * 2.0
    x0 = torch.tensor(np.concatenate([xp, pk], 1), dtype=torch.float32, device=dev)
    n = n_p + n_q
    edge_mask = (((x0[:, :, None] - x0[:, None]) ** 2).sum(-1) <= 36.0).float()
    if shape["full_atom"] and int(edge_mask.sum(-1).max()) > k:
        raise AssertionError(f"K3 {shape_name}: a row has more than K={k} edges in the cutoff")
    kmask, idx = build_neighbor_list(x0, edge_mask, k)
    g = torch.Generator(device=dev).manual_seed(4)
    x = x0 + 0.5 * torch.randn(x0.shape, generator=g, device=dev)
    dist0 = ((x0[:, :, None] - gather_rows(x0, idx)) ** 2).sum(-1)
    hin = torch.randn(b, n, H, generator=g, device=dev)
    ucm = None
    if moving is not None:
        ucm = torch.cat([torch.ones(b, moving, device=dev), torch.zeros(b, n - moving, device=dev)],
                        1)
    wi, wj = upd.coord_in.project(hin, cdt, rows=moving)
    args = (wi, wj, idx, dist0.to(cdt), kmask.to(cdt), x, ucm, upd.coord_in.w_e.weight.t(),
            upd.coord_mid.weight.t(), upd.coord_mid.bias, upd.coord_gate.weight.reshape(H),
            upd.coords_range_layer, 1.0, 100.0, True, cdt)
    r = wi.shape[1]
    tol = TOL_REL[dtype_name]
    log(f"K3 {dtype_name} {shape_name} B={b} N={n} moving={r} K={k} H={H}:")
    before = coord_update_agg.launches
    with torch.no_grad():
        out = coord_update_agg(*args)
        ref = coord_update_agg_plain(*args)
        torch.cuda.synchronize()
        if coord_update_agg.launches != before + 1:
            raise AssertionError(f"K3 {shape_name}: the wrapper launched "
                                 f"{coord_update_agg.launches - before} kernels, expected 1")
        if not torch.equal(out[:, r:], x[:, r:]):
            raise AssertionError(f"K3 {shape_name}: a row that does not move moved")
        checks = [compare("dx", out - x, ref - x, tol)]
        if cdt == torch.bfloat16:
            gemm = prepare_launch(*args, route="block_gemm")
            if gemm.plan["route"] != "block_gemm":
                raise AssertionError(f"K3 {shape_name}: block_gemm asked, {gemm.plan['route']} "
                                     "planned")
            by_gemm = gemm()
            checks.append(compare("dx, block_gemm route", by_gemm - x, ref - x, tol))
            log(f"  the two routes apart: max|mma - block_gemm| = "
                f"{(out - by_gemm).abs().max().item():.3e}")
        wm, bm = args[8].clone(), args[9].clone()
        wm[:, H - 1] = 0
        bm[H - 1] = 0
        faults = {"coord_mid column zeroed": (*args[:8], wm, bm, *args[10:]),
                  "tanh left out": (*args[:14], False, cdt)}
        for name, fault_args in faults.items():
            fault = coord_update_agg_plain(*fault_args)
            try:
                compare(f"dx, seeded fault ({name})", out - x, fault - x, tol)
            except AssertionError:
                log(f"  the seeded fault ({name}) fails the comparison, as it must")
            else:
                raise AssertionError(f"K3 {shape_name}: the seeded fault ({name}) passed the "
                                     "comparison")
        ms = cuda_ms(lambda: coord_update_agg(*args), 50)
        run = prepare_launch(*args)
        kernel_ms = cuda_ms(run, 100)
        stamps = torch.zeros(len(STAGES) + 1, dtype=torch.int64, device=dev)
        rows0 = coord_update_agg.edge_rows()
        run(stamps)
        rows1 = coord_update_agg.edge_rows()
        stages = stage_shares(stamps)
        plain_ms = cuda_ms(lambda: coord_update_agg_plain(*args), 10)
    plan = run.plan
    grid = {"blocks": plan["grid"], "threads": 512, "route": plan["route"],
            "rows": plan["rows"],
            "live_share": (rows1[0] - rows0[0]) / max(rows1[1] - rows0[1], 1)}
    log(f"  grid: {grid}")
    flops, nbytes = k3_work(b, n, r, k, H, 4 if cdt == torch.float32 else 2)
    res = timed_check(dtype_name, checks, ms, plain_ms, flops, nbytes)
    log(f"  kernel alone: kernel_ms={kernel_ms:.4f} ({kernel_ms / res['bound_ms']:.1f}x its "
        f"bound); stages, share of block 0's clock over its {stages['tiles']} tiles: " +
        ", ".join(f"{name} {stages[name]:.1%}" for name in STAGES))
    res.update(kernel_ms=kernel_ms, grid=grid, shape=dict(shape, n=n, hidden=H),
               stage_shares=stages)
    return res


def check_k2(dev, dtype_name, b=B, hidden=H, bf16_limits=False, route=None):
    """K2's wrapper at the flagship shape (batch b, width hidden), on the inputs the fused
    engine gives it (``make_fused_apply``: float32 type encoders, the 6 Å
    cutoff, pocket rows held): kernel vs plain. h and the displacement
    x_out - x_in are compared each on its own scale; in bf16 with
    ``bf16_limits`` the displacement is held by BF16_DX_LIMITS, to the
    bf16 plain version and to the float32 one, beside the readings of
    seeded faults (``seeded_column_fault``). Times the
    wrapper (``ms``: neighbor list, embeddings and the kernel) and the
    kernel alone (``kernel_ms``: ``_layers_kernel``), and reports the grid
    it launched. ``route``: ``launch_plan``'s (the wrapper then is the
    fused forward with ``_layers_kernel`` on that route)."""
    import functools

    import torch

    from cmdgen_tpu_torch.ops import egnn_fused as ef
    from cmdgen_tpu_torch.ops.egnn_fused import (
        PHASES, _layers_kernel, egnn_forward_fused, egnn_forward_fused_plain, fused_params,
        layer_args, phase_shares)

    layers = functools.partial(_layers_kernel, route=route)
    fused = (egnn_forward_fused if route is None
             else lambda *a, **k: ef._forward(layers, *a, **k))
    cdt = getattr(torch, dtype_name)
    _, dyn = flagship_dynamics(dev, cdt, hidden=hidden)
    ecfg = dyn.cfg.egnn
    params = fused_params(dyn.egnn, cdt)
    pocket, x, _ = flagship_geometry(3, b, dev)
    n = N_P + N_Q
    g = torch.Generator(device=dev).manual_seed(4)
    phar_h = torch.eye(8, device=dev)[torch.randint(0, 8, (b, N_P), generator=g, device=dev)]
    xh_phar = torch.cat([x[:, :N_P], phar_h], -1)
    xh_pocket = torch.cat([pocket.x, pocket.h], -1)
    t = torch.rand(b, 1, generator=g, device=dev)
    with torch.no_grad():
        h, x, mask, edge_mask, ucm = dyn._inputs(
            xh_phar, xh_pocket, t, torch.ones(b, N_P, device=dev), pocket.mask,
            lambda mlp, v: mlp.forward_f32(v))
    args = (params, h, x, edge_mask, mask, ucm)
    kw = dict(n_layers=ecfg.n_layers, neighbor_k=ecfg.neighbor_k,
              norm_constant=ecfg.norm_constant, coords_range=ecfg.coords_range,
              normalization_factor=ecfg.normalization_factor, tanh=ecfg.tanh,
              update_rows=N_P, compute_dtype=cdt)
    log(f"K2 {dtype_name} B={b} H={hidden}" + (f" on the {route} route:" if route else ":"))
    with torch.no_grad():
        oh, ox = fused(*args, **kw)
        rh, rx = egnn_forward_fused_plain(*args, **kw)
        torch.cuda.synchronize()
        grid = dict(egnn_forward_fused.last_grid)
        log(f"  grid: {grid['blocks']} blocks of 512 threads, {grid['blocks_per_sm']} per SM, "
            f"{grid['smem_bytes']} bytes of shared memory each "
            f"({torch.cuda.get_device_properties(dev).multi_processor_count} SMs)")
        if not torch.equal(ox[:, N_P:], x[:, N_P:]):
            raise AssertionError(f"K2 {dtype_name} moved pocket rows")
        rel = TOL_REL_FUSED[dtype_name]

        def dx(xx):
            return xx[:, :N_P] - x[:, :N_P]

        vs_f32 = None
        if cdt != torch.float32:
            # both bf16 versions against the float32 plain version: the
            # kernel should stray from it no further than the plain one
            th, tx = egnn_forward_fused_plain(fused_params(dyn.egnn, torch.float32), *args[1:],
                                              **dict(kw, compute_dtype=torch.float32))

            def rel_err(o, r):
                return (o - r).abs().max().item() / r.abs().max().item()

            vs_f32 = {who: [rel_err(hh, th), rel_err(dx(xx), dx(tx))]
                      for who, hh, xx in (("kernel", oh, ox), ("plain", rh, rx))}
        checks = [compare("h", oh, rh, rel["h"])]
        if bf16_limits and vs_f32 is not None:
            checks += [compare("dx", dx(ox), dx(rx), BF16_DX_LIMITS["bf16 plain"]),
                       compare("dx vs float32", dx(ox), dx(tx), BF16_DX_LIMITS["float32"])]
            # what seeded faults read on the same scales (h, dx; against
            # the bf16 plain version, then float32)
            readings = {"bf16 plain vs float32": vs_f32["plain"]}
            for linear in ("edge_out", "coord_mid"):
                q = fused_params(seeded_column_fault(dyn, linear, hidden).egnn, cdt)
                fh, fx = egnn_forward_fused_plain(q, *args[1:], **kw)
                readings[f"fault {linear} column {hidden - 1}"] = [
                    rel_err(fh, rh), rel_err(dx(fx), dx(rx)), rel_err(fh, th), rel_err(dx(fx), dx(tx))]
            log("  readings, of max|ref| (h, dx vs the bf16 plain version; h, dx vs float32): "
                + "; ".join(f"{k} " + ", ".join(f"{v:.3e}" for v in vals)
                            for k, vals in readings.items()))
            checks[-1]["readings"] = readings
        else:
            checks.append(compare("dx", dx(ox), dx(rx), rel["dx"]))
        if vs_f32 is not None:
            log(f"  relative to the float32 plain version (h, dx): kernel "
                f"{vs_f32['kernel'][0]:.2e}, {vs_f32['kernel'][1]:.2e}; bf16 plain "
                f"{vs_f32['plain'][0]:.2e}, {vs_f32['plain'][1]:.2e}")
        ms = cuda_ms(lambda: fused(*args, **kw), 10)
        largs = layer_args(*args[:5], **kw)
        kernel_ms = cuda_ms(lambda: layers(*largs), 20)
        stamps = torch.zeros(1 + len(PHASES) * L, dtype=torch.int64, device=dev)
        layers(*largs, stamps=stamps)
        phases = phase_shares(stamps)
        plain_ms = cuda_ms(lambda: egnn_forward_fused_plain(*args, **kw), 5)
    es = 4 if dtype_name == "float32" else 2
    flops, nbytes = k2_work(b, n, N_P, K, hidden, L, es)
    out = timed_check(dtype_name, checks, ms, plain_ms, flops, nbytes)
    log(f"  kernel alone: kernel_ms={kernel_ms:.4f} ({kernel_ms / out['bound_ms']:.1f}x its bound)")
    log("  phases, share of one launch's clock (ms at kernel_ms): " + ", ".join(
        f"{name} {v:.1%} ({v * kernel_ms:.3f})" for name, v in phases.items()))
    out.update(kernel_ms=kernel_ms, grid=grid, batch=b, hidden=hidden, phases=phases,
               vs_f32=vs_f32)
    return out


def device_profile(fn, reps, top=3):
    """Profile reps calls of fn (torch.profiler, CUDA activity): the wall
    ms and device ms per call, the device's busy share of the wall time and
    the ``top`` kernels that take most of the device time. It reads the
    trace's raw events: ``prof.events()`` would build a Python object for
    every one (~0.1 ms each on the card's host, seconds for a decode)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    by_name, events = {}, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not getattr(
                e, "is_hidden_event", lambda: False)():
            by_name[e.name()] = by_name.get(e.name(), 0.0) + e.duration_ns() / 1e6 / reps
            events += 1
    busy = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms": wall, "device_ms": busy, "busy_share": busy / wall,
            "device_ops": events / reps, "top_kernels_ms": {k[:60]: v for k, v in ranked}}


def flagship_sampling(dev, timesteps):
    """Both engines through sample_given_pocket at the flagship CA config;
    returns {engine: (steps/s, seconds, launches dict, profile)}."""
    import torch

    from cmdgen_tpu_torch.diffusion.cddpm import ConditionalDDPM
    from cmdgen_tpu_torch.models.dynamics import make_fused_apply

    cfg, dyn = flagship_dynamics(dev, torch.bfloat16)
    pocket, _, _ = flagship_geometry(5, B, dev)
    num_nodes = torch.full((B,), N_P, device=dev)
    results = {}
    for engine in ("msgpass", "fused"):
        apply_fn = make_fused_apply(dyn) if engine == "fused" else None
        model = ConditionalDDPM(cfg.ddpm, dyn, apply_fn=apply_fn)
        gen = torch.Generator(device=dev).manual_seed(7)
        model.sample_given_pocket(pocket, num_nodes, N_P, timesteps=2, generator=gen)  # warm-up
        torch.cuda.synchronize()
        launch_counts(reset=True)
        captures = graph_captures()
        t0 = time.perf_counter()
        phar, pocket_out = model.sample_given_pocket(pocket, num_nodes, N_P,
                                                     timesteps=timesteps, generator=gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = launch_counts()
        if not (torch.isfinite(phar.x).all() and torch.isfinite(pocket_out.x).all()):
            raise AssertionError(f"{engine}: non-finite samples")
        if tuple(phar.x.shape) != (B, N_P, 3):
            raise AssertionError(f"{engine}: samples of shape {tuple(phar.x.shape)}")
        calls = timesteps + 1  # reverse steps + the final decode
        want = launches_want(engine, L, calls, captures)
        if launches != want:
            raise AssertionError(f"{engine}: launches {launches}, expected {want}")
        sps = B * timesteps / dt
        log(f"flagship {engine}: B={B} T={timesteps} {dt:.3f} s "
            f"{sps:.1f} denoise steps/s launches={launches}")
        prof = device_profile(lambda: model.sample_given_pocket(
            pocket, num_nodes, N_P, timesteps=5, generator=gen), 2)
        log(f"flagship {engine} profile, T=5 per call: {json.dumps(prof)}")
        results[engine] = (sps, dt, launches, prof)
    return results


def trained_run(dev, repo):
    """The sample-phars CLI entry on the committed qrun_aa weights, both
    engines, plus the trained denoiser on the card vs on the CPU."""
    import torch

    from cmdgen_tpu_torch import cli
    from cmdgen_tpu_torch.chem.constants import PHAR_DECODER
    from cmdgen_tpu_torch.convert import load_port_checkpoint
    from cmdgen_tpu_torch.models.dynamics import make_fused_apply
    from cmdgen_tpu_torch.pipeline.sample_phars import pocket_point_cloud
    from cmdgen_tpu_torch.utils.synthetic import synthetic_pocket_pdb

    ckpt = repo / "cmdgen_tpu_torch" / "assets" / "qrun_aa"
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        pdb = Path(tmp) / "pocket.pdb"
        pdb.write_text(synthetic_pocket_pdb(np.random.RandomState(0)))
        coords, onehot = pocket_point_cloud(pdb, "crossdock", "CA", ref_ligand="L:1")
        centroid = coords.mean(0)
        for engine in ("msgpass", "fused"):
            out_json = Path(tmp) / f"{engine}.json"
            launch_counts(reset=True)
            captures = graph_captures()
            t0 = time.perf_counter()
            cli.main(["sample-phars", str(ckpt), str(pdb), str(out_json),
                      "--ref-ligand", "L:1", "--n-samples", "24", "--timesteps", "100",
                      "--clamp-x", "8", "--seed", "0", "--device", "cuda",
                      "--engine", engine])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches[engine] = launch_counts()
            mols = json.loads(out_json.read_text())
            if len(mols) != 24:
                raise AssertionError(f"{engine}: {len(mols)} molecules, expected 24")
            pts, fams = [], set()
            for mol in mols.values():
                for fam, xyz in mol.items():
                    fams.add(fam)
                    pts.extend(xyz)
            pts = np.asarray(pts, dtype=np.float64)
            if not set(fams) <= set(PHAR_DECODER) or not np.isfinite(pts).all():
                raise AssertionError(f"{engine}: malformed molecules")
            rmax = float(np.linalg.norm(pts - centroid, axis=1).max())
            if rmax > RADIUS:
                raise AssertionError(f"{engine}: a point {rmax:.1f} Å from the pocket centroid")
            # 24 samples in one batch, T=100: 101 denoiser calls of 3 blocks
            want = launches_want(engine, 3, 101, captures)
            if launches[engine] != want:
                raise AssertionError(f"{engine}: launches {launches[engine]}, expected {want}")
            log(f"trained sample-phars {engine}: 24 molecules, {len(pts)} points, "
                f"families {sorted(fams)}, max {rmax:.2f} Å from the pocket centroid "
                f"(limit {RADIUS}), {dt:.2f} s, launches={launches[engine]}")

    # the trained denoiser: kernels on the card vs plain versions on the CPU, f32
    rng = np.random.RandomState(1)
    b, nq = 4, coords.shape[0]
    xh_p = np.concatenate([rng.randn(b, 5, 3), np.eye(8)[rng.randint(0, 8, (b, 5))] / 4], -1)
    xh_q = np.concatenate([np.broadcast_to(coords - coords.mean(0), (b, nq, 3)),
                           np.broadcast_to(onehot / 4, (b, nq, 20))], -1)
    inputs = [torch.tensor(v, dtype=torch.float32) for v in
              (xh_p, xh_q, rng.rand(b, 1), np.ones((b, 5)), np.ones((b, nq)))]
    errs = {}
    ref_model, _ = load_port_checkpoint(ckpt, "cpu")
    with torch.no_grad():
        ref = ref_model.dynamics(*inputs)
        for engine in ("msgpass", "fused"):
            model, _ = load_port_checkpoint(ckpt, "cuda", engine)
            fn = make_fused_apply(model.dynamics) if engine == "fused" else model.dynamics
            out = fn(*[v.to(dev) for v in inputs])
            errs[engine] = max((o.cpu() - r).abs().max().item() for o, r in zip(out, ref))
    log(f"trained denoiser, card vs CPU plain (f32): max_abs_err={errs} tol={DENOISER_TOL}")
    if not all(e <= DENOISER_TOL for e in errs.values()):
        raise AssertionError(f"trained denoiser disagrees with the CPU: {errs}")
    return launches


def run_all_kernels(dev, repo, pdb):
    """K1 and K2 at the shapes run-all gives them: qrun_aa (H=128, 3
    layers, float32) with run-all's flags (K=16), its sampler's batch of
    64 clouds in 8 node slots, the unused ones masked, and the pocket
    padded to a multiple of 16 rows. The denoiser's inputs are recorded
    from ``sample_pharmacophores`` called as run-all's sampler calls it,
    on the card with the msgpass engine: its first, middle and last of
    T + 1 calls. At each, the denoiser through K1 (msgpass) and through K2
    (fused) on the card against the CPU's plain path (``DENOISER_TOL``),
    and every wrapper call of those evaluations, recorded, kernel against
    plain at the kernel's tolerance. The middle call's first K1 call and
    its K2 call are timed against the plain version beside their bound."""
    from cmdgen_tpu_torch import cli
    from cmdgen_tpu_torch.device import make_generator
    from cmdgen_tpu_torch.models.dynamics import make_fused_apply
    from cmdgen_tpu_torch.pipeline.sample_phars import pocket_point_cloud, sample_pharmacophores

    assets = repo / "cmdgen_tpu_torch" / "assets"
    args = cli.parse_args(["run-all", str(assets / "qrun_aa"), str(assets / "grun_r5cn"), "out",
                           str(pdb), "--ref-ligand", "L:1", *RUN_ALL_ARGS, "--device", "cpu"])
    pcfg = cli.pipeline_config(args)
    cpu_model, cfg = cli._diffphar_model(args.diff_ckpt, args)
    args.device = "cuda"
    model, _ = cli._diffphar_model(args.diff_ckpt, args)
    ecfg = cfg.dynamics.egnn
    fused = make_fused_apply(model.dynamics)
    coords, onehot = pocket_point_cloud(pdb, cfg.data.dataset, cfg.data.pocket_representation,
                                        ref_ligand=args.ref_ligand)
    n_calls = pcfg.diff_timesteps + 1
    recorded, seen = record_denoiser_inputs(model.dynamics, n_calls, lambda: sample_pharmacophores(
        model, coords, onehot, pcfg.n_clouds_per_pocket, n_phar_max=pcfg.n_phar_max,
        batch_size=pcfg.n_clouds_per_pocket, timesteps=pcfg.diff_timesteps,
        pocket_pad_bucket=pcfg.pocket_pad_bucket, generator=make_generator(dev, 0)))
    xh_phar, xh_pocket, _, phar_mask, pocket_mask = recorded[0]
    shape = {"batch": xh_phar.shape[0], "node_slots": xh_phar.shape[1],
             "nodes_used": sorted(set(phar_mask.sum(1).int().tolist())),
             "pocket_rows": xh_pocket.shape[1], "pocket_atoms": len(coords),
             "hidden": ecfg.hidden_nf, "layers": ecfg.n_layers, "neighbor_k": ecfg.neighbor_k,
             "dtype": str(ecfg.compute_dtype).split(".")[-1], "denoiser_calls": seen}
    log(f"run-all's kernel shapes: {shape}")
    if not (seen == n_calls and shape["batch"] == pcfg.n_clouds_per_pocket
            and shape["node_slots"] == pcfg.n_phar_max and (phar_mask == 0).any()
            and shape["pocket_rows"] % pcfg.pocket_pad_bucket == 0
            and (pocket_mask == 0).any()):
        raise AssertionError(f"the recorded inputs are not run-all's: {shape}")

    outs, k1_calls, k2_calls = recorded_kernel_calls(
        {"msgpass": model.dynamics, "fused": fused}, recorded)
    errs = {engine: max(err for _, err, _ in by_step)
            for engine, by_step in denoiser_vs_cpu(outs, cpu_model.dynamics, recorded).items()}
    log(f"run-all's denoiser at steps {sorted(recorded)}, card vs CPU plain: "
        f"max_abs_err={errs} tol={DENOISER_TOL}")
    if not all(e <= DENOISER_TOL for e in errs.values()):
        raise AssertionError(f"run-all's denoiser disagrees with the CPU: {errs}")
    if (len(k1_calls), len(k2_calls)) != (len(recorded) * ecfg.n_layers, len(recorded)):
        raise AssertionError(f"{len(k1_calls)} K1 and {len(k2_calls)} K2 calls recorded")
    out = {"shape": shape, "steps": sorted(recorded), "denoiser_vs_cpu": dict(errs, tol=DENOISER_TOL)}
    log(f"K1 and K2 at run-all's shape, {len(k1_calls)} and {len(k2_calls)} recorded calls:")
    k1_checks, k2_checks = check_kernel_calls(k1_calls, k2_calls, shape["dtype"])
    # the middle step's first GCL and its K2 call
    out["k1"], out["k2"] = time_kernel_calls(k1_calls[ecfg.n_layers], k2_calls[1], shape["dtype"],
                                             ecfg, k1_checks, k2_checks)
    return out


def record_denoiser_inputs(dynamics, n_calls, run):
    """Call ``run()`` with a hook that keeps the inputs of the first,
    middle and last of the ``n_calls`` calls of ``dynamics``: ({call index:
    inputs}, the number of calls seen)."""
    recorded = {0: None, n_calls // 2: None, n_calls - 1: None}
    seen = [0]

    def record(module, inputs):
        if seen[0] in recorded:
            recorded[seen[0]] = tuple(v.clone() for v in inputs)
        seen[0] += 1

    hook = dynamics.register_forward_pre_hook(record)
    try:
        run()
    finally:
        hook.remove()
    return recorded, seen[0]


def denoiser_vs_cpu(outs, cpu_dynamics, recorded):
    """Each engine's outputs (``outs`` of ``recorded_kernel_calls``)
    against ``cpu_dynamics`` (the plain path) on the same recorded inputs:
    {engine: [(step, largest |card - CPU|, largest |CPU output|), ...]}."""
    import torch

    with torch.no_grad():
        refs = {step: cpu_dynamics(*(v.cpu() for v in inputs)) for step, inputs in recorded.items()}
    return {engine: [(step, max((o.cpu() - r).abs().max().item()
                                for o, r in zip(by_step[step], refs[step])),
                      max(r.abs().max().item() for r in refs[step])) for step in recorded]
            for engine, by_step in outs.items()}


def recorded_kernel_calls(fns, recorded):
    """Each denoiser of ``fns`` ({name: fn}) on each recorded input set
    ({step: inputs}), with every K1 and K2 call recorded (with its
    arguments, ``kernel_calls_kept``) on its way through: ({name: {step:
    outputs}}, K1 calls, K2 calls)."""
    import torch

    outs = {}
    with kernel_calls_kept(None, None) as (k1_calls, k2_calls), torch.no_grad():
        for step in sorted(recorded):
            for name, fn in fns.items():
                outs.setdefault(name, {})[step] = fn(*recorded[step])
    return outs, k1_calls, k2_calls


@contextlib.contextmanager
def kernel_calls_kept(k1_keep, k2_keep):
    """K1 and K2 wrapped where the models call them, for the calls made
    inside: each call goes on to its wrapper (and is counted there, as
    without this), and copies of the arguments of the calls whose order is
    in ``k1_keep`` / ``k2_keep`` (every call where None) are kept in the
    two lists yielded, for ``check_kernel_calls``: K1's positional
    arguments and its compute dtype, K2's (arguments, keywords). Inside,
    the module runs its forward pass op by op (no CUDA graph replayed or
    captured), so that every denoiser call reaches the wrapper."""
    import torch

    from cmdgen_tpu_torch.models import dynamics as dyn_mod
    from cmdgen_tpu_torch.models import egnn as egnn_mod
    from cmdgen_tpu_torch.ops import egnn_fused as fu
    from cmdgen_tpu_torch.ops import egnn_msgpass as mp

    k1_calls, k2_calls, seen = [], [], [0, 0]

    def copy(v):
        return v.clone() if isinstance(v, torch.Tensor) else v

    def k1_keeper(*a, **kw):
        if k1_keep is None or seen[0] in k1_keep:
            k1_calls.append(tuple(map(copy, a)) + (kw["compute_dtype"],))
        seen[0] += 1
        return mp.gcl_message_agg(*a, **kw)

    def k2_keeper(*a, **kw):
        if k2_keep is None or seen[1] in k2_keep:
            k2_calls.append((tuple(map(copy, a)), {k: copy(v) for k, v in kw.items()}))
        seen[1] += 1
        return fu.egnn_forward_fused(*a, **kw)

    refusal = dyn_mod.graph_refusal
    egnn_mod.gcl_message_agg, dyn_mod.egnn_forward_fused = k1_keeper, k2_keeper
    dyn_mod.graph_refusal = lambda dynamics, xh: "kernel calls kept"
    try:
        yield k1_calls, k2_calls
    finally:
        egnn_mod.gcl_message_agg, dyn_mod.egnn_forward_fused = mp.gcl_message_agg, fu.egnn_forward_fused
        dyn_mod.graph_refusal = refusal


def k1_calls_of_steps(n_layers, n_calls):
    """The orders of K1's calls in the first, middle and last of
    ``n_calls`` denoiser calls (``n_layers`` GCLs each)."""
    return {c * n_layers + g for c in (0, n_calls // 2, n_calls - 1) for g in range(n_layers)}


def check_kernel_calls(k1_calls, k2_calls, dtype_name):
    """Every recorded K1 and K2 call, kernel against plain at the kernel's
    tolerance (K2: h, and the displacement of its movable rows, all of them
    where ``update_rows`` is None; rows past them must not move). Returns
    (K1 comparisons, K2 comparisons)."""
    import torch

    from cmdgen_tpu_torch.ops import egnn_fused as fu
    from cmdgen_tpu_torch.ops import egnn_msgpass as mp

    with torch.no_grad():
        k1 = [compare(f"agg, call {i}", mp.gcl_message_agg(*a), mp.gcl_message_agg_plain(*a),
                      TOL_REL[dtype_name]) for i, a in enumerate(k1_calls)]
        k2 = []
        for i, (a, kw) in enumerate(k2_calls):
            (oh, ox), (rh, rx) = fu.egnn_forward_fused(*a, **kw), fu.egnn_forward_fused_plain(*a, **kw)
            x = a[2]
            r = x.shape[1] if kw["update_rows"] is None else kw["update_rows"]
            if not torch.equal(ox[:, r:], x[:, r:]):
                raise AssertionError(f"K2 moved rows past update_rows, call {i}")
            k2 += [compare(f"h, call {i}", oh, rh, TOL_REL_FUSED[dtype_name]["h"]),
                   compare(f"dx, call {i} ({r} rows)", ox[:, :r] - x[:, :r], rx[:, :r] - x[:, :r],
                           TOL_REL_FUSED[dtype_name]["dx"])]
    return k1, k2


def time_kernel_calls(k1_args, k2_call, dtype_name, ecfg, k1_checks, k2_checks):
    """One recorded K1 call and one K2 call timed: the wrapper (``ms``),
    the kernel alone (``kernel_ms``: K1 on prepared arguments, K2 without
    its neighbour list and embeddings, with its phases' shares of one
    launch), the plain version, and the bound for the work at this shape
    (K2's r = its movable rows). Returns (K1 record, K2 record)."""
    import torch

    from cmdgen_tpu_torch.ops import egnn_fused as fu
    from cmdgen_tpu_torch.ops import egnn_msgpass as mp

    a, (a2, kw) = k1_args, k2_call
    b, n = a2[1].shape[:2]
    r = n if kw["update_rows"] is None else kw["update_rows"]
    es = 4 if dtype_name == "float32" else 2
    with torch.no_grad():
        ms = cuda_ms(lambda: mp.gcl_message_agg(*a), 50)
        kernel_ms = cuda_ms(mp.prepare_launch(*a), 100)
        plain_ms = cuda_ms(lambda: mp.gcl_message_agg_plain(*a), 10)
        k1 = timed_check(dtype_name, k1_checks, ms, plain_ms,
                         *k1_work(b, n, ecfg.neighbor_k, ecfg.hidden_nf, es))
        k1["kernel_ms"] = kernel_ms
        log(f"  K1 kernel alone: kernel_ms={kernel_ms:.4f} ({kernel_ms / k1['bound_ms']:.1f}x "
            f"its bound)")
        ms = cuda_ms(lambda: fu.egnn_forward_fused(*a2, **kw), 20)
        largs = fu.layer_args(*a2[:5], **kw)
        kernel_ms = cuda_ms(lambda: fu._layers_kernel(*largs), 20)
        stamps = torch.zeros(1 + len(fu.PHASES) * ecfg.n_layers, dtype=torch.int64,
                             device=a2[1].device)
        fu._layers_kernel(*largs, stamps=stamps)
        phases = fu.phase_shares(stamps)
        plain_ms = cuda_ms(lambda: fu.egnn_forward_fused_plain(*a2, **kw), 5)
        k2 = timed_check(dtype_name, k2_checks, ms, plain_ms,
                         *k2_work(b, n, r, ecfg.neighbor_k, ecfg.hidden_nf, ecfg.n_layers, es))
        k2.update(kernel_ms=kernel_ms, phases=phases, update_rows=r)
        log(f"  K2 kernel alone: kernel_ms={kernel_ms:.4f} ({kernel_ms / k2['bound_ms']:.1f}x "
            f"its bound); phases (ms at kernel_ms): " + ", ".join(
                f"{name} {v:.1%} ({v * kernel_ms:.3f})" for name, v in phases.items()))
    return k1, k2


def rigid_motion():
    """The known rigid motion between the two targets of the dual mode."""
    rng = np.random.RandomState(7)
    q, r = np.linalg.qr(rng.randn(3, 3))
    q = q @ np.diag(np.sign(np.diag(r)))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q, np.array([3.0, -4.0, 2.5])


def write_cloud(path, mols):
    path.write_text(json.dumps(mols))


def moved_cloud(mols, fn):
    """The cloud JSON with every point p replaced by fn(p)."""
    return {name: {fam: [list(map(float, fn(np.asarray(p, np.float64)))) for p in pts]
                   for fam, pts in mol.items()} for name, mol in mols.items()}


def thinned_cloud(mols):
    """The cloud JSON without every 10th molecule."""
    return {name: mol for i, (name, mol) in enumerate(mols.items()) if i % 10 != 9}


def check_posp(path, centroid, n_lines=None):
    """A .posp file of known type codes and finite coordinates within RADIUS
    of the pocket centroid (and n_lines lines where given): its lines."""
    from cmdgen_tpu_torch.chem.posp import PHAR2IDX

    rows = [ln.split() for ln in Path(path).read_text().strip().splitlines()]
    types = [r[0] for r in rows]
    xyz = np.array([[float(v) for v in r[1:]] for r in rows])
    if not rows or not set(types) <= set(PHAR2IDX) or not np.isfinite(xyz).all():
        raise AssertionError(f"{path}: malformed consensus {rows}")
    rmax = float(np.linalg.norm(xyz - centroid, axis=1).max())
    if rmax > RADIUS:
        raise AssertionError(f"{path}: a point {rmax:.1f} Å from the pocket centroid")
    if n_lines is not None and len(rows) != n_lines:
        raise AssertionError(f"{path}: {len(rows)} lines, expected {n_lines}")
    return len(rows)


def graph_captures() -> int:
    """CUDA graphs of the denoiser captured so far in the process
    (``models.dynamics.graphed_forward``)."""
    from cmdgen_tpu_torch.models.dynamics import graphed_forward

    return graphed_forward.captures


def k1_want(n_layers: int, calls: int, captures_before: int) -> int:
    """K1's launches in ``calls`` denoiser calls of ``n_layers`` GCLs on the
    msgpass engine: one a GCL a call, and one a GCL for each graph captured
    since ``captures_before`` (the pass run op by op before its capture)."""
    return n_layers * (calls + graph_captures() - captures_before)


def launch_counts(reset=False):
    """The port's kernels' launch counters by name: K1's, K2's and K3's
    (each wrapper's ``.launches``); ``reset``: each set to 0 first."""
    from cmdgen_tpu_torch.ops.egnn_coord import coord_update_agg
    from cmdgen_tpu_torch.ops.egnn_fused import egnn_forward_fused
    from cmdgen_tpu_torch.ops.egnn_msgpass import gcl_message_agg

    fns = (gcl_message_agg, egnn_forward_fused, coord_update_agg)
    if reset:
        for fn in fns:
            fn.launches = 0
    return {fn.__name__: fn.launches for fn in fns}


def launches_want(engine, n_layers, calls, captures_before=None):
    """The launches of ``calls`` denoiser calls of ``n_layers`` blocks (one
    GCL each) on one engine: on msgpass K1 a GCL a call and K3 a block a
    call (with ``captures_before``, once more for each graph captured since:
    ``k1_want``), no K2; on fused K2 once a call and neither of the others."""
    if engine != "msgpass":
        return {"gcl_message_agg": 0, "egnn_forward_fused": calls, "coord_update_agg": 0}
    n = (n_layers * calls if captures_before is None
         else k1_want(n_layers, calls, captures_before))
    return {"gcl_message_agg": n, "egnn_forward_fused": 0, "coord_update_agg": n}


def synced_ms(fn):
    """(result, ms) of one call between two synchronizes."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def rel_err(out, ref):
    """max|out - ref| / max(max|ref|, 1e-30), both on the CPU."""
    out, ref = out.detach().cpu().double(), ref.detach().cpu().double()
    return (out - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)


def consensus_phase(dev, repo, keep_posp):
    """Stage 2 on the card: 1,024 clouds from qrun_aa (K1 counted), every
    get-phar method and mode through the CLI (each method's first call and
    its warm calls timed apart), a warm call in parts, the registration of
    a known rigid motion between clouds of unequal sizes, and the
    clustering and Kabsch functions on the card held against the CPU. The
    GMM hypothesis of the first call is copied to ``keep_posp``."""
    import dataclasses

    import torch

    from cmdgen_tpu_torch import cli
    from cmdgen_tpu_torch.convert import build_model, read_port_checkpoint
    from cmdgen_tpu_torch.device import make_generator
    from cmdgen_tpu_torch.ops import clustering as cl
    from cmdgen_tpu_torch.ops.kabsch import kabsch
    from cmdgen_tpu_torch.pipeline import get_phar as gp
    from cmdgen_tpu_torch.pipeline.sample_phars import pocket_point_cloud, sample_phars_to_json
    from cmdgen_tpu_torch.utils.synthetic import synthetic_pocket_pdb

    out = {"clouds": N_CLOUDS, "ms": {}, "max_errors": {}, "clusters": {}}
    cfg, params = read_port_checkpoint(repo / "cmdgen_tpu_torch" / "assets" / "qrun_aa")
    cfg = dataclasses.replace(cfg, ddpm=dataclasses.replace(cfg.ddpm, clamp_x=8.0))
    model = build_model(cfg, params, dev, "msgpass")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        pdb = tmp / "pocket.pdb"
        pdb.write_text(synthetic_pocket_pdb(np.random.RandomState(0)))
        coords_q, _ = pocket_point_cloud(pdb, "crossdock", "CA", ref_ligand="L:1")
        centroid = coords_q.mean(0)
        cloud = tmp / "cloud.json"
        launch_counts(reset=True)
        captures = graph_captures()
        mols, ms = synced_ms(lambda: sample_phars_to_json(
            model, pdb, cloud, dataset=cfg.data.dataset,
            representation=cfg.data.pocket_representation, ref_ligand="L:1",
            n_samples=N_CLOUDS, timesteps=CONS_T, batch_size=N_CLOUDS,
            generator=make_generator(dev, 0)))
        counts = launch_counts()
        want = launches_want("msgpass", cfg.dynamics.egnn.n_layers, CONS_T + 1, captures)
        if cfg.dynamics.egnn.inv_sublayers != 1 or counts != want:
            raise AssertionError(f"consensus sampling: launches {counts}, expected {want}")
        if len(mols) != N_CLOUDS:
            raise AssertionError(f"{len(mols)} clouds, expected {N_CLOUDS}")
        coords, fams = gp.load_point_cloud_json(cloud)
        launches = counts["gcl_message_agg"]
        out.update(points=len(coords), sample_ms=ms, k1_launches=launches,
                   k3_launches=counts["coord_update_agg"])
        log(f"consensus: {N_CLOUDS} clouds, {len(coords)} points sampled in {ms:.0f} ms "
            f"(K1 launched {launches} times, K3 {counts['coord_update_agg']})")

        # the second target: the first moved by a known rigid motion, every
        # 10th molecule dropped, so the sizes differ and registration takes
        # the multi-start ICP, as two different targets do. The anti-target:
        # the first with the half x > median moved 50 Å away
        r_true, t_true = rigid_motion()
        dual = tmp / "dual.json"
        write_cloud(dual, moved_cloud(thinned_cloud(mols), lambda p: r_true @ p + t_true))
        x_mid = float(np.median(coords[:, 0]))
        anti = tmp / "anti.json"
        write_cloud(anti, moved_cloud(mols, lambda p: p + (50.0 if p[0] > x_mid else 0.0)))

        hyp = tmp / "hyp.posp"
        runs = {
            "gmm": (["--method", "gmm", "--n-clusters", "7"], [("", 7)]),
            "kmeans": (["--method", "kmeans", "--n-clusters", "7"], [("", 7)]),
            "dbscan": (["--method", "dbscan", "--eps", str(DBSCAN_EPS), "--min-samples", "12"],
                       [("", None)]),
            "dual_gmm": (["--dual-json", str(dual), "--dual-mode", "gmm",
                          "--n-clusters", "7"], [(".dual1", 7), (".dual2", 7)]),
            "dual_dbscan": (["--dual-json", str(dual), "--dual-mode", "dbscan"],
                            [(".dual1", None), (".dual2", None)]),
            "dual_indiv": (["--dual-json", str(dual), "--dual-mode", "indiv",
                            "--n-clusters", "7"], [(".dual_indiv", None)]),
            "select": (["--select-json", str(anti), "--eps", str(DBSCAN_EPS), "--min-samples", "12"],
                       [("", None)]),
        }
        out["first_ms"], out["warm_ms"] = {}, {}
        for name, (args, files) in runs.items():
            # the first call of each method pays its one-time set-up; the
            # next WARM_CALLS are the per-call cost, each file checked
            for i in range(1 + WARM_CALLS):
                _, ms = synced_ms(lambda: cli.main(["get-phar", str(cloud), str(hyp), *args,
                                                    "--device", str(dev)]))
                counts = []
                if name == "gmm" and i == 0:
                    keep_posp.write_text(hyp.read_text())
                for suffix, n_lines in files:
                    path = hyp.with_suffix(suffix + ".posp") if suffix else hyp
                    # frame 2 of the dual modes is the moved target's
                    c = (r_true @ centroid + t_true if suffix in (".dual2", ".dual_indiv")
                         else centroid)
                    counts.append(check_posp(path, c, n_lines))
                    path.unlink()
                if i == 0:
                    out["first_ms"][name] = ms
                    out["clusters"][name] = counts
                else:
                    out["warm_ms"].setdefault(name, []).append(ms)
                    if counts != out["clusters"][name]:
                        raise AssertionError(f"get-phar {name}: lines {counts}, first call "
                                             f"{out['clusters'][name]}")
            out["ms"][name] = float(np.median(out["warm_ms"][name]))
            log(f"  get-phar {name}: first call {out['first_ms'][name]:.1f} ms, then "
                f"{[round(v, 1) for v in out['warm_ms'][name]]} ms, lines {counts}")

        # a warm single-target call in parts: the JSON read, the consensus
        # function (fit and per-point bookkeeping), the .posp write
        parts = {}
        _, parts["load_json"] = synced_ms(lambda: gp.load_point_cloud_json(cloud))
        for name, fn in [("gmm", lambda: gp.consensus_gmm(coords, fams, 7, 42, device=dev)),
                         ("kmeans", lambda: gp.consensus_kmeans(coords, fams, 7, 42, device=dev)),
                         ("dbscan", lambda: gp.consensus_dbscan(coords, fams, DBSCAN_EPS, 12,
                                                                device=dev))]:
            cons, parts["consensus_" + name] = synced_ms(fn)
        _, parts["write_posp"] = synced_ms(lambda: gp.write_consensus(hyp, cons))
        out["parts_ms"] = parts
        log(f"  a warm call in parts (ms): {parts}")

        # the dual modes' registration (a tenth of the first target's points
        # unpaired), and the same ICP where every point of the first target
        # has its partner (the first without every 10th molecule, onto the
        # whole cloud moved): there its fixed point is the motion itself
        thin, whole = tmp / "thin.json", tmp / "whole.json"
        write_cloud(thin, thinned_cloud(mols))
        write_cloud(whole, moved_cloud(mols, lambda p: r_true @ p + t_true))
        c_dual = gp.load_point_cloud_json(dual)[0]
        # with unpaired points, ICP's fixed point lies off the motion by
        # about the mean of the first target's offsets to its nearest
        # neighbours in the second, taken at the motion (zero for a point
        # with its partner): twice that mean is the limit there
        offsets = gp.nn_distances(coords @ r_true.T + t_true, c_dual, device=dev)
        pairs = {"unpaired": (coords, c_dual, 2.0 * float(offsets.mean())),
                 "paired": (gp.load_point_cloud_json(thin)[0],
                            gp.load_point_cloud_json(whole)[0], REG_TOL)}
        out["max_errors"]["registration"], out["registration_limits"] = {}, {}
        for name, (c1, c2, tol) in pairs.items():
            out["registration_limits"][name] = tol
            (_, r, t), out["ms"]["register_" + name] = synced_ms(
                lambda: gp.register_clouds(c1, c2, device=dev))
            reg = {"rotation": float(np.abs(r - r_true).max()),
                   "translation": float(np.abs(t - t_true).max())}
            out["max_errors"]["registration"][name] = reg
            log(f"  register_clouds ({name}, {len(c1)} onto {len(c2)} points): "
                f"{out['ms']['register_' + name]:.1f} ms, off the rigid motion by {reg} "
                f"(limit {tol})")
            if not max(reg.values()) <= tol:
                raise AssertionError(f"registration ({name}) off the known motion: {reg}")

    # the card against the CPU, the same inputs and initialisation
    x_cpu = torch.from_numpy(coords)
    x = x_cpu.to(dev)
    init = cl.kmeanspp(x_cpu, 7, 4, torch.Generator().manual_seed(0))
    errs, times = {}, {}
    labels, times["dbscan"] = synced_ms(lambda: cl.dbscan(x, DBSCAN_EPS, 12))
    t0 = time.perf_counter()
    labels_cpu = cl.dbscan(x_cpu, DBSCAN_EPS, 12)
    times["dbscan_cpu"] = (time.perf_counter() - t0) * 1e3
    if not torch.equal(labels.cpu(), labels_cpu):
        raise AssertionError("dbscan labels differ between the card and the CPU")
    km, times["kmeans"] = synced_ms(lambda: cl.kmeans(x, 7, init=init))
    t0 = time.perf_counter()
    km_cpu = cl.kmeans(x_cpu, 7, init=init)
    times["kmeans_cpu"] = (time.perf_counter() - t0) * 1e3
    errs["kmeans"] = max(rel_err(km.centers, km_cpu.centers), rel_err(km.inertia, km_cpu.inertia))
    g, times["gmm_fit"] = synced_ms(lambda: cl.gmm_fit(x, 7, init_means=init[0]))
    t0 = time.perf_counter()
    g_cpu = cl.gmm_fit(x_cpu, 7, init_means=init[0])
    times["gmm_fit_cpu"] = (time.perf_counter() - t0) * 1e3
    errs["gmm_fit"] = max(rel_err(a, b) for a, b in zip(g, g_cpu))
    gen = torch.Generator().manual_seed(1)
    p = torch.randn(4096, 8, 3, generator=gen) * 3.0
    rot = torch.linalg.qr(torch.randn(4096, 3, 3, generator=gen)).Q
    rot = rot * torch.linalg.det(rot)[:, None, None]  # proper rotations
    q = p @ rot.mT + torch.randn(4096, 1, 3, generator=gen) * 5.0
    q = q + 0.1 * torch.randn(q.shape, generator=gen)
    (r, t), times["kabsch_4096"] = synced_ms(lambda: kabsch(p.to(dev), q.to(dev)))
    r_cpu, t_cpu = kabsch(p, q)
    errs["kabsch"] = max(rel_err(r, r_cpu), rel_err(t, t_cpu))
    out["max_errors"]["card_vs_cpu"] = errs
    out["functions_ms"] = times
    log(f"  card vs CPU (same init): dbscan labels equal, relative errors {errs} "
        f"(limit {CONS_REL}); ms {times}")
    if not max(errs.values()) <= CONS_REL:
        raise AssertionError(f"consensus functions disagree with the CPU: {errs}")
    return out


def option_models(dev):
    """Flagship-width (hidden 256, 5 layers, K=12) float32 models with
    random weights from a seed, one per stage-1 option, each on the CPU and
    on the card: {option: (cpu model, card model)}."""
    import copy
    import dataclasses

    import torch

    from cmdgen_tpu_torch.config import ca_config
    from cmdgen_tpu_torch.diffusion.cddpm import ConditionalDDPM
    from cmdgen_tpu_torch.models.dynamics import EGNNDynamics

    cfg = ca_config()
    egnn = dataclasses.replace(cfg.dynamics.egnn, neighbor_k=K)
    variants = {
        "sin_embedding": (dataclasses.replace(egnn, sin_embedding=True), "egnn_dynamics", {}),
        "gnn_dynamics": (egnn, "gnn_dynamics", {}),
        "learned": (egnn, "egnn_dynamics", {"noise_schedule": "learned", "loss_type": "vlb"}),
    }
    out = {}
    for name, (ecfg, mode, ddpm_kw) in variants.items():
        dyn = EGNNDynamics(dataclasses.replace(cfg.dynamics, egnn=ecfg, mode=mode))
        seeded_init(dyn, seed=0)
        ddpm = dataclasses.replace(cfg.ddpm, **ddpm_kw)
        pair = [ConditionalDDPM(ddpm, copy.deepcopy(dyn).to(d).eval()) for d in ("cpu", dev)]
        if pair[0].gamma_net is not None:  # the network's layers from a seed
            g = torch.Generator().manual_seed(1)
            with torch.no_grad():
                for key, prm in pair[0].gamma_net.named_parameters():
                    if key.startswith("l"):
                        prm.copy_(torch.randn(prm.shape, generator=g) * 0.5)
            pair[1].gamma_net.load_state_dict(pair[0].gamma_net.state_dict())
        out[name] = tuple(pair)
    return out


def options_phase(dev, repo):
    """Stage 1's options on the card vs the CPU at the flagship widths in
    float32: three teacher-forced reverse steps each at low t (1/alpha_ts
    near 1), the same draws for every option. Then the chain sampler on
    the trained weights, card vs CPU and under ddim_eta."""
    import dataclasses

    import torch

    from cmdgen_tpu_torch.containers import mask_from_sizes
    from cmdgen_tpu_torch.convert import build_model, read_port_checkpoint

    b = 4
    pocket, _, _ = flagship_geometry(11, b, "cpu")
    g = torch.Generator().manual_seed(12)
    phar_mask = mask_from_sizes(torch.tensor([N_P, N_P, 6, 5]), N_P)
    st = torch.tensor([[20.0, 30.0], [40.0, 50.0], [90.0, 100.0]])
    draws = [(torch.randn(b, N_P, 11, generator=g) * phar_mask[..., None],
              torch.randn(b, N_P, 11, generator=g)) for _ in range(st.shape[0])]

    def steps(model, d):
        """The reverse steps' outputs (z, pocket) on d, concatenated."""
        sc = model._reverse_scalars(st)
        outs = []
        with torch.no_grad():
            for i, (z, eps) in enumerate(draws):
                args = (z.to(d), pocket.xh.to(d), sc[i], eps.to(d), phar_mask.to(d),
                        pocket.mask.to(d))
                outs += [o.cpu().reshape(-1) for o in model.reverse_step(*args)]
        return torch.cat(outs)

    errs, launches, want, k3_launches = {}, {}, {}, {}
    for name, (m_cpu, m_dev) in option_models(dev).items():
        ref = steps(m_cpu, "cpu")
        launch_counts(reset=True)
        captures = graph_captures()
        errs[name] = (steps(m_dev, dev) - ref).abs().max().item()
        counts = launch_counts()
        launches[name] = counts["gcl_message_agg"]
        k3_launches[name] = counts["coord_update_agg"]
        want[name] = k1_want(5, st.shape[0], captures)
        log(f"option {name}: card vs CPU over 3 reverse steps (flagship widths, float32): "
            f"max_abs_err={errs[name]:.3e} tol={OPTION_TOL}; K1 launches {launches[name]}, "
            f"K3 {k3_launches[name]}")
    if not all(e <= OPTION_TOL for e in errs.values()):
        raise AssertionError(f"stage-1 options disagree with the CPU: {errs}")
    if (launches["learned"] != want["learned"] or launches["sin_embedding"]
            or k3_launches != launches):
        raise AssertionError(f"K1 launches per option {launches}, K3 {k3_launches}: the "
                             "learned schedule's GCLs and coordinate updates go to K1 and K3, "
                             "sin_embedding's 24-wide ones to neither")

    # the chain sampler (the reference's): on the card against the CPU with
    # the same noise, and under ddim_eta the ancestral chain, bit for bit
    cfg, params = read_port_checkpoint(repo / "cmdgen_tpu_torch" / "assets" / "qrun_aa")
    nodes = torch.tensor([N_P, N_P, 6, 5])
    gen = torch.Generator().manual_seed(13)
    n_steps, shape = 10, (b, N_P, 11)
    noise = (torch.randn(shape, generator=gen), torch.randn((n_steps, *shape), generator=gen),
             torch.randn(shape, generator=gen))
    chains = {}
    for name, d, eta in (("cpu", "cpu", None), ("card", dev, None), ("card_ddim", dev, 0.0)):
        model = build_model(dataclasses.replace(
            cfg, ddpm=dataclasses.replace(cfg.ddpm, ddim_eta=eta)), params, d)
        pk = pocket.replace(x=pocket.x.to(d), h=pocket.h.to(d), mask=pocket.mask.to(d))
        phar, _, frames = model.sample_chain_given_pocket(
            pk, nodes.to(d), N_P, keep_frames=5, timesteps=n_steps,
            noise=tuple(v.to(d) for v in noise))
        chains[name] = (phar.x.cpu(), phar.h.cpu(), frames.cpu())
    (x, h, frames), (cx, ch, cframes) = chains["card"], chains["cpu"]
    chain_err = max((frames - cframes).abs().max().item(), (x - cx).abs().max().item())
    same_h = torch.equal(h, ch)
    ancestral = all(torch.equal(u, v) for u, v in zip(chains["card_ddim"], chains["card"]))
    log(f"chain sampler ({n_steps} steps, qrun_aa): frames {tuple(frames.shape)}, card vs CPU "
        f"max_abs_err={chain_err:.3e} tol={OPTION_TOL}, types equal: {same_h}; under "
        f"ddim_eta=0 equal to the ancestral chain bit for bit: {ancestral}")
    if (chain_err > OPTION_TOL or not same_h or not ancestral
            or tuple(frames.shape) != (5, b, N_P, 3) or not torch.isfinite(frames).all()):
        raise AssertionError("the chain sampler disagrees with the CPU or follows ddim_eta")
    return {"card_vs_cpu": errs, "k1_launches": launches, "chain_card_vs_cpu": chain_err,
            "chain_ancestral_under_ddim": ancestral, "frames": list(frames.shape)}


def widths_phase(dev, k1_flagship, k2_flagship):
    """K1 and K2 at every kind of width they take (WIDTHS, NEXT_WIDTH):
    each against its plain version at the flagship geometry (B=48, N=118,
    K=12, 5 layers; K2's bf16 displacement by BF16_DX_LIMITS) and timed
    beside the next width's time; at bf16 H=256
    also on the block_gemm route (``route="block_gemm"``), the route past
    256, beside the mma route's time (``k1_flagship`` and ``k2_flagship``:
    the kernels phase's bf16 checks); at the cutoff-exact full-atom shape;
    then ``sample_given_pocket`` at B=48, T=WIDTH_T through both engines on
    seeded ``ca_config`` models of WIDTH_SAMPLING's widths, launches counted
    (5 K1 launches a denoiser call, 1 K2) and the first call's denoiser on
    the card against the CPU's over all B samples (float32: DENOISER_TOL;
    bf16: BF16_DENOISER_LIMITS). Returns the
    ``widths`` record: {"k1": ..., "k2": ..., "sampling": ...}."""
    import dataclasses

    import torch

    from cmdgen_tpu_torch import config as cfgmod
    from cmdgen_tpu_torch.diffusion.cddpm import ConditionalDDPM
    from cmdgen_tpu_torch.models.dynamics import EGNNDynamics, make_fused_apply
    from cmdgen_tpu_torch.utils.synthetic import full_atom_pocket_pdb

    t0 = time.perf_counter()
    keys = ("ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "comparisons")
    out = {"k1": {"widths": []}, "k2": {"widths": []}}

    def k2_check(dev, dtype_name, b, h, route=None):
        return check_k2(dev, dtype_name, b, h, bf16_limits=True, route=route)

    for dtype_name, widths in WIDTHS.items():
        for h in widths:
            for key, check in (("k1", check_k1), ("k2", k2_check)):
                rec = check(dev, dtype_name, B, h)
                row = {"dtype": dtype_name, "hidden": h, **{k: rec[k] for k in keys},
                       "grid": rec["grid"]}
                nxt = NEXT_WIDTH.get((dtype_name, h))
                if nxt is not None:
                    row["next_hidden"] = nxt
                    row["next_kernel_ms"] = check(dev, dtype_name, B, nxt)["kernel_ms"]
                elif key == "k2":  # bf16 past 256: no width K2 took before
                    row["next_hidden"] = f"256 scaled by (H/256)^2 = {(h / 256) ** 2:.4g}"
                    row["next_kernel_ms"] = k2_flagship["kernel_ms"] * (h / 256) ** 2
                else:  # K1 took bf16 320 and 384 before (H % 32 == 0, H <= 512)
                    row["next_hidden"] = None
                if row["next_hidden"] is not None:
                    row["vs_next"] = row["kernel_ms"] / row["next_kernel_ms"]
                log(f"widths {key} {dtype_name} H={h}: kernel_ms={row['kernel_ms']:.4f} "
                    f"bound_ms={row['bound_ms']:.5f} plain_ms={row['plain_ms']:.4f} "
                    f"next ({row['next_hidden']}): {row.get('next_kernel_ms')} "
                    f"ratio {row.get('vs_next')} ({time.perf_counter() - t0:.1f} s)")
                out[key]["widths"].append(row)

    # both routes at the one bf16 width where both run
    for key, check, ref in (("k1", check_k1, k1_flagship), ("k2", k2_check, k2_flagship)):
        rec = check(dev, "bfloat16", B, H, route="block_gemm")
        out[key]["block_gemm_route_at_256"] = {
            "kernel_ms": rec["kernel_ms"], "mma_route_kernel_ms": ref["kernel_ms"],
            "ratio": rec["kernel_ms"] / ref["kernel_ms"], "comparisons": rec["comparisons"],
            "grid": rec["grid"]}
        log(f"widths {key} bf16 H=256 on the block_gemm route: kernel_ms="
            f"{rec['kernel_ms']:.4f}, the mma route's {ref['kernel_ms']:.4f}")

    # the cutoff-exact full-atom shape: full_atom_config (hidden 256, 3
    # layers, float32, 6 A cutoff) with K=160 over 16 + 506 rows
    cfg = cfgmod.full_atom_config()
    ecfg = dataclasses.replace(cfg.dynamics.egnn, neighbor_k=FA_CUT_K)
    dyn = EGNNDynamics(dataclasses.replace(cfg.dynamics, egnn=ecfg))
    seeded_init(dyn, seed=0)
    dyn = dyn.to(dev).eval()
    rng = np.random.RandomState(21)
    n_q = FA_CUT_ATOMS
    xq = np.zeros((FA_CUT_B, n_q, 3))
    mq = np.zeros((FA_CUT_B, n_q))
    for i in range(FA_CUT_B):  # pockets around a ligand-sized blob at the origin
        lig = rng.randn(24, 3) * 2.0
        pdb, _ = full_atom_pocket_pdb(rng, ["C"] * 24, lig - lig.mean(0), 160, n_q)
        xyz = np.array([[float(line[30:38]), float(line[38:46]), float(line[46:54])]
                        for line in pdb.splitlines() if line.startswith("ATOM")])
        xq[i, :len(xyz)], mq[i, :len(xyz)] = xyz, 1.0
    xh_q = np.concatenate([xq, np.eye(11)[rng.randint(0, 11, (FA_CUT_B, n_q))]], -1)
    xh_p = np.concatenate([rng.randn(FA_CUT_B, 16, 3) * 2.0,
                           np.eye(8)[rng.randint(0, 8, (FA_CUT_B, 16))]], -1)
    inputs = [torch.tensor(v, dtype=torch.float32, device=dev) for v in
              (xh_p, xh_q, rng.rand(FA_CUT_B, 1), np.ones((FA_CUT_B, 16)), mq)]
    x_all = torch.cat([inputs[0][..., :3], inputs[1][..., :3]], 1)
    m_all = torch.cat([inputs[3], inputs[4]], 1)
    d2 = ((x_all[:, :, None] - x_all[:, None]) ** 2).sum(-1)
    in_cutoff = ((d2 <= cfg.dynamics.edge_cutoff ** 2) * m_all[:, :, None] * m_all[:, None]).sum(-1)
    max_in_cutoff = int(in_cutoff.max().item())
    if max_in_cutoff > FA_CUT_K:
        raise AssertionError(f"full-atom widths shape: {max_in_cutoff} rows within the cutoff "
                             f"of one receiver, more than K={FA_CUT_K}: the list is not exact")
    _, k1_calls, k2_calls = recorded_kernel_calls(
        {"msgpass": dyn, "fused": make_fused_apply(dyn)}, {0: inputs})
    k1_checks, k2_checks = check_kernel_calls(k1_calls, k2_calls, "float32")
    k1, k2 = time_kernel_calls(k1_calls[0], k2_calls[0], "float32", ecfg, k1_checks, k2_checks)
    shape = {"batch": FA_CUT_B, "rows": [16, n_q], "neighbor_k": FA_CUT_K, "hidden": ecfg.hidden_nf,
             "layers": ecfg.n_layers, "dtype": "float32", "max_in_cutoff": max_in_cutoff,
             "pocket_atoms": [int(m.sum()) for m in mq]}
    for key, rec in (("k1", k1), ("k2", k2)):
        out[key]["full_atom_cutoff_exact"] = dict(shape, **{k: rec[k] for k in keys})
    log(f"widths full-atom cutoff-exact {shape}: K1 kernel_ms={k1['kernel_ms']:.4f}, "
        f"K2 kernel_ms={k2['kernel_ms']:.4f} ({time.perf_counter() - t0:.1f} s)")

    # the sampling path at two of the widths, both engines
    sampling, res = {}, []
    for dtype_name, hidden in WIDTH_SAMPLING:
        cdt = getattr(torch, dtype_name)
        cfg, dyn = flagship_dynamics(dev, cdt, hidden=hidden)
        pocket, _, _ = flagship_geometry(5, B, dev)
        num_nodes = torch.full((B,), N_P, device=dev)
        rec = {"launches": {}}
        recorded = None
        for engine in ("msgpass", "fused"):
            model = ConditionalDDPM(cfg.ddpm, dyn,
                                    apply_fn=make_fused_apply(dyn) if engine == "fused" else None)
            gen = torch.Generator(device=dev).manual_seed(7)
            launch_counts(reset=True)
            captures = graph_captures()
            run = (lambda: model.sample_given_pocket(pocket, num_nodes, N_P,
                                                     timesteps=WIDTH_T, generator=gen))
            if engine == "msgpass":
                recorded, _ = record_denoiser_inputs(dyn, 1, lambda: res.append(run()))
            else:
                res.append(run())
            torch.cuda.synchronize()
            phar, _ = res.pop()
            launches = launch_counts()
            want = launches_want(engine, L, WIDTH_T + 1, captures)
            if launches != want or not torch.isfinite(phar.x).all():
                raise AssertionError(f"widths sampling {dtype_name} H={hidden} {engine}: launches "
                                     f"{launches}, expected {want}, or non-finite samples")
            rec["launches"][engine] = launches
        # each engine's denoiser against the CPU's, on every sample of the
        # first call (the card's launch plan is the sampler's own): the
        # msgpass engine's float32 denoiser (the engines agree in float32)
        # and, in bf16, the same engine's bf16 one (the two engines round
        # bf16 at other points). In bf16, DENOISER_TOL is below one bf16
        # step of the outputs: the card is held to both by
        # BF16_DENOISER_LIMITS, beside the readings of the CPU's bf16
        # denoiser and of the card's with seeded faults (seeded_column_fault)
        inputs = recorded[0]
        cpu = {}
        for name, dt in (("bf16", cdt), ("float32", torch.float32)):
            m = EGNNDynamics(dataclasses.replace(
                dyn.cfg, egnn=dataclasses.replace(dyn.cfg.egnn, compute_dtype=dt)))
            m.load_state_dict({k: v.cpu() for k, v in dyn.state_dict().items()})
            cpu[name] = m.eval()
        rec["denoiser_vs_cpu"], rec["tol"], rec["readings"] = {}, {}, {}
        with torch.no_grad():
            f32 = [o.cpu() for o in cpu["float32"](*(v.cpu() for v in inputs))]
            for engine in ("msgpass", "fused"):
                def run_on(m, d):
                    fn = m if engine == "msgpass" else make_fused_apply(m)
                    return [o.cpu() for o in fn(*(v.to(d) for v in inputs))]

                def dist(a, b):
                    return max((o - r).abs().max().item() for o, r in zip(a, b))

                got = run_on(dyn, dev)
                if cdt == torch.float32:
                    err, tol = {"float32": dist(got, f32)}, {"float32": DENOISER_TOL}
                else:
                    ref = {"bf16": run_on(cpu["bf16"], "cpu"), "float32": f32}
                    err = {name: dist(got, r) for name, r in ref.items()}
                    tol = dict(BF16_DENOISER_LIMITS)
                    readings = {"cpu bf16 vs float32": [dist(ref["bf16"], ref["float32"])]}
                    for linear in ("edge_out", "coord_mid"):
                        faulty = run_on(seeded_column_fault(dyn, linear, hidden), dev)
                        readings[f"fault {linear} column {hidden - 1}"] = [
                            dist(faulty, ref["bf16"]), dist(faulty, ref["float32"])]
                    rec["readings"][engine] = readings
                rec["denoiser_vs_cpu"][engine], rec["tol"][engine] = err, tol
        log(f"widths sampling {dtype_name} H={hidden}: B={B} T={WIDTH_T}, launches "
            f"{rec['launches']}; the first denoiser call ({B} samples) card vs the CPU's: "
            f"max_abs_err {rec['denoiser_vs_cpu']} tol={rec['tol']}; readings "
            f"{rec['readings']} ({time.perf_counter() - t0:.1f} s)")
        if not all(rec["denoiser_vs_cpu"][e][r] <= rec["tol"][e][r]
                   for e in rec["tol"] for r in rec["tol"][e]):
            raise AssertionError(f"widths sampling {dtype_name} H={hidden}: denoiser card vs CPU "
                                 f"{rec['denoiser_vs_cpu']} > {rec['tol']}")
        sampling[f"{dtype_name}_H{hidden}"] = rec
    out["sampling"] = sampling
    return out


def seeded_gcpg(cfg, vocab, seed):
    """A decode-only GCPG with random weights from a seed (seeded_init for
    the Linear layers, a seeded normal embedding)."""
    import torch

    from cmdgen_tpu_torch.models.gcpg import GCPG

    torch.manual_seed(seed)
    model = GCPG(cfg, vocab, training_modules=False)
    seeded_init(model, seed)
    return model.eval()


def decode_stats(tok, tokens):
    """(validity, uniqueness among the valid, valid count) of decoded rows."""
    from cmdgen_tpu_torch.chem.mol import canonical_smiles, mol_from_smiles

    texts = tok.get_text(tokens.cpu().numpy())
    valid = [s for s in texts if mol_from_smiles(s) is not None]
    unique = {canonical_smiles(s) for s in valid}
    return len(valid) / len(texts), len(unique) / max(len(valid), 1), len(valid)


def decode_gaps(model, x, tokens, random_sample=False, z=None, temperature=1.0,
                constraints=None, valence=False, gumbel=None):
    """The gap between the two largest scores at every row and step [B,
    max_len-1] of the decode that gave ``tokens`` (``generate``'s keywords):
    one teacher-forced pass over the tokens, the mask replayed from them,
    then temperature and noise as ``generate`` applies them. Where two
    devices' tokens part, it tells a near tie."""
    import torch

    from cmdgen_tpu_torch.models.gcpg import SyntaxConstraints, SyntaxState
    from cmdgen_tpu_torch.models.transformer import NEG_INF

    b, steps = tokens.shape
    targets = torch.cat([torch.full((b, 1), model.sos_value, dtype=tokens.dtype), tokens[:, :-1]],
                        dim=1)
    with torch.no_grad():
        logits = model.word_pred(model.decoder_states(targets, *model.prior_memory(*x, z=z)))
    con = None if constraints is None else SyntaxConstraints(constraints)
    state = SyntaxState.initial(b, tokens.device)
    temp = torch.tensor(max(float(temperature), 1e-6), dtype=torch.float32)
    gaps = []
    for t in range(1, steps + 1):
        scores = logits[:, t - 1]
        if con is not None:
            forbidden = con.forbidden(state, targets[:, t - 1], t, steps + 1, valence)
            scores = torch.where(forbidden, NEG_INF, scores)
            state = con.update(state, tokens[:, t - 1], valence)
        if random_sample:
            scores = scores / temp + gumbel[t - 1]
        top2 = torch.topk(scores, 2, dim=-1).values
        gaps.append(top2[:, 0] - top2[:, 1])
    return torch.stack(gaps, dim=1)


def decode_phase(dev, repo, posp):
    """Stage 3 on the card: the trained grun_r5cn decode of a consensus
    hypothesis at B=512 in three modes, the default width timed, card vs
    CPU at B=16, a profile of one warm decode and the generate CLI.
    Returns (the decode line's dict, the unique valid SMILES of the
    ``constrain + valence`` run at T=0.7)."""
    import copy
    import random

    import torch

    from cmdgen_tpu_torch import cli
    from cmdgen_tpu_torch.chem.mol import canonical_smiles
    from cmdgen_tpu_torch.chem.posp import load_posp
    from cmdgen_tpu_torch.chem.tokenizer import syntax_tables
    from cmdgen_tpu_torch.config import GCPGModelConfig
    from cmdgen_tpu_torch.convert import load_port_gcpg
    from cmdgen_tpu_torch.models.gcpg import generate, sample_gumbel
    from cmdgen_tpu_torch.pipeline.generate_smiles import condition_grid

    grun = repo / "cmdgen_tpu_torch" / "assets" / "grun_r5cn"
    model, tok = load_port_gcpg(grun, dev)
    tables = torch.from_numpy(syntax_tables(tok))
    graph = [torch.from_numpy(a) for a in load_posp(posp, random.Random(0))]
    cond = torch.from_numpy(condition_grid()[0])

    def inputs(b, d):
        return [v.to(d).expand(b, *v.shape) for v in (*graph, cond)]

    modes = {"free": dict(), "constrain": dict(constraints=tables),
             "constrain_valence": dict(constraints=tables, valence=True)}
    out = {"batch": DECODE_B, "hypothesis_points": int(graph[2].sum()), "grun_r5cn": {},
           "card_vs_cpu": {}}

    def timed(m, mode_kw, seed, n_calls=1 + WARM_CALLS):
        """The first call and the warm calls (WARM_CALLS by default) of a
        sampled decode at B=512: (every call's tokens, first ms, warm ms)."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = inputs(DECODE_B, dev)
        calls = [synced_ms(lambda: generate(m, *x, random_sample=True, generator=gen,
                                            **mode_kw)) for _ in range(n_calls)]
        return [c[0] for c in calls], calls[0][1], [c[1] for c in calls[1:]]

    positions = DECODE_B * (model.cfg.max_len - 1)
    for i, (name, kw) in enumerate(modes.items()):
        toks, first, warm = timed(model, kw, seed=i)
        validity, uniqueness, n_valid = decode_stats(tok, torch.cat(toks))
        ms = float(np.median(warm))
        rec = {"first_ms": first, "warm_ms": warm, "ms": ms,
               "positions_per_s": positions / ms * 1e3,
               "valid_smiles_per_s": validity * DECODE_B / ms * 1e3,
               "validity": validity, "uniqueness": uniqueness, "decoded": len(toks) * DECODE_B}
        out["grun_r5cn"][name] = rec
        log(f"decode grun_r5cn {name}: B={DECODE_B} first call {first:.1f} ms, warm "
            f"{[round(v, 1) for v in warm]} ms, {rec['positions_per_s']:.0f} positions/s, "
            f"{rec['valid_smiles_per_s']:.0f} valid SMILES/s, validity {validity:.4f}, "
            f"uniqueness {uniqueness:.4f} over {rec['decoded']} rows")
    # validity at the temperature of the JAX package's end-to-end figure
    # (0.90-0.91 at T=0.7 on real pockets), on this hypothesis
    toks, _, _ = timed(model, dict(modes["constrain_valence"], temperature=0.7), seed=len(modes),
                       n_calls=T07_CALLS)
    validity, uniqueness, _ = decode_stats(tok, torch.cat(toks))
    # the align phase's molecules: this run's unique valid SMILES
    canon = (canonical_smiles(s) for s in tok.get_text(torch.cat(toks).cpu().numpy()))
    smiles_t07 = list(dict.fromkeys(c for c in canon if c))
    out["grun_r5cn_t0.7"] = {"validity": validity, "uniqueness": uniqueness,
                             "decoded": len(toks) * DECODE_B}
    log(f"decode grun_r5cn constrain_valence at T=0.7: validity {validity:.4f}, "
        f"uniqueness {uniqueness:.4f} over {len(toks) * DECODE_B} rows")
    if out["grun_r5cn"]["constrain_valence"]["validity"] < DECODE_VALID_MIN:
        raise AssertionError(f"constrained trained decode: validity "
                             f"{out['grun_r5cn']['constrain_valence']['validity']} < "
                             f"{DECODE_VALID_MIN}")

    wide_cfg = GCPGModelConfig()
    wide = seeded_gcpg(wide_cfg, len(tok), seed=3).to(dev)
    _, first, warm = timed(wide, modes["constrain_valence"], seed=5)
    ms = float(np.median(warm))
    out["default_width"] = {"first_ms": first, "warm_ms": warm, "ms": ms,
                            "positions_per_s": DECODE_B * (wide_cfg.max_len - 1) / ms * 1e3}
    log(f"decode default width (hidden 384, 8 layers, max_len 128, random weights): "
        f"B={DECODE_B} first call {first:.1f} ms, warm {[round(v, 1) for v in warm]} ms")

    # the card against the CPU at B=16: the same z and Gumbel noise
    cpu_models = {"grun_r5cn": load_port_gcpg(grun, "cpu")[0],
                  "default_width": copy.deepcopy(wide).cpu()}
    dev_models = {"grun_r5cn": model, "default_width": wide}
    b = DECODE_CHECK_B
    for name, m_cpu in cpu_models.items():
        m_dev = dev_models[name]
        g = torch.Generator().manual_seed(17)
        z = torch.randn(b, m_cpu.cfg.hidden_dim, generator=g)
        noise = sample_gumbel((m_cpu.cfg.max_len - 1, b, len(tok)), g)
        rec = {"tie_rows": {}}
        for kind in ("greedy", "sampled"):
            kw = dict(random_sample=kind == "sampled", z=z, gumbel=noise, **modes["constrain_valence"])
            ref = generate(m_cpu, *inputs(b, "cpu"), **kw)
            got = generate(m_dev, *inputs(b, dev),
                           **{k: v.to(dev) if torch.is_tensor(v) else v for k, v in kw.items()}).cpu()
            ties = 0
            apart = np.flatnonzero((got != ref).any(dim=1).numpy())
            if len(apart):
                gaps = decode_gaps(m_cpu, inputs(b, "cpu"), ref, **kw)
            for r in apart:
                t = int(np.flatnonzero((got[r] != ref[r]).numpy())[0])
                if not gaps[r, t] < DECODE_TIE:
                    raise AssertionError(f"decode {name} {kind}: row {r} parts at step {t + 1} "
                                         f"where the CPU's top-two gap is {gaps[r, t]:.3e}")
                ties += 1
            rec["tie_rows"][kind] = ties
            if kind == "sampled":
                targets = torch.cat([torch.zeros((b, 1), dtype=torch.int64), ref[:, :-1]], dim=1)
        with torch.no_grad():
            logits = []
            for m, d in ((m_cpu, "cpu"), (m_dev, dev)):
                x = inputs(b, d)
                mem = m.prior_memory(*x, z=z.to(d))
                logits.append(m.word_pred(m.decoder_states(targets.to(d), *mem)).cpu())
        rec["logits_rel_err"] = rel_err(logits[1], logits[0])
        out["card_vs_cpu"][name] = rec
        log(f"decode {name} card vs CPU (B={b}, constrain+valence): teacher-forced logits "
            f"relative error {rec['logits_rel_err']:.3e} (limit {DECODE_LOGIT_REL}); rows apart "
            f"at near ties (CPU top-two gap < {DECODE_TIE}): {rec['tie_rows']}")
        if not rec["logits_rel_err"] <= DECODE_LOGIT_REL:
            raise AssertionError(f"decode {name}: logits disagree with the CPU")

    # one warm B=512 decode of each mode profiled: busy share, top kernels,
    # device ops per step and the wall time per device op
    gen = torch.Generator(device=dev).manual_seed(23)
    x = inputs(DECODE_B, dev)
    out["profile"] = {}
    for name, kw in modes.items():
        prof = device_profile(lambda: generate(model, *x, random_sample=True, generator=gen,
                                               **kw), 1)
        prof["device_ops_per_step"] = prof["device_ops"] / (model.cfg.max_len - 1)
        prof["wall_us_per_device_op"] = prof["wall_ms"] * 1e3 / prof["device_ops"]
        out["profile"][name] = prof
        log(f"decode profile (grun_r5cn, B={DECODE_B}, {name}): {json.dumps(prof)}")

    # the generate CLI once through on the card
    with tempfile.TemporaryDirectory() as tmp:
        res, ms = synced_ms(lambda: cli.main([
            "generate", str(posp), tmp, str(grun), "--n", str(DECODE_B), "--constrain-decode",
            "--constrain-valence", "--seed", "0", "--device", "cuda"]))
        lines = Path(res).read_text().splitlines()
    if not lines or len(set(lines)) != len(lines) or any(canonical_smiles(s) != s for s in lines):
        raise AssertionError(f"generate CLI: malformed output ({len(lines)} lines)")
    out["cli"] = {"ms": ms, "smiles": len(lines), "n": DECODE_B}
    log(f"generate CLI: {len(lines)} unique valid SMILES of {DECODE_B} in {ms:.0f} ms")
    return out, smiles_t07


def write_pairs(tmp, poses, rng, n_train, n_val, pocket):
    """(pairs.tsv, [pocket PDBs], [pocket sizes]): complexes written as
    (pocket PDB, ligand SDF) pairs, each a posed molecule turned at random
    about its centroid in the pocket ``pocket(i, symbols, ligand
    coordinates)`` writes as (PDB text, size); the first n_train are the
    train split, the rest val."""
    from cmdgen_tpu_torch.chem.sdf import write_sdf

    rows, pdbs, sizes = [], [], []
    for i in range(n_train + n_val):
        symbols, xyz, mol = poses[i % len(poses)]
        q, _ = np.linalg.qr(rng.randn(3, 3))
        lig = (np.asarray(xyz, dtype=np.float64) - np.mean(xyz, axis=0)) @ q
        text, size = pocket(i, symbols, lig)
        pdb, sdf = tmp / f"pocket_{i}.pdb", tmp / f"ligand_{i}.sdf"
        pdb.write_text(text)
        write_sdf(sdf, [(symbols, lig, f"ligand_{i}")],
                  bonds_list=[[(b.a1, b.a2, b.order) for b in mol.bonds]])
        rows.append(f"{'train' if i < n_train else 'val'}\t{pdb}\t{sdf}")
        pdbs.append(pdb)
        sizes.append(size)
    tsv = tmp / "pairs.tsv"
    tsv.write_text("\n".join(rows) + "\n")
    return tsv, pdbs, sizes


def complex_pairs(tmp, poses, rng, n_train, n_val):
    """``write_pairs`` with pockets of 80-130 residues
    (``realistic_ca_pocket``'s CA positions 4.5-12 A from the centroid at 3
    A spacing; random residue types), each residue a CA and a side-chain
    tip 1.5-6.5 A from it toward the nearest ligand heavy atom, to within
    8 A of that atom: preprocessing's 8 A rule keeps every residue, so
    the pockets reach the model with 80-130 rows, as the train phase's."""
    from cmdgen_tpu_torch.utils.synthetic import realistic_ca_pocket

    aas = ["ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE",
           "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL"]

    def pocket(i, symbols, lig):
        heavy = lig[[s != "H" for s in symbols]]
        ca = realistic_ca_pocket(rng, rng.randint(80, 131), r_lo=4.5, r_hi=12.0,
                                 min_sep=3.0).astype(np.float64)
        d = np.linalg.norm(ca[:, None] - heavy[None], axis=-1)
        near, dn = heavy[d.argmin(1)], np.maximum(d.min(1), 1e-6)
        tip = ca + (near - ca) * (np.clip(dn - 6.5, 1.5, 6.5) / dn)[:, None]
        return "\n".join(
            f"{'ATOM':<6}{2 * j + a + 1:>5} {name:<4} {aa:>3} A{j + 1:>4}    "
            f"{p[0]:8.3f}{p[1]:8.3f}{p[2]:8.3f}{1.0:6.2f}{0.0:6.2f}          {'C':>2}"
            for j, aa in enumerate(aas[k] for k in rng.randint(20, size=len(ca)))
            for a, (name, p) in enumerate((("CA", ca[j]), ("CZ", tip[j])))) + "\nEND\n", len(ca)

    return write_pairs(tmp, poses, rng, n_train, n_val, pocket)


def parallel_phase(dev, repo, poses):
    """Data parallelism and FSDP at full width on a world of one (NCCL on
    the card), the ``parallel`` line and the path's K1 and K2 launches.

    ``preprocess`` through the CLI on PDB/SDF pairs of the align phase's
    posed molecules in synthetic CA pockets; ``ca_config`` with K=12
    (hidden 256, 5 layers, T=500, float32) from seeded weights takes
    PAR_STEPS steps at B=32 on that data three ways, the plain trainer,
    the dp path and FSDP, on the same batches and draws (each one's
    largest gap from the plain trainer against its limit);
    ``train_diffphar`` with FSDP, EMA and one eval epoch (K1 5 x 501 times
    in its sampling, 0 in its steps) and ``train-diffphar --fsdp`` through
    the CLI; ``sample-phars`` with both engines on the FSDP run's
    checkpoint; K1's calls of the first, middle and last denoiser call of
    the eval sampling and of ``sample-phars``, and K2's first call there,
    as the path made them, against their plain versions; a few sampling
    steps inside ``device_trace``, whose trace must name K1's kernel;
    receptor and ligand PDBQT of posed molecules, scored only where
    ``docking_available()``. Returns (the phase's record, the path's
    launches, its kernel checks)."""
    import dataclasses

    import torch

    from cmdgen_tpu_torch import cli, config as cfgmod, convert
    from cmdgen_tpu_torch.data.dataset import DiffPharDataset
    from cmdgen_tpu_torch.ops.egnn_fused import egnn_forward_fused
    from cmdgen_tpu_torch.ops.egnn_msgpass import gcl_message_agg
    from cmdgen_tpu_torch.parallel import check, launch
    from cmdgen_tpu_torch.pipeline import docking
    from cmdgen_tpu_torch.train import diffphar_train as dt
    from cmdgen_tpu_torch.train import state as tstate
    from cmdgen_tpu_torch.utils.profiling import TRACE_FILE, device_trace

    out = {"card": card_line()}
    t_phase = time.perf_counter()
    cfg = diffphar_configs()["k12"]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        pairs = tmp / "pairs"
        pairs.mkdir()
        tsv, pdbs, residues = complex_pairs(pairs, poses, np.random.RandomState(5), PAR_TRAIN,
                                            PAR_VAL)
        data = tmp / "data"
        with contextlib.redirect_stdout(io.StringIO()):
            stats, ms = synced_ms(lambda: cli.main([
                "preprocess", str(tsv), str(data), "--dataset", "crossdock",
                "--representation", "CA"]))
        ds = DiffPharDataset(data / "train.npz")
        kept = sorted(np.concatenate([DiffPharDataset(data / f"{split}.npz").sizes()[1]
                                      for split in ("train", "val")]).tolist())
        if not (stats["n_failed"] == 0 and stats["splits"] == {"train": PAR_TRAIN, "val": PAR_VAL}
                and (data / "size_distribution.npy").exists() and kept == sorted(residues)):
            raise AssertionError(f"preprocess: {stats}; pocket rows {kept}, residues "
                                 f"{sorted(residues)}")
        out["preprocess"] = dict(stats, ms=ms, pocket_rows=ds.n_pocket_max,
                                 pocket_rows_range=[kept[0], kept[-1]], phar_slots=ds.n_phar_max)
        log(f"preprocess ({PAR_TRAIN + PAR_VAL} PDB/SDF pairs, CA): {stats['splits']} in "
            f"{ms:.0f} ms; every residue kept ({kept[0]}-{kept[-1]} a pocket), padded to "
            f"{ds.n_pocket_max} pocket rows, {ds.n_phar_max} pharmacophore slots")

        world = launch.init_process_group(dev)
        out["world"] = {"rank": world.rank, "size": world.size, "device": str(world.device),
                        "backend": torch.distributed.get_backend()}
        model = dt.build_model(cfg, None, dev, torch.Generator().manual_seed(0))
        leaves = convert.model_leaves(model)
        batches, draws = [], []
        for i in range(PAR_STEPS):
            rows = [(i * PAR_B + j) % len(ds) for j in range(PAR_B)]
            b = ds.padded_batch(rows)
            arrays = [b[k] for k in ("phar_x", "phar_h", "phar_mask", "pocket_x", "pocket_h",
                                     "pocket_mask")]
            phar, pocket = check.clouds(arrays, dev)
            gen = torch.Generator(device=dev).manual_seed(10 + i)
            draws.append([d.cpu().numpy() for d in tstate.draw_loss_noise(model, phar, pocket,
                                                                           gen)])
            batches.append(arrays)
        del model
        runs = {}
        for name, layout in (("plain", None), ("dp", {"dp": None}),
                             ("fsdp", {"dp": None, "fsdp": True})):
            runs[name], ms = synced_ms(lambda: check.steps(
                cfgmod.to_dict(cfg), leaves, batches, draws, layout=layout, ema_decay=0.999,
                lr=cfg.train.lr, device=dev.type))
            runs[name]["ms"] = ms
        plain = runs["plain"]
        out["steps"] = {"batch": PAR_B, "steps": PAR_STEPS, "neighbor_k": K,
                        "losses": plain["losses"], "plain_ms": plain["ms"],
                        "plain_step_ms": plain["step_ms"]}
        for name in ("dp", "fsdp"):
            got = runs[name]
            w_gap = max(float(np.abs(got[key][k] - plain[key][k]).max())
                        for key in ("params", "ema") for k in plain[key])
            l_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], plain["losses"]))
            rec = {"max_weight_gap": w_gap, "weight_atol": PAR_W_ATOL,
                   "max_loss_rel_gap": l_gap, "loss_rtol": PAR_LOSS_RTOL,
                   "ms": got["ms"], "step_ms": got["step_ms"],
                   "sharded_leaves": sum(bool(v) for v in got["placements"].values())}
            out["steps"][name] = rec
            log(f"{PAR_STEPS} steps {name} vs the plain trainer (K=12, B={PAR_B}, world 1 "
                f"{out['world']['backend']}): weights {w_gap:.3g} (limit {PAR_W_ATOL}), loss "
                f"{l_gap:.3g} (limit {PAR_LOSS_RTOL}); {rec['sharded_leaves']} leaves sharded; "
                f"{got['ms']:.0f} ms ({plain['ms']:.0f} plain); steps after the first "
                f"{[round(t, 1) for t in got['step_ms'][1:]]} ms "
                f"({[round(t, 1) for t in plain['step_ms'][1:]]} plain)")
            if not (w_gap <= PAR_W_ATOL and l_gap <= PAR_LOSS_RTOL):
                raise AssertionError(f"{name} steps apart from the plain trainer: {rec}")
        if not out["steps"]["fsdp"]["sharded_leaves"]:
            raise AssertionError("FSDP sharded no weight")
        log(f"parallel phase: preprocess and steps done at {time.perf_counter() - t_phase:.1f} s")

        # train_diffphar under FSDP: EMA, one epoch, eval sampling through K1
        fcfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, fsdp=True, batch_size=PAR_B, n_epochs=1, eval_epochs=1,
            ema_decay=0.999))
        ck = tmp / "run_fsdp"
        logs, in_sampling, k1_kept = [], [], []
        real_sample = dt.sampling_metrics
        n_layers = cfg.dynamics.egnn.n_layers

        def counted_sample(*a, **kw):
            before = launch_counts()
            with kernel_calls_kept(k1_calls_of_steps(n_layers, cfg.ddpm.timesteps + 1),
                                   ()) as (k1_calls, _):
                res = real_sample(*a, **kw)
            in_sampling.append({k: v - before[k] for k, v in launch_counts().items()})
            k1_kept.extend(k1_calls)
            return res

        launch_counts(reset=True)
        dt.sampling_metrics = counted_sample
        try:
            with contextlib.redirect_stderr(io.StringIO()):
                st, ms = synced_ms(lambda: dt.train_diffphar(
                    fcfg, data, ck, log_fn=lambda s, m: logs.append(m), device=dev))
        finally:
            dt.sampling_metrics = real_sample
        k1_total = gcl_message_agg.launches  # the validation's forward passes too
        # the calls kept run op by op: one launch a block a call, no capture
        want = launches_want("msgpass", n_layers, cfg.ddpm.timesteps + 1)
        k1_train = sum(c["gcl_message_agg"] for c in in_sampling)
        k3_train = sum(c["coord_update_agg"] for c in in_sampling)
        sampled = [m for m in logs if "sampling/kl_types" in m]
        if not (st.step == PAR_TRAIN // PAR_B and in_sampling == [want]
                and egnn_forward_fused.launches == 0 and len(sampled) == 1
                and np.isfinite(sampled[0]["sampling/kl_types"])):
            raise AssertionError(f"train_diffphar FSDP: {st.step} steps, K1 in sampling "
                                 f"{in_sampling} (expected [{want}]), {logs}")
        files = sorted(p.name for p in (ck / "best").iterdir())
        if files != ["config.json", "ema_params.npz", "opt_state.npz", "params.npz"]:
            raise AssertionError(f"FSDP best/ holds {files}")
        vals = [m["loss/val"] for m in logs if "loss/val" in m]
        out["train_fsdp"] = {"steps": st.step, "ms": ms, "k1_launches_eval_sampling": k1_train,
                             "k3_launches_eval_sampling": k3_train,
                             "k1_launches_total": k1_total, "val_loss": vals,
                             "sampling": sampled}
        log(f"train_diffphar FSDP (K=12, B={PAR_B}, EMA): {st.step} steps, validation and one "
            f"eval sampling in {ms:.0f} ms; K1 {k1_train} launches, K3 {k3_train}; val {vals}")
        del st
        ck_cli = tmp / "run_fsdp_cli"
        with contextlib.redirect_stderr(io.StringIO()):
            st, ms = synced_ms(lambda: cli.main([
                "train-diffphar", str(data), str(ck_cli), "--config", "ca", "--neighbor-k",
                str(K), "--batch-size", str(PAR_B), "--max-steps", str(PAR_CLI_STEPS),
                "--fsdp", "--device", "cuda"]))
        meta = json.loads((ck_cli / "last.json").read_text())
        if not (st.step == meta["step"] == PAR_CLI_STEPS and np.isfinite(meta["monitor"])):
            raise AssertionError(f"train-diffphar --fsdp: {st.step} steps, {meta}")
        out["cli_fsdp"] = {"ms": ms, "steps": PAR_CLI_STEPS, "val_loss": meta["monitor"]}
        log(f"train-diffphar --fsdp CLI (K=12, B={PAR_B}): {PAR_CLI_STEPS} steps and "
            f"validation in {ms:.0f} ms")
        del st
        t_sp = min(100, cfg.ddpm.timesteps)  # trained_sample_phars' T
        with kernel_calls_kept(k1_calls_of_steps(n_layers, t_sp + 1), {0}) as (k1_sp, k2_kept):
            out["sample_phars"] = trained_sample_phars(ck, dev, cfg)
        # K2 on the first call's inputs only, as in the train phase
        k1_checks, k2_checks = check_kernel_calls(k1_kept + k1_sp, k2_kept, "float32")
        if not (len(k1_kept) == len(k1_sp) == 3 * n_layers and len(k2_kept) == 1):
            raise AssertionError(f"kept {len(k1_kept)} + {len(k1_sp)} K1 calls, {len(k2_kept)} K2")
        shapes = {"eval_sampling": list(k1_kept[0][0].shape),
                  "sample_phars": list(k1_sp[0][0].shape), "neighbor_k": K, "dtype": "float32"}
        checks = {"k1": {"shape": shapes, "calls": len(k1_checks), "comparisons": k1_checks},
                  "k2": {"shape": list(k2_kept[0][0][1].shape), "calls": len(k2_kept),
                         "comparisons": k2_checks}}
        out["kernel_checks"] = {k: {"shape": v["shape"], "calls": v["calls"],
                                    "worst": max(c["max_abs_err"] / c["tol"]
                                                 for c in v["comparisons"])}
                                for k, v in checks.items()}
        log(f"the parallel path's K1 calls (eval sampling and sample-phars, [B, N, H] "
            f"{shapes}) and K2's first: {out['kernel_checks']}")

        # a few sampling steps traced
        trace_dir = tmp / "trace"
        launch_counts(reset=True)
        with device_trace(trace_dir):
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(["sample-phars", str(ck), str(pdbs[0]), str(tmp / "traced.json"),
                          "--resi-list", *[f"A:{j}" for j in range(1, 31)], "--n-samples", "8",
                          "--timesteps", str(PAR_TRACE_T), "--device", "cuda"])
            torch.cuda.synchronize()
        counts = launch_counts()
        k1_traced, k3_traced = counts["gcl_message_agg"], counts["coord_update_agg"]
        trace = json.loads((trace_dir / TRACE_FILE).read_text())
        named, k3_named = (sum(1 for e in trace["traceEvents"] if kernel in str(e.get("name", "")))
                           for kernel in (K1_KERNEL, K3_KERNEL))
        if not (named and named == k1_traced and k3_named == k3_traced == k1_traced):
            raise AssertionError(f"trace: {named} events of K1's kernel, {k1_traced} launches; "
                                 f"{k3_named} of K3's, {k3_traced} launches")
        out["trace"] = {"events": len(trace["traceEvents"]), "k1_kernel_events": named,
                        "k1_launches": k1_traced, "k3_kernel_events": k3_named,
                        "k3_launches": k3_traced,
                        "bytes": (trace_dir / TRACE_FILE).stat().st_size}
        log(f"device_trace of sample-phars at T={PAR_TRACE_T}: {out['trace']}")

        # docking preparation of posed molecules
        dock = tmp / "dock"
        dock.mkdir()
        rec = docking.prepare_receptor_pdbqt(pdbs[0], dock / "receptor.pdbqt")
        atoms = 0
        for i, (_, xyz, mol) in enumerate(poses[:PAR_PDBQT]):
            path = dock / f"ligand_{i}.pdbqt"  # in the align phase's frame
            docking.write_pdbqt(path, mol, np.asarray(xyz, dtype=np.float64))
            atoms += sum(1 for line in path.read_text().splitlines() if line.startswith("ATOM"))
        ran = docking.docking_available()
        scores = [docking.calculate_qvina2_score(rec, mol, np.asarray(xyz, dtype=np.float64),
                                                 dock / f"qvina_{i}")
                  for i, (_, xyz, mol) in enumerate(poses[:PAR_PDBQT])] if ran else None
        receptor_atoms = len(rec.read_text().splitlines())
        if not (receptor_atoms and atoms):
            raise AssertionError(f"PDBQT: receptor {receptor_atoms} lines, ligands {atoms} atoms")
        out["docking"] = {"ligands": min(PAR_PDBQT, len(poses)), "ligand_atoms": atoms,
                          "receptor_lines": receptor_atoms, "scored": ran, "scores": scores}
        log(f"docking prep: receptor {receptor_atoms} lines, {out['docking']['ligands']} "
            f"ligands ({atoms} atoms); scoring {'ran' if ran else 'not run (no binary)'}")
    launch.destroy_process_group()
    out["seconds"] = time.perf_counter() - t_phase
    launches = {"gcl_message_agg": k1_train,
                "egnn_forward_fused":
                    out["sample_phars"]["fused"]["launches"]["egnn_forward_fused"],
                "coord_update_agg": k3_train}
    return out, launches, checks


def full_atom_pairs(tmp, poses, rng, n_train, n_val):
    """``write_pairs`` with full-atom pockets (``full_atom_pocket_pdb``:
    FA_RESIDUES residues around the ligand, those within 8 A of it kept,
    at most a drawn number of atoms in FA_ATOMS, the first at
    FA_ATOMS[1])."""
    from cmdgen_tpu_torch.utils.synthetic import full_atom_pocket_pdb

    def pocket(i, symbols, lig):
        cap = FA_ATOMS[1] if i == 0 else rng.randint(FA_ATOMS[0], FA_ATOMS[1] + 1)
        return full_atom_pocket_pdb(rng, symbols, lig, FA_RESIDUES, max_atoms=cap)

    return write_pairs(tmp, poses, rng, n_train, n_val, pocket)


def full_atom_phase(dev, repo, poses):
    """The CLI's default DiffPhar configuration on the card at its full
    width, through both kernels; the ``full_atom`` line, the path's
    launches and its kernel records (the kernels line's ``full_atom_shape``).

    ``preprocess`` at its defaults (``crossdock_full``, ``full-atom``) on
    FA_TRAIN + FA_VAL PDB/SDF pairs of the align phase's posed molecules in
    full-atom pockets; ``train-diffphar`` at its defaults (``--config
    full``: dense, B=8, float32) for FA_STEPS steps with validation and
    checkpoints, each step timed with its peak memory, the last one
    profiled, K1 and K2 launched 0 times in them, and a step on the
    smallest and on the middle pockets; ``sample-phars`` on its
    checkpoint, FA_SAMPLES clouds at T=FA_T: dense on pockets of
    FA_DENSE_ATOMS atoms (peak memory by pocket size), ``--neighbor-k
    FA_K`` (K1) and ``--neighbor-k FA_K --engine fused`` (K2) on the
    largest, their launches counted from 0 around each run; K1's calls of
    the first, middle and last denoiser call and K2's first, as the path
    made them, against their plain versions and timed."""
    import dataclasses

    import torch

    from cmdgen_tpu_torch import cli, config as cfgmod
    from cmdgen_tpu_torch.data.dataset import DiffPharDataset
    from cmdgen_tpu_torch.train import state as tstate
    from cmdgen_tpu_torch.train.diffphar_train import build_model, to_clouds
    from cmdgen_tpu_torch.utils.synthetic import full_atom_pocket_pdb

    out = {"card": card_line()}
    t_phase = time.perf_counter()
    cfg = cfgmod.full_atom_config()
    ecfg = dataclasses.replace(cfg.dynamics.egnn, neighbor_k=FA_K)
    n_layers = ecfg.n_layers
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        pairs = tmp / "pairs"
        pairs.mkdir()
        tsv, _, atoms = full_atom_pairs(pairs, poses, np.random.RandomState(6), FA_TRAIN,
                                        FA_VAL)
        data = tmp / "data"
        with contextlib.redirect_stdout(io.StringIO()):
            stats, ms = synced_ms(lambda: cli.main(["preprocess", str(tsv), str(data)]))
        sets = [DiffPharDataset(data / f"{split}.npz") for split in ("train", "val")]
        kept = sorted(np.concatenate([d.sizes()[1] for d in sets]).tolist())
        classes = np.concatenate([np.concatenate(d.pocket_one_hot) for d in sets]).sum(0)
        if not (stats["n_failed"] == 0 and stats["splits"] == {"train": FA_TRAIN, "val": FA_VAL}
                and kept == sorted(atoms) and classes.shape == (11,)
                and set(np.flatnonzero(classes)) == {0, 1, 2, 3}):
            raise AssertionError(f"preprocess (full-atom): {stats}; pocket atoms {kept}, "
                                 f"written {sorted(atoms)}; element classes {classes}")
        ds = sets[0]
        out["preprocess"] = dict(
            stats, ms=ms, pocket_atoms=kept,
            pocket_atoms_quartiles=np.percentile(kept, [0, 25, 50, 75, 100]).tolist(),
            element_class_atoms=dict(zip(("C", "N", "O", "S"), classes[:4].astype(int).tolist())),
            pocket_rows=ds.n_pocket_max, phar_slots=ds.n_phar_max)
        log(f"preprocess (full-atom, {FA_TRAIN + FA_VAL} pairs): {stats['splits']} in {ms:.0f} "
            f"ms; pocket atoms {kept[0]}-{kept[-1]} (median {np.median(kept):.0f}), C/N/O/S "
            f"{classes[:4].astype(int).tolist()}; padded to {ds.n_pocket_max} pocket rows, "
            f"{ds.n_phar_max} pharmacophore slots")

        # train-diffphar at its defaults, every step timed
        steps, prof = [], {}
        real_make = tstate.make_diffusion_train_step

        def timed_make(*a, **kw):
            step = real_make(*a, **kw)

            def timed(*sa, **skw):
                before = sum(launch_counts().values())
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                if len(steps) == FA_STEPS - 1:
                    res = []
                    prof.update(device_profile(lambda: res.append(step(*sa, **skw)), 1, top=5))
                    res, ms = res[0], prof["wall_ms"]
                else:
                    res, ms = synced_ms(lambda: step(*sa, **skw))
                steps.append({"ms": ms, "max_memory_allocated": torch.cuda.max_memory_allocated(),
                              "kernel_launches": sum(launch_counts().values()) - before})
                return res

            return timed

        ck = tmp / "run_full"
        tstate.make_diffusion_train_step = timed_make
        try:
            with contextlib.redirect_stderr(io.StringIO()):
                st, ms = synced_ms(lambda: cli.main([
                    "train-diffphar", str(data), str(ck), "--max-steps", str(FA_STEPS),
                    "--device", "cuda"]))
        finally:
            tstate.make_diffusion_train_step = real_make
        meta = json.loads((ck / "last.json").read_text())
        saved = json.loads((ck / "last" / "config.json").read_text())
        if not (st.step == meta["step"] == len(steps) == FA_STEPS and np.isfinite(meta["monitor"])
                and not any(s["kernel_launches"] for s in steps)
                and saved == cfgmod.to_dict(cfg)):
            raise AssertionError(f"train-diffphar (full-atom defaults): {st.step} steps, "
                                 f"{meta}, steps {steps}")
        del st
        torch.cuda.empty_cache()
        timed = [s["ms"] for s in steps[1:-1]]
        out["train"] = {
            "cli_ms": ms, "steps": FA_STEPS, "batch": cfg.train.batch_size,
            "node_rows": [ds.n_phar_max, ds.n_pocket_max], "engine": "dense",
            "ms_per_step": float(np.median(timed)), "step_ms": [s["ms"] for s in steps],
            "max_memory_allocated": max(s["max_memory_allocated"] for s in steps),
            "step_max_memory_allocated": [s["max_memory_allocated"] for s in steps],
            "profile": prof, "val_loss": meta["monitor"]}
        log(f"train-diffphar at its defaults (full, dense, B={cfg.train.batch_size}, [phar, "
            f"pocket] rows {out['train']['node_rows']}): {FA_STEPS} steps and validation in "
            f"{ms:.0f} ms; steps {[round(t, 1) for t in out['train']['step_ms']]} ms, peak "
            f"{out['train']['max_memory_allocated'] / 2**30:.2f} GiB, busy "
            f"{prof['busy_share']:.2f}, top {prof['top_kernels_ms']}; val {meta['monitor']:.4g}")

        # the same steps on the 8 smallest and the 8 middle pockets, each
        # batch padded to its largest: memory by pocket rows
        model = build_model(cfg, np.load(data / "size_distribution.npy"), dev,
                            torch.Generator().manual_seed(0))
        st = tstate.init_state(model, tstate.reference_optimizer(model.parameters(),
                                                                 cfg.train.lr))
        step = tstate.make_diffusion_train_step(cfg.train.clip_grad)
        sizes = ds.sizes()[1]
        order, bs = np.argsort(sizes), cfg.train.batch_size
        by_size = {}
        for rows in (order[:bs], order[(len(order) - bs) // 2:][:bs]):
            cap = int(sizes[rows].max())
            phar, pocket = to_clouds(ds.padded_batch(rows.tolist(), n_pocket_max=cap), dev)
            gen = torch.Generator(device=dev).manual_seed(0)
            step(st, phar, pocket, generator=gen)  # warm
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _, ms = synced_ms(lambda: step(st, phar, pocket, generator=gen))
            by_size[cap] = {"ms": ms, "max_memory_allocated": torch.cuda.max_memory_allocated()}
        by_size[ds.n_pocket_max] = {"ms": out["train"]["ms_per_step"],
                                    "max_memory_allocated": out["train"]["max_memory_allocated"]}
        out["train"]["by_pocket_rows"] = by_size
        del model, st, step
        torch.cuda.empty_cache()
        log(f"train steps by pocket rows (B={bs}, dense): " + ", ".join(
            f"{n}: {r['ms']:.1f} ms, {r['max_memory_allocated'] / 2**30:.2f} GiB"
            for n, r in by_size.items()))

        # sample-phars on the checkpoint: dense by pocket size, then K1 and K2
        ligand = poses[0]
        lig = np.asarray(ligand[1], dtype=np.float64) - np.mean(ligand[1], axis=0)
        pdbs = {}
        for n_atoms in FA_DENSE_ATOMS:
            text, n = full_atom_pocket_pdb(np.random.RandomState(n_atoms), ligand[0], lig,
                                           FA_RESIDUES, max_atoms=n_atoms)
            pdbs[n] = tmp / f"sample_pocket_{n}.pdb"
            pdbs[n].write_text(text)
        largest = max(pdbs)
        sampling = {"batch": FA_SAMPLES, "timesteps": FA_T, "dense": {}}

        def sample(pdb, flags, name):
            launch_counts(reset=True)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            with contextlib.redirect_stdout(io.StringIO()):
                _, ms = synced_ms(lambda: cli.main([
                    "sample-phars", str(ck), str(pdb), str(tmp / f"{name}.json"),
                    "--ref-ligand", "L:1", "--n-samples", str(FA_SAMPLES), "--timesteps",
                    str(FA_T), "--device", "cuda", *flags]))
            rec = {"ms": ms, "max_memory_allocated": torch.cuda.max_memory_allocated(),
                   "launches": launch_counts()}
            mols = json.loads((tmp / f"{name}.json").read_text())
            pts = np.array([p for m in mols.values() for f in m.values() for p in f])
            if len(mols) != FA_SAMPLES or not (len(pts) and np.isfinite(pts).all()):
                raise AssertionError(f"sample-phars {name}: {len(mols)} clouds, {len(pts)} points")
            rec["points"] = len(pts)
            log(f"sample-phars {name} (B={FA_SAMPLES}, T={FA_T}): {ms:.0f} ms, peak "
                f"{rec['max_memory_allocated'] / 2**30:.2f} GiB, launches {rec['launches']}")
            return rec

        for n in sorted(pdbs):
            rec = sample(pdbs[n], [], f"dense_{n}")
            if any(rec["launches"].values()):
                raise AssertionError(f"dense sampling launched a kernel: {rec['launches']}")
            sampling["dense"][n] = rec
        calls = FA_T + 1
        with kernel_calls_kept(k1_calls_of_steps(n_layers, calls), ()) as (k1_kept, _):
            sampling["msgpass"] = sample(pdbs[largest], ["--neighbor-k", str(FA_K)], "msgpass")
        with kernel_calls_kept((), {0}) as (_, k2_kept):
            sampling["fused"] = sample(pdbs[largest], ["--neighbor-k", str(FA_K), "--engine",
                                                       "fused"], "fused")
        want = {e: launches_want(e, n_layers, calls) for e in ("msgpass", "fused")}
        got = {e: sampling[e]["launches"] for e in want}
        if got != want or not (len(k1_kept) == 3 * n_layers and len(k2_kept) == 1):
            raise AssertionError(f"sample-phars launches {got}, expected {want}; kept "
                                 f"{len(k1_kept)} K1 and {len(k2_kept)} K2 calls")
        sampling["pocket_atoms"] = largest
        out["sampling"] = sampling

        # the path's kernel calls against their plain versions, and timed
        k1_checks, k2_checks = check_kernel_calls(k1_kept, k2_kept, "float32")
        shape = {"batch": k2_kept[0][0][1].shape[0], "node_rows": k2_kept[0][0][1].shape[1],
                 "pocket_atoms": largest, "hidden": ecfg.hidden_nf, "layers": n_layers,
                 "neighbor_k": FA_K, "dtype": "float32"}
        log(f"K1 and K2 at the full-atom shape {shape}: {len(k1_kept)} K1 calls, 1 K2 call")
        k1, k2 = time_kernel_calls(k1_kept[0], k2_kept[0], "float32", ecfg, k1_checks, k2_checks)
        out["kernel_checks"] = {name: {"calls": len(kept), "worst": max(
            x["max_abs_err"] / x["tol"] for x in c)}
            for name, kept, c in (("k1", k1_kept, k1_checks), ("k2", k2_kept, k2_checks))}
        log(f"the full-atom path's kernel checks: {out['kernel_checks']}")
    out["seconds"] = time.perf_counter() - t_phase
    launches = {"gcl_message_agg": sampling["msgpass"]["launches"]["gcl_message_agg"],
                "egnn_forward_fused": sampling["fused"]["launches"]["egnn_forward_fused"],
                "coord_update_agg": sampling["msgpass"]["launches"]["coord_update_agg"]}
    return out, launches, {"k1": dict(k1, shape=shape), "k2": dict(k2, shape=shape)}


def align_phase(dev, repo, posp, smiles):
    """Stage 4 on the card: the decode phase's unique valid SMILES aligned
    onto its hypothesis in run-all's chunks (first chunk apart from the
    warm ones), card vs CPU on one chunk with the same draws, a warm chunk
    profiled at 100 and at 0 refinement steps, and the align CLI once.
    Returns (the phase's record, [(element symbols, posed coordinates,
    molecule)] of up to ``EVAL_POSES`` aligned molecules)."""
    import torch

    from cmdgen_tpu_torch import cli
    from cmdgen_tpu_torch.chem.sdf import read_sdf
    from cmdgen_tpu_torch.device import make_generator
    from cmdgen_tpu_torch.ops import dgeom
    from cmdgen_tpu_torch.pipeline import align as al

    pp, types = al.load_pp_points(posp)
    t0 = time.perf_counter()
    entries = al.prepare_align_entries(smiles, types)
    prep_ms = (time.perf_counter() - t0) * 1e3
    chunks = al.align_chunks(entries, ALIGN_BUCKET, ALIGN_CHUNK)
    if not chunks:
        raise AssertionError(f"align: none of {len(smiles)} SMILES matched {types}")
    gen = make_generator(dev, 0)
    kw = dict(n_conformers=ALIGN_C, num_keep=ALIGN_C, refine_steps=ALIGN_STEPS,
              bucket=ALIGN_BUCKET)
    results, calls, kept_by_chunk = {}, [], []
    for chunk in chunks:
        res, ms = synced_ms(lambda: al.align_entries(chunk, pp, gen, **kw))
        results.update(res)
        calls.append((len(chunk), ms))
        kept_by_chunk.append(sum(len(r) for r in res.values()))
    mols = {idx: mol for idx, mol, _ in entries}
    kept = sum(len(r) for r in results.values())
    best = [r[0] for r in results.values()]
    warm = calls[1:] or calls
    out = {"smiles": len(smiles), "hypothesis_points": len(types), "matched": len(entries),
           "aligned": len(results), "chunks": len(chunks), "prep_ms": prep_ms,
           "first_chunk": {"molecules": calls[0][0], "ms": calls[0][1]},
           "warm_chunk_ms": [c[1] for c in calls[1:]],
           "conformers_per_s": sum(n for n, _ in warm) * ALIGN_C / sum(ms for _, ms in warm) * 1e3,
           "dropped_conformers": len(entries) * ALIGN_C - kept,
           "kept_conformers": kept,
           "median_best_rmsd": float(np.median([e for e, _ in best])) if best else None,
           "median_bounds_violation": float(np.median(
               [dgeom.bounds_violation(mols[i], r[0][1]) for i, r in results.items()])) if best else None}
    log(f"align: {len(smiles)} SMILES, {len(entries)} matched the {len(types)}-point "
        f"hypothesis, {len(results)} aligned in {len(chunks)} chunks; first chunk "
        f"{calls[0][1]:.1f} ms, {out['conformers_per_s']:.0f} conformers/s warm; "
        f"{out['dropped_conformers']} of {len(entries) * ALIGN_C} conformers dropped (not finite "
        f"or RMSD >= {al.MAX_RMSD:g} Å)")

    # card vs CPU: align_entries on the chunk that kept the most conformers
    # (most diverge on these hypotheses; a diverged one is compared only as
    # dropped on both), the same draws fed to both, every conformer kept
    chunk = chunks[int(np.argmax(kept_by_chunk))]
    (n_pad,) = al.size_buckets(chunk, ALIGN_BUCKET)  # a chunk is one bucket
    draws = dgeom.embed_draws(len(chunk), ALIGN_C, n_pad, torch.Generator().manual_seed(1), "cpu")
    embed_draws = dgeom.embed_draws

    def fixed_draws(m, c, nb, generator=None, device=None):
        if (m, c, nb) != tuple(draws[0].shape[:3]):
            raise AssertionError(f"align_entries drew ({m}, {c}, {nb}), not {draws[0].shape}")
        return tuple(v.to(device) for v in draws)

    res = []
    dgeom.embed_draws = fixed_draws
    try:
        for d in ("cpu", dev):
            res.append(al.align_entries(chunk, pp, device=d, **kw))
    finally:
        dgeom.embed_draws = embed_draws
    cpu_res, dev_res = res
    apart = sorted(set(cpu_res) ^ set(dev_res)) + [
        i for i in cpu_res if i in dev_res and len(cpu_res[i]) != len(dev_res[i])]
    pairs = [(a, b) for i in cpu_res if i in dev_res and i not in apart
             for a, b in zip(cpu_res[i], dev_res[i])]
    rmsd_err = max((abs(b[0] - a[0]) for a, b in pairs), default=0.0)
    ref_max = max((np.abs(a[1]).max() for a, _ in pairs), default=1.0)
    coord_rel = max((np.abs(b[1] - a[1]).max() for a, b in pairs), default=0.0) / ref_max
    out["card_vs_cpu"] = {"molecules": len(chunk), "atoms_padded": n_pad,
                          "kept_both": len(pairs), "molecules_apart": len(apart),
                          "rmsd_max_abs_err": float(rmsd_err), "coords_rel_err": float(coord_rel)}
    log(f"align_entries card vs CPU ({len(chunk)} molecules x {ALIGN_C} conformers, same "
        f"draws): {out['card_vs_cpu']}")
    if not pairs or apart or rmsd_err > ALIGN_RMSD_TOL or coord_rel > ALIGN_REL:
        raise AssertionError(f"align disagrees with the CPU: {out['card_vs_cpu']}")

    # one warm chunk (the largest) profiled at 100 and at 0 refinement steps
    chunk = max(chunks, key=len)
    prof = {}
    for steps in (ALIGN_STEPS, 0):
        prof[steps] = device_profile(lambda: al.align_entries(
            chunk, pp, gen, **dict(kw, refine_steps=steps)), 1)
    out["profile"] = dict(prof[ALIGN_STEPS], molecules=len(chunk),
                          device_ops_per_refine_step=(prof[ALIGN_STEPS]["device_ops"]
                                                      - prof[0]["device_ops"]) / ALIGN_STEPS,
                          device_ops_without_refinement=prof[0]["device_ops"],
                          wall_us_per_device_op=prof[ALIGN_STEPS]["wall_ms"] * 1e3
                          / prof[ALIGN_STEPS]["device_ops"])
    log(f"align profile (one chunk of {len(chunk)}): {json.dumps(out['profile'])}")

    # the align CLI once through on the card
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "smiles.txt").write_text("\n".join(smiles) + "\n")
        with contextlib.redirect_stdout(io.StringIO()):  # its {SMILES: RMSD} line
            best_cli, ms = synced_ms(lambda: cli.main([
                "align", str(tmp / "smiles.txt"), str(posp), str(tmp / "out"), "--n-conformers",
                str(ALIGN_C), "--seed", "0", "--device", "cuda"]))
        rmsds = np.load(tmp / "out" / "rmsd_values.npy")
        sdfs = sorted((tmp / "out").glob("mol_*.sdf"))
        for f in sdfs:
            back = read_sdf(f)
            if not back or not all(np.isfinite(c).all() for _, c in back):
                raise AssertionError(f"align CLI: {f.name} does not parse")
    if not (len(sdfs) == len(rmsds) == len(best_cli) > 0 and np.isfinite(rmsds).all()):
        raise AssertionError(f"align CLI: {len(sdfs)} SDFs, {len(rmsds)} RMSDs, "
                             f"{len(best_cli)} molecules")
    out["cli"] = {"ms": ms, "aligned": len(best_cli), "median_rmsd": float(np.median(rmsds))}
    log(f"align CLI: {len(best_cli)} molecules posed in {ms:.0f} ms")
    # up to EVAL_POSES posed molecules (heavy atoms, best conformer) for
    # the evaluate phase's pose PDBs
    poses = [([a.symbol for a in mols[i].atoms], r[0][1], mols[i])
             for i, r in sorted(results.items())[:EVAL_POSES]]
    return out, poses


def run_all_phase(dev, repo):
    """run-all through the CLI on the trained qrun_aa and grun_r5cn, two
    synthetic pockets: msgpass, msgpass with --keep-top-match 0.25, fused.
    Each run's stats, validity = valid/raw, aligned molecules/min and the
    kernels' launches (counts set to 0 just before the run). First K1 and
    K2 at the shapes run-all gives them, against their plain versions
    (``run_all_kernels``, on the first pocket)."""
    from cmdgen_tpu_torch import cli
    from cmdgen_tpu_torch.chem.mol import mol_from_smiles
    from cmdgen_tpu_torch.chem.sdf import read_sdf
    from cmdgen_tpu_torch.utils.synthetic import synthetic_pocket_pdb

    assets = repo / "cmdgen_tpu_torch" / "assets"
    runs = {"msgpass": [], "keep_top_match": ["--keep-top-match", "0.25"],
            "fused": ["--engine", "fused"]}
    out = {"settings": RUN_ALL_ARGS, "pockets": RUN_ALL_POCKETS,
           "cut_from_round_5": {"smiles_per_hypothesis": [2048, int(RUN_ALL_ARGS[
                                    RUN_ALL_ARGS.index("--smiles-per-hypothesis") + 1])],
                                "pockets": [8, RUN_ALL_POCKETS],
                                "pocket": "synthetic CA pockets, not CrossDocked test pockets"},
           "runs": {}}
    # per pocket: one sampling batch of T + 1 denoiser calls (qrun_aa: 3 GCLs)
    calls = (int(RUN_ALL_ARGS[RUN_ALL_ARGS.index("--timesteps") + 1]) + 1) * RUN_ALL_POCKETS
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        pdbs = []
        for i in range(RUN_ALL_POCKETS):
            pdbs.append(tmp / f"pocket_{i}.pdb")
            pdbs[-1].write_text(synthetic_pocket_pdb(np.random.RandomState(i)))
        out["kernels"] = run_all_kernels(dev, repo, pdbs[0])
        for name, extra in runs.items():
            out_dir = tmp / name
            launch_counts(reset=True)
            captures = graph_captures()
            (results, stats), ms = synced_ms(lambda: cli.main([
                "run-all", str(assets / "qrun_aa"), str(assets / "grun_r5cn"), str(out_dir),
                *map(str, pdbs), "--ref-ligand", "L:1", *RUN_ALL_ARGS, "--seed", "0",
                "--device", "cuda", *extra]))
            launches = launch_counts()
            expect = launches_want("fused" if name == "fused" else "msgpass", 3, calls, captures)
            if launches != expect:
                raise AssertionError(f"run-all {name}: launches {launches}, expected {expect}")
            validity = stats["valid_smiles"] / max(stats["raw_smiles"], 1)
            index = json.loads((out_dir / "results.json").read_text())
            for entry in index:
                back = read_sdf(out_dir / entry["file"])
                n = mol_from_smiles(entry["smiles"]).n_atoms
                if not back or any(m.n_atoms != n or not np.isfinite(c).all() for m, c in back):
                    raise AssertionError(f"run-all {name}: {entry['file']} does not parse")
                if not np.isfinite(entry["rmsd"]):
                    raise AssertionError(f"run-all {name}: RMSD {entry['rmsd']}")
            rec = dict(stats, validity=validity, ms=ms, launches=launches, written=len(index))
            out["runs"][name] = rec
            log(f"run-all {name}: {json.dumps(rec)}")
            if not (stats["aligned"] > 0 and validity >= RUN_ALL_VALID_MIN
                    and len(index) == len(results)):
                raise AssertionError(f"run-all {name}: aligned {stats['aligned']}, validity "
                                     f"{validity} (floor {RUN_ALL_VALID_MIN}), {len(index)} "
                                     f"written of {len(results)}")
    return out


def joint_phase(dev, repo, timesteps):
    """The joint model at full width: ``ca_config`` with
    ``train.mode="joint"`` and ``update_pocket_coords`` (hidden 256, 5
    layers, K=12, bf16, the flagship's seeded weights), a 110-CA pocket,
    8 pharmacophore slots, B=48. ``sample_pharmacophores``' joint branch
    (RePaint, the pocket fixed, resamplings 1, jump 1) at T=``timesteps``
    on both engines, launches counted (K1 5 per denoiser call, K2 1; T + 1
    calls); a profile of a few steps; the denoiser's inputs recorded at
    three steps of the msgpass chain, every K1 and K2 call there against
    its plain version (K2 over all 118 rows), the middle step's calls
    timed; in float32 (the same weights) the denoiser on those steps'
    inputs (limit relative to its output's scale) and a T=10 inpaint chain
    on the same draws, card against the CPU; ``sample-phars`` on a joint
    port checkpoint of these weights through the CLI."""
    import torch

    from cmdgen_tpu_torch import cli
    from cmdgen_tpu_torch.containers import PointCloud, mask_from_sizes
    from cmdgen_tpu_torch.convert import write_port_checkpoint
    from cmdgen_tpu_torch.diffusion.joint import JointDDPM
    from cmdgen_tpu_torch.models.dynamics import EGNNDynamics, make_fused_apply
    from cmdgen_tpu_torch.pipeline.sample_phars import sample_pharmacophores
    from cmdgen_tpu_torch.utils.synthetic import realistic_ca_pocket, synthetic_pocket_pdb

    cfg, dyn = flagship_dynamics(dev, torch.bfloat16, joint=True)
    ecfg = cfg.dynamics.egnn
    rng = np.random.RandomState(0)
    coords = realistic_ca_pocket(rng, N_Q)
    onehot = np.eye(20, dtype=np.float32)[rng.randint(0, 20, N_Q)]
    kw = dict(num_nodes=np.full(B, N_P), n_phar_max=N_P, batch_size=B)
    models = {e: JointDDPM(cfg.ddpm, dyn, apply_fn=make_fused_apply(dyn) if e == "fused" else None)
              for e in ("msgpass", "fused")}
    out = {"config": {"hidden": ecfg.hidden_nf, "layers": ecfg.n_layers, "neighbor_k": K,
                      "dtype": "bfloat16", "T": timesteps, "batch": B, "phar_slots": N_P,
                      "pocket_atoms": N_Q, "update_rows": N_P + N_Q}, "engines": {}}
    calls = timesteps + 1  # RePaint denoise ops (no jumps at resamplings 1) + the final decode
    for engine, model in models.items():
        gen = torch.Generator(device=dev).manual_seed(11)
        sample_pharmacophores(model, coords, onehot, B, timesteps=2, generator=gen, **kw)  # warm-up
        torch.cuda.synchronize()
        launch_counts(reset=True)
        captures = graph_captures()
        clouds, ms = synced_ms(lambda: sample_pharmacophores(
            model, coords, onehot, B, timesteps=timesteps, generator=gen, **kw))
        launches = launch_counts()
        want = launches_want(engine, L, calls, captures)
        if launches != want:
            raise AssertionError(f"joint {engine}: launches {launches}, expected {want}")
        pts = np.array([p for mol in clouds.values() for fam in mol.values() for p in fam])
        if len(clouds) != B or pts.shape != (B * N_P, 3) or not np.isfinite(pts).all():
            raise AssertionError(f"joint {engine}: {len(clouds)} clouds, points {pts.shape}")
        reach = float(np.linalg.norm(pts - coords.mean(0), axis=1).max())
        prof = device_profile(lambda: sample_pharmacophores(
            model, coords, onehot, B, timesteps=5, generator=gen, **kw), 2)
        rec = {"seconds": ms / 1e3, "denoise_steps_per_s": B * timesteps / (ms / 1e3),
               "launches": launches, "max_distance_from_pocket_centroid": reach,
               "profile_T5": prof}
        out["engines"][engine] = rec
        log(f"joint {engine}: B={B} T={timesteps} {ms / 1e3:.3f} s "
            f"{rec['denoise_steps_per_s']:.1f} denoise steps/s launches={launches}; "
            f"profile T=5: {json.dumps(prof)}")

    # the denoiser's inputs at three steps of the msgpass chain; every
    # kernel call there against its plain version
    model = models["msgpass"]
    recorded, seen = record_denoiser_inputs(dyn, calls, lambda: sample_pharmacophores(
        model, coords, onehot, B, timesteps=timesteps,
        generator=torch.Generator(device=dev).manual_seed(12), **kw))
    if seen != calls:
        raise AssertionError(f"joint: {seen} denoiser calls, expected {calls}")
    outs, k1_calls, k2_calls = recorded_kernel_calls(
        {"msgpass": dyn, "fused": models["fused"]._apply}, recorded)
    if (len(k1_calls), len(k2_calls)) != (len(recorded) * L, len(recorded)):
        raise AssertionError(f"joint: {len(k1_calls)} K1 and {len(k2_calls)} K2 calls recorded")
    log(f"K1 and K2 at the joint shape (steps {sorted(recorded)}; every row moves):")
    k1_checks, k2_checks = check_kernel_calls(k1_calls, k2_calls, "bfloat16")
    out["k1"], out["k2"] = time_kernel_calls(k1_calls[L], k2_calls[1], "bfloat16", ecfg,
                                             k1_checks, k2_checks)
    out["recorded_steps"] = sorted(recorded)

    # float32, the same weights: the denoiser on the recorded steps' inputs
    # (8 samples each) and a T=10 inpaint chain (4 samples), card vs CPU.
    # With random weights the chain does not denoise: z grows to ~1e5 by
    # the last steps, so each step's limit is DENOISER_TOL x max(1,
    # max|CPU output| at that step): absolute where the outputs are O(1)
    cfg32, dyn32 = flagship_dynamics(dev, torch.float32, joint=True)
    cpu_dyn = EGNNDynamics(cfg32.dynamics)
    cpu_dyn.load_state_dict({k: v.cpu() for k, v in dyn32.state_dict().items()})
    cpu_dyn.eval()
    inputs = {step: tuple(v[:8].float() for v in inp) for step, inp in recorded.items()}
    dev_outs, _, _ = recorded_kernel_calls({"msgpass": dyn32, "fused": make_fused_apply(dyn32)},
                                           inputs)
    by_step = denoiser_vs_cpu(dev_outs, cpu_dyn, inputs)
    errs = {engine: {str(step): {"max_abs_err": err, "ref_max": ref,
                                 "tol": DENOISER_TOL * max(1.0, ref)}
                     for step, err, ref in rows} for engine, rows in by_step.items()}
    b4 = 4
    mask_p = mask_from_sizes(torch.tensor([8, 8, 6, 5]), N_P)
    mask_q = torch.ones(b4, N_Q)
    pocket = PointCloud(x=torch.from_numpy(np.broadcast_to(coords, (b4, N_Q, 3)).copy()),
                        h=torch.from_numpy(np.broadcast_to(onehot, (b4, N_Q, 20)).copy()),
                        mask=mask_q)
    phar = PointCloud(x=torch.zeros(b4, N_P, 3), h=torch.zeros(b4, N_P, 8), mask=mask_p)
    g = torch.Generator().manual_seed(13)
    cpu_models = {e: JointDDPM(cfg32.ddpm, cpu_dyn,
                               apply_fn=make_fused_apply(cpu_dyn) if e == "fused" else None)
                  for e in ("msgpass", "fused")}
    draw = cpu_models["msgpass"]._sample_joint_noise
    noise = (draw(mask_p, mask_q, g), [(draw(mask_p, mask_q, g), draw(mask_p, mask_q, g))
                                       for _ in range(10)], draw(mask_p, mask_q, g))
    chain_err = {}
    for engine in ("msgpass", "fused"):
        card = JointDDPM(cfg32.ddpm, dyn32,
                         apply_fn=make_fused_apply(dyn32) if engine == "fused" else None)
        res = []
        for m, on in ((cpu_models[engine], "cpu"), (card, dev)):
            mv = [PointCloud(x=c.x.to(on), h=c.h.to(on), mask=c.mask.to(on)) for c in (phar, pocket)]
            res.append(m.inpaint(*mv, torch.zeros(b4, N_P, device=on),
                                 torch.ones(b4, N_Q, device=on), timesteps=10, noise=noise))
        if not all(torch.equal(a.h, b.h.cpu()) for a, b in zip(*res)):
            raise AssertionError(f"joint {engine} T=10 chain: types differ card vs CPU")
        chain_err[engine] = max((a.x - b.x.cpu()).abs().max().item() for a, b in zip(*res))
    out["float32_vs_cpu"] = {"denoiser": errs, "inpaint_T10": chain_err,
                             "inpaint_tol": DENOISER_TOL}
    log(f"joint float32 card vs CPU plain: denoiser by step {json.dumps(errs)}; T=10 inpaint "
        f"chain {chain_err} (tol {DENOISER_TOL})")
    if not (all(c["max_abs_err"] <= c["tol"] for e in errs.values() for c in e.values())
            and all(e <= DENOISER_TOL for e in chain_err.values())):
        raise AssertionError(f"the joint model disagrees with the CPU: {out['float32_vs_cpu']}")

    # sample-phars on a joint port checkpoint of the bf16 weights
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_port_checkpoint(tmp / "joint", cfg, models["fused"])
        pdb = tmp / "pocket.pdb"
        pdb.write_text(synthetic_pocket_pdb(np.random.RandomState(0)))
        launch_counts(reset=True)
        with contextlib.redirect_stdout(io.StringIO()):
            mols, ms = synced_ms(lambda: cli.main([
                "sample-phars", str(tmp / "joint"), str(pdb), str(tmp / "out.json"),
                "--ref-ligand", "L:1", "--n-samples", str(B), "--timesteps", "100",
                "--seed", "0", "--device", "cuda", "--engine", "fused"]))
        launches = sum(launch_counts().values())
        pts = np.array([p for mol in mols.values() for fam in mol.values() for p in fam])
    if launches != 101 or len(mols) != B or not np.isfinite(pts).all():
        raise AssertionError(f"joint sample-phars CLI: {launches} launches, {len(mols)} clouds")
    out["cli"] = {"ms": ms, "clouds": len(mols), "points": len(pts), "T": 100, "launches": launches}
    log(f"joint sample-phars CLI (fused, T=100): {len(mols)} clouds in {ms:.0f} ms")
    return out


def evaluate_phase(dev, repo, posp, smiles, poses):
    """The evaluation harnesses on the card through the CLI:
    ``eval-diffphar`` with the trained qrun_aa (T=100, unclamped) on a
    synthetic test set of 8 complexes in DiffPharDataset's format,
    ``eval-gcpg`` with grun_r5cn on 128 of the align phase's SMILES, and
    ``align --pose-pdbs`` on pose PDBs of the align phase's posed
    conformers (heavy atoms, HETATM); then ``eval_alignment_rmsd_posed`` on
    those poses, card against the CPU with the same draws."""
    import torch

    from cmdgen_tpu_torch import cli
    from cmdgen_tpu_torch.ops import dgeom
    from cmdgen_tpu_torch.pipeline.evaluate import eval_alignment_rmsd_posed
    from cmdgen_tpu_torch.utils.synthetic import ligand_pdb, synthetic_diffphar_npz

    assets = repo / "cmdgen_tpu_torch" / "assets"
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        synthetic_diffphar_npz(tmp / "test.npz", np.random.RandomState(0), n_complexes=8)
        with contextlib.redirect_stdout(io.StringIO()):
            metrics, ms = synced_ms(lambda: cli.main([
                "eval-diffphar", str(assets / "qrun_aa"), str(tmp / "test.npz"),
                "--device", "cuda"]))
        if not (all(np.isfinite(v) for v in metrics.values()) and metrics["n_sampled"] > 0):
            raise AssertionError(f"eval-diffphar: {metrics}")
        out["eval_diffphar"] = dict(metrics, ms=ms, complexes=8, samples_per_complex=4, T=100)
        log(f"eval-diffphar (qrun_aa, T=100, 8 synthetic complexes): {json.dumps(out['eval_diffphar'])}")

        (tmp / "test.smi").write_text("\n".join(smiles) + "\n")
        with contextlib.redirect_stdout(io.StringIO()):
            metrics, ms = synced_ms(lambda: cli.main([
                "eval-gcpg", str(assets / "grun_r5cn"), str(tmp / "test.smi"), "--n", "128",
                "--device", "cuda"]))
        if not (metrics["n_eval"] == 128 and all(np.isfinite(v) for v in metrics.values())):
            raise AssertionError(f"eval-gcpg: {metrics}")
        out["eval_gcpg"] = dict(metrics, ms=ms)
        log(f"eval-gcpg (grun_r5cn, 128 SMILES): {json.dumps(out['eval_gcpg'])}")

        pose_dir = tmp / "poses"
        pose_dir.mkdir()
        for i, (symbols, xyz, _) in enumerate(poses):
            (pose_dir / f"pose_{i:02d}.pdb").write_text(ligand_pdb(symbols, xyz))
        with contextlib.redirect_stdout(io.StringIO()):
            summary, ms = synced_ms(lambda: cli.main([
                "align", str(pose_dir), str(posp), str(tmp / "aligned"), "--pose-pdbs",
                "--tolerance", "1", "--device", "cuda"]))
        # a pose whose every conformer diverged has a NaN RMSD, as in the
        # JAX package (ROADMAP C): the mean and median then are NaN, so the
        # finite values are summarised beside them
        values = np.load(tmp / "aligned" / "rmsd_values.npy")
        finite = values[np.isfinite(values)]
        if not (len(finite) > 0 and len(values) == summary["n_aligned"]
                and summary["n_aligned"] + summary["n_failed"] == len(poses)):
            raise AssertionError(f"align --pose-pdbs: {summary}, RMSDs {values}")
        out["align_pose_pdbs"] = dict(summary, ms=ms, poses=len(poses), n_finite=len(finite),
                                      finite_rmsd_mean=float(finite.mean()),
                                      finite_rmsd_median=float(np.median(finite)))
        log(f"align --pose-pdbs ({len(poses)} poses): {json.dumps(out['align_pose_pdbs'])}")

        # every pose, card vs CPU on the same embedding draws: the same
        # poses fail, the same RMSDs (most fail before any draw: their
        # rebuilt molecule matches no subset of the hypothesis)
        paths = sorted(pose_dir.glob("*.pdb"))
        embed_draws = dgeom.embed_draws
        res = {}
        for d in ("cpu", dev):
            seeds = iter(range(100, 200))

            def fixed_draws(m, c, nb, generator=None, device=None):
                g = torch.Generator().manual_seed(next(seeds))
                return tuple(v.to(device) for v in embed_draws(m, c, nb, g, "cpu"))

            dgeom.embed_draws = fixed_draws
            try:
                res[str(d)] = eval_alignment_rmsd_posed(paths, posp, tolerance=1, device=d)
            finally:
                dgeom.embed_draws = embed_draws
    cpu, card = (np.array(res[k]["rmsd_values"]) for k in ("cpu", str(dev)))
    same_nan = cpu.shape == card.shape and np.array_equal(np.isnan(cpu), np.isnan(card))
    both = np.isfinite(cpu) & np.isfinite(card) if same_nan else np.zeros(0, bool)
    err = float(np.abs(cpu[both] - card[both]).max()) if both.any() else float("nan")
    out["posed_card_vs_cpu"] = {"poses": len(paths), "rmsds_cpu": cpu.tolist(),
                                "rmsds_card": card.tolist(),
                                "rmsd_max_abs_err": err, "tol": ALIGN_RMSD_TOL}
    log(f"eval_alignment_rmsd_posed card vs CPU ({len(paths)} poses, same draws): "
        f"{out['posed_card_vs_cpu']}")
    cpu_out, card_out = res["cpu"], res[str(dev)]
    if not (same_nan and both.any() and cpu_out["n_failed"] == card_out["n_failed"]
            and err <= ALIGN_RMSD_TOL):
        raise AssertionError(f"eval_alignment_rmsd_posed disagrees with the CPU: {cpu} {card}")
    return out


# ------------------------------------------------------------------ train

def leaf_check(name, got, ref, floor_of):
    """Every leaf of ``got`` ({path: array}) within TRAIN_GRAD_TOL of its own
    largest |ref| plus 1e-5 of the largest |ref| over ``floor_of``: the
    worst ratio of an error to its limit."""
    tree_max = max(float(np.abs(v).max()) for v in floor_of.values())
    worst = 0.0
    for path, r in ref.items():
        tol = TRAIN_GRAD_TOL * float(np.abs(r).max()) + 1e-5 * tree_max
        err = float(np.abs(got[path] - r).max())
        if not (np.isfinite(got[path]).all() and err <= tol):
            raise AssertionError(f"{name} {path}: card vs CPU {err} > {tol}")
        worst = max(worst, err / tol if tol > 0 else 0.0)
    return worst


def weights_after_step(name, got, ref, lr):
    """The weights after one step on the card against the CPU's: every
    element within 2 lr (Adam's first step moves each element by about lr
    times the sign of its gradient, so a gradient at rounding level may
    flip) and all but 0.5% within TRAIN_WEIGHT_ATOL. Returns the share
    within that."""
    close = total = 0
    for path, r in ref.items():
        d = np.abs(got[path] - r)
        if not d.max() <= 2 * lr:
            raise AssertionError(f"{name} {path}: weight moved {d.max()} from the CPU's")
        close += int((d <= TRAIN_WEIGHT_ATOL).sum())
        total += r.size
    if close < 0.995 * total:
        raise AssertionError(f"{name}: {total - close} of {total} weights apart after the step")
    return close / total


def diffphar_configs():
    """ca_config (hidden 256, 5 layers, T=500, float32): the dense engine
    and K=12."""
    import dataclasses

    from cmdgen_tpu_torch.config import ca_config

    cfg = ca_config()
    k12 = dataclasses.replace(cfg, dynamics=dataclasses.replace(
        cfg.dynamics, egnn=dataclasses.replace(cfg.dynamics.egnn, neighbor_k=K)))
    return {"dense": cfg, "k12": k12}


def diffphar_step_vs_cpu(cfg, ds, hist, dev, engine):
    """One train step (clip on, fresh AMSGrad) on the card and on the CPU
    from the same seeded weights, batch (B=2), times and noise: the loss
    terms, every leaf's gradient and the weights after it; every gradient
    finite and, in each GCL, edge_in's, edge_out's and att's non-zero;
    no kernel (K1, K2, K3) launched."""
    import torch

    from cmdgen_tpu_torch import convert
    from cmdgen_tpu_torch.train import state as tstate
    from cmdgen_tpu_torch.train.diffphar_train import build_model, to_clouds

    batch = ds.padded_batch(list(range(TRAIN_CHECK_B)))
    out = {}
    noise = None
    for where, d in (("cpu", torch.device("cpu")), ("card", dev)):
        model = build_model(cfg, hist, d, torch.Generator().manual_seed(0))
        phar, pocket = to_clouds(batch, d)
        if noise is None:
            noise = model.draw_noise(phar, True, torch.Generator().manual_seed(1))
        st = tstate.init_state(model, tstate.reference_optimizer(model.parameters(), cfg.train.lr))
        launch_counts(reset=True)
        metrics = tstate.make_diffusion_train_step(clip_grad=True)(
            st, phar, pocket, noise=[n.to(d) for n in noise])
        if where == "card":
            torch.cuda.synchronize()
            counts = launch_counts()
            k1_launches = counts["gcl_message_agg"]
            if any(counts.values()):
                raise AssertionError(f"{engine}: launches {counts} in a train step")
        out[where] = ({k: float(v) for k, v in metrics.items()},
                      convert.model_leaves(model, {n: p.grad for n, p in model.named_parameters()}),
                      convert.model_leaves(model))
    (m_cpu, g_cpu, w_cpu), (m_card, g_card, w_card) = out["cpu"], out["card"]
    worst_loss = 0.0
    for k, v in m_cpu.items():
        tol = TRAIN_LOSS_TOL * max(1.0, abs(v))
        err = abs(m_card[k] - v)
        if not err <= tol:
            raise AssertionError(f"{engine} {k}: card {m_card[k]} vs CPU {v}")
        worst_loss = max(worst_loss, err / tol)
    worst_grad = leaf_check(f"{engine} gradient", g_card, g_cpu, g_cpu)
    share = weights_after_step(f"{engine}", w_card, w_cpu, cfg.train.lr)
    dead = [p for p, g in g_card.items()
            if any(s in p for s in ("/edge_in/", "/edge_out/", "/att/"))
            and not np.abs(g).max() > 0]
    if dead:
        raise AssertionError(f"{engine}: no gradient on the card for {dead}")
    log(f"train step card vs CPU ({engine}, B={TRAIN_CHECK_B}): loss {m_card['loss']:.6g} vs "
        f"{m_cpu['loss']:.6g}; worst ratio to the limit: loss terms {worst_loss:.3g}, "
        f"gradients {worst_grad:.3g}; weights within {TRAIN_WEIGHT_ATOL}: {share:.6f}")
    return {"batch": TRAIN_CHECK_B, "loss_card": m_card["loss"], "loss_cpu": m_cpu["loss"],
            "worst_loss_term_ratio": worst_loss, "worst_gradient_ratio": worst_grad,
            "weights_within_atol": share, "weight_atol": TRAIN_WEIGHT_ATOL,
            "leaves": len(g_card), "k1_launches": k1_launches}


def diffphar_timing(cfg, ds, hist, dev, b):
    """Warm train steps at batch b: the median ms of TRAIN_TIMED steps after
    TRAIN_WARM, samples/s, the peak memory, and a profile of
    TRAIN_PROFILED steps (busy share, top 5 device ops)."""
    import torch

    from cmdgen_tpu_torch.train import state as tstate
    from cmdgen_tpu_torch.train.diffphar_train import build_model, to_clouds

    model = build_model(cfg, hist, dev, torch.Generator().manual_seed(0))
    st = tstate.init_state(model, tstate.reference_optimizer(model.parameters(), cfg.train.lr))
    step = tstate.make_diffusion_train_step(clip_grad=True)
    phar, pocket = to_clouds(ds.padded_batch(list(range(b))), dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(TRAIN_WARM):
        step(st, phar, pocket, generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = [synced_ms(lambda: step(st, phar, pocket, generator=gen))[1]
             for _ in range(TRAIN_TIMED)]
    peak = torch.cuda.max_memory_allocated()
    prof = device_profile(lambda: step(st, phar, pocket, generator=gen), TRAIN_PROFILED, top=5)
    ms = float(np.median(times))
    return {"batch": b, "ms_per_step": ms, "ms_min": min(times), "ms_max": max(times),
            "samples_per_s": b / ms * 1e3, "max_memory_allocated": peak, "profile": prof}


def diffphar_loss_falls(cfg, ds, hist, dev):
    """50 steps on one batch (B=4, K=12) with fixed times and noise: the
    last loss below the first."""
    import torch

    from cmdgen_tpu_torch.train import state as tstate
    from cmdgen_tpu_torch.train.diffphar_train import build_model, to_clouds

    model = build_model(cfg, hist, dev, torch.Generator().manual_seed(0))
    st = tstate.init_state(model, tstate.reference_optimizer(model.parameters(), cfg.train.lr))
    step = tstate.make_diffusion_train_step(clip_grad=True)
    phar, pocket = to_clouds(ds.padded_batch(list(range(4, 8))), dev)
    noise = model.draw_noise(phar, True, torch.Generator(device=dev).manual_seed(2))
    losses = [float(step(st, phar, pocket, noise=noise)["loss"]) for _ in range(50)]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"50 steps on one batch: loss {losses[0]} -> {losses[-1]}")
    return {"first": losses[0], "last": losses[-1], "steps": 50}


def train_eval_sampling_run(cfg, data, out_dir, dev):
    """train_diffphar with K=12, EMA 0.999 and eval-epoch sampling every
    epoch (B=32, one epoch of 8 steps): K1's and K2's launches counted in
    every train step (0) and K1's in every eval sampling call (n_layers x
    (T + 1)); the
    last sampling call's denoiser inputs recorded (first, middle, last of
    its T + 1 calls) with its evaluation copy of the model. Returns
    (record, recorded inputs, the evaluation model)."""
    import dataclasses

    import torch

    from cmdgen_tpu_torch.ops.egnn_msgpass import gcl_message_agg
    from cmdgen_tpu_torch.train import diffphar_train as dt
    from cmdgen_tpu_torch.train import state as tstate

    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=32, n_epochs=1, eval_epochs=1, ema_decay=0.999))
    n_layers, calls = cfg.dynamics.egnn.n_layers, cfg.ddpm.timesteps + 1
    step_launches, sample_launches, seen = [], [], {}
    real_make, real_sample = tstate.make_diffusion_train_step, dt.sampling_metrics

    def counted_make(*a, **kw):
        step = real_make(*a, **kw)

        def counted(*sa, **skw):
            before = sum(launch_counts().values())
            out = step(*sa, **skw)
            step_launches.append(sum(launch_counts().values()) - before)
            return out

        return counted

    def counted_sample(model, *a, **kw):
        before, captures = launch_counts(), graph_captures()
        t0 = time.perf_counter()
        if len(sample_launches) == cfg.train.n_epochs - 1:
            res = {}
            seen["recorded"], seen["calls"] = record_denoiser_inputs(
                model.dynamics, calls, lambda: res.update(real_sample(model, *a, **kw)))
            seen["model"] = model
        else:
            res = real_sample(model, *a, **kw)
        torch.cuda.synchronize()
        seen.setdefault("ms", []).append((time.perf_counter() - t0) * 1e3)
        # each call's launches less those of the pass before a capture
        again = k1_want(n_layers, 0, captures)
        sample_launches.append({k: v - before[k] - (again if k != "egnn_forward_fused" else 0)
                                for k, v in launch_counts().items()})
        return res

    logs = []
    tstate.make_diffusion_train_step, dt.sampling_metrics = counted_make, counted_sample
    try:
        launch_counts(reset=True)
        state, ms = synced_ms(lambda: dt.train_diffphar(
            cfg, data, out_dir, log_fn=lambda s, m: logs.append(m), device=dev))
        total = gcl_message_agg.launches
    finally:
        tstate.make_diffusion_train_step, dt.sampling_metrics = real_make, real_sample
    if any(step_launches) or len(step_launches) != 8 * cfg.train.n_epochs:
        raise AssertionError(f"kernels in training steps: {step_launches}")
    want = launches_want("msgpass", n_layers, calls)
    if sample_launches != [want] * cfg.train.n_epochs or seen["calls"] != calls:
        raise AssertionError(f"launches per eval sampling call: {sample_launches}, expected "
                             f"{want} each")
    k1_sampling = [c["gcl_message_agg"] for c in sample_launches]
    k3_sampling = [c["coord_update_agg"] for c in sample_launches]
    sampled = [m for m in logs if "sampling/kl_types" in m]
    vals = [m["loss/val"] for m in logs if "loss/val" in m]
    if len(sampled) != cfg.train.n_epochs \
            or not all(np.isfinite(m["sampling/kl_types"]) for m in sampled) \
            or not np.isfinite(vals).all():
        raise AssertionError(f"train_diffphar logged {logs}")
    files = sorted(p.name for p in (out_dir / "best").iterdir())
    if files != ["config.json", "ema_params.npz", "opt_state.npz", "params.npz"]:
        raise AssertionError(f"best/ holds {files}")
    rec = {"steps": state.step, "ms": ms, "kernel_launches_in_train_steps": sum(step_launches),
           "k1_launches_per_eval_sampling": k1_sampling,
           "k3_launches_per_eval_sampling": k3_sampling, "k1_launches_total": total,
           "eval_sampling_ms": seen["ms"], "eval_sampling_T": calls - 1,
           "val_loss": vals, "sampling": sampled}
    log(f"train_diffphar K=12 EMA: {state.step} steps in {ms:.0f} ms; K1 per eval sampling "
        f"call {k1_sampling}, K3 {k3_sampling} ({seen['ms'][-1]:.0f} ms each at "
        f"T={calls - 1}), 0 in {len(step_launches)} train steps; val {vals}")
    return rec, seen["recorded"], seen["model"]


def trained_sample_phars(ckpt, dev, cfg):
    """sample-phars on a training run's directory (its best/) with both
    engines, T=100, 16 clouds: launches and finite clouds."""
    import torch

    from cmdgen_tpu_torch import cli
    from cmdgen_tpu_torch.utils.synthetic import synthetic_pocket_pdb

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        pdb = Path(tmp) / "pocket.pdb"
        pdb.write_text(synthetic_pocket_pdb(np.random.RandomState(3)))
        for engine in ("msgpass", "fused"):
            launch_counts(reset=True)
            captures = graph_captures()
            with contextlib.redirect_stdout(io.StringIO()):
                _, ms = synced_ms(lambda: cli.main([
                    "sample-phars", str(ckpt), str(pdb), str(Path(tmp) / "o.json"),
                    "--ref-ligand", "L:1", "--n-samples", "16", "--timesteps", "100",
                    "--device", "cuda", "--engine", engine]))
            torch.cuda.synchronize()
            launches = launch_counts()
            mols = json.loads((Path(tmp) / "o.json").read_text())
            pts = np.array([p for m in mols.values() for f in m.values() for p in f])
            calls = min(100, cfg.ddpm.timesteps) + 1
            want = launches_want(engine, cfg.dynamics.egnn.n_layers, calls, captures)
            if launches != want or len(mols) != 16 or not np.isfinite(pts).all():
                raise AssertionError(f"sample-phars {engine} on the trained checkpoint: "
                                     f"{launches}, {len(mols)} clouds")
            out[engine] = {"ms": ms, "clouds": len(mols), "points": len(pts),
                           "launches": launches}
            log(f"sample-phars on the trained best/ ({engine}, T=100): 16 clouds in "
                f"{ms:.0f} ms, launches {launches}")
    return out


def gcpg_train_checks(smiles, props, dev, tmp):
    """The GCPG at its default width: one step on the card against the CPU
    (B=8, dropout off, the same posterior draw), train-gcpg through the CLI
    (B=128, 3 steps; and without --max-steps, its device-resident plan, on
    128 molecules), warm steps timed and profiled at B=128, and
    generate from the checkpoint the CLI wrote."""
    import copy

    import torch

    from cmdgen_tpu_torch import cli, convert
    from cmdgen_tpu_torch.chem.tokenizer import Tokenizer, gen_vocabs
    from cmdgen_tpu_torch.config import GCPGModelConfig, GCPGTrainConfig
    from cmdgen_tpu_torch.data.dataset import GCPGSmilesDataset
    from cmdgen_tpu_torch.models.gcpg import GCPG
    from cmdgen_tpu_torch.models.init import init_gcpg_
    from cmdgen_tpu_torch.models.transformer import set_dropout_generator
    from cmdgen_tpu_torch.train import gcpg_train as gt

    mcfg, tcfg = GCPGModelConfig(), GCPGTrainConfig()
    tok = Tokenizer(gen_vocabs(smiles))
    data = GCPGSmilesDataset(smiles, props, tok, max_len=mcfg.max_len,
                             use_random_input_smiles=True, corrupt=True, seed=0)
    base = GCPG(mcfg, len(tok))
    init_gcpg_(base, torch.Generator().manual_seed(0))
    step = gt.make_gcpg_train_step(tcfg.condition_gate, tcfg.grad_clip)
    batch = data.padded_batch(list(range(GCPG_CHECK_B)))
    eps = torch.randn((GCPG_CHECK_B, mcfg.hidden_dim), generator=torch.Generator().manual_seed(1))
    res = {}
    for where, d in (("cpu", torch.device("cpu")), ("card", dev)):
        model = copy.deepcopy(base).to(d).eval()  # dropout off
        opt = gt.gcpg_optimizer(model, tcfg, 10)
        met = step(model, opt, gt.batch_to_device(batch, d), 1e-3, eps=eps.to(d))
        res[where] = ({k: float(v) for k, v in met.items()},
                      convert.model_leaves(model, {n: torch.zeros_like(p) if p.grad is None
                                                   else p.grad
                                                   for n, p in model.named_parameters()}),
                      convert.model_leaves(model))
    (m_cpu, g_cpu, w_cpu), (m_card, g_card, w_card) = res["cpu"], res["card"]
    worst_loss = max(abs(m_card[k] - m_cpu[k]) / (TRAIN_LOSS_TOL * max(1.0, abs(m_cpu[k])))
                     for k in ("lm_loss", "kl_loss", "mapping_loss", "loss"))
    if not worst_loss <= 1.0:
        raise AssertionError(f"GCPG step card vs CPU: {m_card} vs {m_cpu}")
    worst_grad = leaf_check("GCPG gradient", g_card, g_cpu, g_cpu)
    share = weights_after_step("GCPG", w_card, w_cpu, gt.cosine_decay(tcfg.lr, 40)(0))
    check = {"batch": GCPG_CHECK_B, "losses_card": m_card, "losses_cpu": m_cpu,
             "worst_loss_ratio": worst_loss, "worst_gradient_ratio": worst_grad,
             "weights_within_atol": share}
    log(f"GCPG step card vs CPU (B={GCPG_CHECK_B}): lm {m_card['lm_loss']:.6g}/"
        f"{m_cpu['lm_loss']:.6g}, worst ratios loss {worst_loss:.3g} gradient "
        f"{worst_grad:.3g}, weights within {TRAIN_WEIGHT_ATOL}: {share:.6f}")

    # train-gcpg through the CLI: the corpus repeated to one epoch of the
    # steps (each item is drawn anew: random SMILES, corruption, graph),
    # its properties computed once and passed as --props-json
    reps = -(-GCPG_TRAIN_STEPS * GCPG_TRAIN_B // len(smiles))
    smi, props_json = tmp / "corpus.txt", tmp / "props.json"
    smi.write_text("\n".join(smiles * reps))
    props_json.write_text(json.dumps({k: list(v) * reps for k, v in props.items()}))
    ck = tmp / "gcpg_run"
    with contextlib.redirect_stderr(io.StringIO()):
        (model, ctok), ms = synced_ms(lambda: cli.main([
            "train-gcpg", str(smi), str(ck), "--props-json", str(props_json),
            "--batch-size", str(GCPG_TRAIN_B), "--max-steps", str(GCPG_TRAIN_STEPS),
            "--epochs", "1", "--device", "cuda"]))
    epochs = 1
    meta = json.loads((ck / "last.json").read_text())
    if meta["step"] != GCPG_TRAIN_STEPS or not np.isfinite(meta["monitor"]):
        raise AssertionError(f"train-gcpg: {meta['step']} steps, loss {meta['monitor']}")
    # the metrics log's clock at the epoch's end: the steps with their data
    # and set-up, before the checkpoint is written
    epoch_end = json.loads((ck / "gcpg.metrics.jsonl").read_text().splitlines()[-1])["t"]
    cli_rec = {"ms": ms, "steps": meta["step"], "epochs": epochs, "last_loss": meta["monitor"],
               "unique_smiles": len(smiles), "corpus": len(smiles) * reps,
               "epoch_end_s": epoch_end}
    log(f"train-gcpg CLI: {meta['step']} steps at B={GCPG_TRAIN_B} on {len(smiles)} SMILES "
        f"in {ms:.0f} ms, last epoch's loss {meta['monitor']:.4f}")

    # train-gcpg as a user calls it, without --max-steps: the default plan
    # gathers each batch from pre-drawn variants on the card (its gathers
    # counted)
    n_res = GCPG_RESIDENT_SMILES
    smi_r, props_r, ck_r = tmp / "resident.txt", tmp / "resident_props.json", tmp / "gcpg_res"
    smi_r.write_text("\n".join(smiles[:n_res]))
    props_r.write_text(json.dumps({k: list(v)[:n_res] for k, v in props.items()}))
    gathers = []
    real_gather = gt.resident_batch

    def counted_gather(*a, **kw):
        gathers.append(1)
        return real_gather(*a, **kw)

    gt.resident_batch = counted_gather
    try:
        with contextlib.redirect_stderr(io.StringIO()):
            _, rms = synced_ms(lambda: cli.main([
                "train-gcpg", str(smi_r), str(ck_r), "--props-json", str(props_r),
                "--batch-size", str(GCPG_TRAIN_B), "--epochs", str(GCPG_RESIDENT_EPOCHS),
                "--device", "cuda"]))
    finally:
        gt.resident_batch = real_gather
    meta_r = json.loads((ck_r / "last.json").read_text())
    steps_r = GCPG_RESIDENT_EPOCHS * (n_res // GCPG_TRAIN_B)
    if not (meta_r["step"] == len(gathers) == steps_r and np.isfinite(meta_r["monitor"])):
        raise AssertionError(f"train-gcpg (resident plan): {meta_r['step']} steps, "
                             f"{len(gathers)} gathers from the card, loss {meta_r['monitor']}")
    cli_rec["resident"] = {"ms": rms, "steps": meta_r["step"], "gathers": len(gathers),
                           "smiles": n_res, "epochs": GCPG_RESIDENT_EPOCHS,
                           "last_loss": meta_r["monitor"]}
    log(f"train-gcpg CLI without --max-steps (resident plan): {meta_r['step']} steps at "
        f"B={GCPG_TRAIN_B} on {n_res} SMILES in {rms:.0f} ms, every batch gathered on the card")

    # warm steps timed at B=128 (train mode, dropout on)
    model = copy.deepcopy(base).to(dev).train()
    gen = torch.Generator(device=dev).manual_seed(0)
    set_dropout_generator(model, gen)
    opt = gt.gcpg_optimizer(model, tcfg, 10)
    big = gt.batch_to_device(data.padded_batch([i % len(data) for i in range(GCPG_TRAIN_B)]),
                             dev)
    for _ in range(TRAIN_WARM):
        step(model, opt, big, 1e-3, generator=gen)
    torch.cuda.reset_peak_memory_stats()
    times = [synced_ms(lambda: step(model, opt, big, 1e-3, generator=gen))[1]
             for _ in range(TRAIN_TIMED)]
    peak = torch.cuda.max_memory_allocated()
    prof = device_profile(lambda: step(model, opt, big, 1e-3, generator=gen), TRAIN_PROFILED,
                          top=5)
    timing = {"batch": GCPG_TRAIN_B, "ms_per_step": float(np.median(times)),
              "ms_min": min(times), "ms_max": max(times),
              "samples_per_s": GCPG_TRAIN_B / float(np.median(times)) * 1e3,
              "max_memory_allocated": peak, "profile": prof}
    log(f"GCPG train step B={GCPG_TRAIN_B}: {timing['ms_per_step']:.2f} ms, busy "
        f"{prof['busy_share']:.2f}")

    # generate from the checkpoint the CLI wrote
    posp = tmp / "hyp.posp"
    posp.write_text("AROM 0.0 0.0 0.0\nHACC 4.5 0.0 0.0\nHDON 1.0 4.0 0.5\n")
    with contextlib.redirect_stdout(io.StringIO()):
        res, gms = synced_ms(lambda: cli.main([
            "generate", str(posp), str(tmp / "gen"), str(ck), "--n", "64", "--no-filter",
            "--device", "cuda"]))
    lines = Path(res).read_text().splitlines()
    if len(lines) != 64:
        raise AssertionError(f"generate from the trained GCPG: {len(lines)} lines")
    gen_rec = {"ms": gms, "n": 64, "lines": len(lines)}
    return {"card_vs_cpu": check, "cli": cli_rec, "timing": timing, "generate": gen_rec}


def gcpg_finetune_checks(smiles, props, dev, tmp, repo):
    """``train-gcpg --finetune-from cmdgen_tpu_torch/assets/grun_r5cn
    --score-only-gate`` through the CLI on the decode phase's T=0.7 SMILES
    (grun_r5cn's own output, so every token is in its vocabulary; seeded
    docking scores in -9..-5 as the one condition the gate keeps), B=128,
    GCPG_FT_STEPS steps: the weights its first step starts from are the
    shipped ones (``params.npz`` with ``train_params.npz``) array for
    array, the model config and tokenizer the shipped ones, the AdamW
    state this run's alone; ``generate`` reads the checkpoint it wrote."""
    from cmdgen_tpu_torch import cli, convert
    from cmdgen_tpu_torch.train import gcpg_train as gt

    grun = repo / "cmdgen_tpu_torch" / "assets" / "grun_r5cn"
    _, tok, shipped = convert.read_port_gcpg(grun, with_training=True)
    unknown = sum(tok.MASK in tok.parse(s) for s in smiles)  # a token outside the vocabulary
    reps = -(-GCPG_FT_STEPS * GCPG_TRAIN_B // len(smiles))
    scores = np.random.RandomState(7).uniform(-9.0, -5.0, len(smiles)).tolist()
    smi, props_json, ck = tmp / "ft_corpus.txt", tmp / "ft_props.json", tmp / "gcpg_ft"
    smi.write_text("\n".join(smiles * reps))
    props_json.write_text(json.dumps({k: list(v) * reps
                                      for k, v in dict(props, Score=scores).items()}))
    start = {}
    real_make = gt.make_gcpg_train_step

    def capturing_make(*a, **kw):
        step = real_make(*a, **kw)

        def first_step(model, *sa, **skw):
            if not start:
                start.update(convert.model_leaves(model))
            return step(model, *sa, **skw)

        return first_step

    gt.make_gcpg_train_step = capturing_make
    try:
        with contextlib.redirect_stderr(io.StringIO()):
            (_, ftok), ms = synced_ms(lambda: cli.main([
                "train-gcpg", str(smi), str(ck), "--props-json", str(props_json),
                "--finetune-from", str(grun), "--score-only-gate", "--batch-size",
                str(GCPG_TRAIN_B), "--max-steps", str(GCPG_FT_STEPS), "--epochs", "1",
                "--device", "cuda"]))
    finally:
        gt.make_gcpg_train_step = real_make
    meta = json.loads((ck / "last.json").read_text())
    saved = json.loads((ck / "last" / "config.json").read_text())
    with np.load(ck / "last" / "opt_state.npz") as npz:
        count = int(npz["count"])
    differ = sorted(k for k in shipped if not np.array_equal(start.get(k), shipped[k]))
    if not (unknown == 0 and sorted(start) == sorted(shipped) and not differ
            and saved["model"] == json.loads((grun / "config.json").read_text())["model"]
            and saved["train"]["condition_gate"] == list(gt.FINETUNE_GATE)
            and ftok.to_list() == tok.to_list() and len(tok) == 53
            and meta["step"] == count == GCPG_FT_STEPS and np.isfinite(meta["monitor"])):
        raise AssertionError(f"train-gcpg --finetune-from grun_r5cn: {unknown} SMILES with a "
                             f"token outside the vocabulary; leaves {len(start)} of "
                             f"{len(shipped)}, apart from the shipped {differ[:5]}; {meta}; "
                             f"AdamW count {count}")
    posp = tmp / "ft_hyp.posp"
    posp.write_text("AROM 0.0 0.0 0.0\nHACC 4.5 0.0 0.0\nHDON 1.0 4.0 0.5\n")
    with contextlib.redirect_stdout(io.StringIO()):
        res, gms = synced_ms(lambda: cli.main([
            "generate", str(posp), str(tmp / "gen_ft"), str(ck), "--n", "64", "--no-filter",
            "--device", "cuda"]))
    lines = Path(res).read_text().splitlines()
    if len(lines) != 64:
        raise AssertionError(f"generate from the fine-tuned GCPG: {len(lines)} lines")
    rec = {"ms": ms, "steps": meta["step"], "batch": GCPG_TRAIN_B, "loss": meta["monitor"],
           "leaves_from_shipped": len(start), "smiles": len(smiles),
           "smiles_with_unknown_tokens": unknown, "adamw_count": count,
           "generate": {"ms": gms, "n": 64, "lines": len(lines)}}
    log(f"train-gcpg --finetune-from grun_r5cn --score-only-gate: {meta['step']} steps at "
        f"B={GCPG_TRAIN_B} in {ms:.0f} ms from the shipped weights ({len(start)} leaves), "
        f"loss {meta['monitor']:.4f}; generate from it {gms:.0f} ms")
    return rec


def train_phase(dev, repo, smiles):
    """Training at the flagship family's width on the card; the ``train``
    line and the train path's K1 and K2 records (the kernels line).

    DiffPhar: ``ca_config`` (hidden 256, 5 layers, 20 residue classes,
    T=500, float32) on synthetic complexes (256 train, 32 val; CA pockets
    of 80-130 residues, 3-8 pharmacophore points) with their size
    histogram. One train step card vs CPU (dense and K=12); warm steps
    timed and profiled (dense and K=12, B=4 and 32); 50 steps on one batch
    (the loss falls); ``train-diffphar`` through the CLI (dense, B=4, 20
    steps); ``train_diffphar`` with K=12, EMA and eval sampling every
    epoch, K1 counted in its steps (0) and sampling calls (5 x 501),
    the last call's K1 and K2 calls (recorded) against their plain
    versions and timed; ``sample-phars`` on its ``best/`` with both
    engines. GCPG: ``gcpg_train_checks`` on the decode phase's SMILES."""
    import copy

    from cmdgen_tpu_torch import cli
    from cmdgen_tpu_torch.data.dataset import DiffPharDataset
    from cmdgen_tpu_torch.diffusion.size_prior import smoothed_size_histogram
    from cmdgen_tpu_torch.models.dynamics import make_fused_apply
    from cmdgen_tpu_torch.utils.synthetic import synthetic_diffphar_npz

    out = {"diffphar": {}, "card": card_line()}
    t_phase = time.perf_counter()
    cfgs = diffphar_configs()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        data = tmp / "data"
        data.mkdir()
        synthetic_diffphar_npz(data / "train.npz", np.random.RandomState(0), 256,
                               n_pocket=(80, 131), n_phar=(3, 9))
        synthetic_diffphar_npz(data / "val.npz", np.random.RandomState(1), 32,
                               n_pocket=(80, 131), n_phar=(3, 9))
        ds = DiffPharDataset(data / "train.npz")
        hist = smoothed_size_histogram(*ds.sizes())
        np.save(data / "size_distribution.npy", hist)
        dp = out["diffphar"]
        dp["data"] = {"train": len(ds), "pocket_rows": ds.n_pocket_max,
                      "phar_slots": ds.n_phar_max}
        dp["card_vs_cpu"] = {e: diffphar_step_vs_cpu(c, ds, hist, dev, e)
                             for e, c in cfgs.items()}
        log(f"train phase: card vs CPU steps done at {time.perf_counter() - t_phase:.1f} s")
        dp["timing"] = {}
        for e, c in cfgs.items():
            for b in TRAIN_B:
                rec = diffphar_timing(c, ds, hist, dev, b)
                dp["timing"][f"{e}_b{b}"] = rec
                log(f"train step {e} B={b}: {rec['ms_per_step']:.2f} ms "
                    f"({rec['samples_per_s']:.1f} samples/s), peak "
                    f"{rec['max_memory_allocated'] / 2**30:.2f} GiB, busy "
                    f"{rec['profile']['busy_share']:.2f}, top {rec['profile']['top_kernels_ms']}")
        dp["loss_falls"] = diffphar_loss_falls(cfgs["k12"], ds, hist, dev)
        log(f"train phase: timing and 50 steps done at {time.perf_counter() - t_phase:.1f} s")
        # run 1: the CLI, dense
        ck1 = tmp / "run_dense"
        with contextlib.redirect_stderr(io.StringIO()):
            st, ms = synced_ms(lambda: cli.main([
                "train-diffphar", str(data), str(ck1), "--config", "ca", "--batch-size", "4",
                "--max-steps", str(TRAIN_CLI_STEPS), "--device", "cuda"]))
        meta = json.loads((ck1 / "last.json").read_text())
        if not (st.step == meta["step"] == TRAIN_CLI_STEPS and np.isfinite(meta["monitor"])):
            raise AssertionError(f"train-diffphar CLI: {st.step} steps, {meta}")
        dp["cli"] = {"ms": ms, "steps": TRAIN_CLI_STEPS, "batch": 4, "val_loss": meta["monitor"]}
        log(f"train-diffphar CLI (dense, B=4): {TRAIN_CLI_STEPS} steps and validation in "
            f"{ms:.0f} ms, "
            f"val loss {meta['monitor']:.4g}")
        # run 2: K=12, EMA, eval sampling through K1
        ck2 = tmp / "run_k12"
        with contextlib.redirect_stderr(io.StringIO()):
            dp["eval_sampling_run"], recorded, emodel = train_eval_sampling_run(
                cfgs["k12"], data, ck2, dev)
        ecfg = cfgs["k12"].dynamics.egnn
        outs, k1_calls, k2_calls = recorded_kernel_calls(
            {"msgpass": emodel.dynamics, "fused": make_fused_apply(emodel.dynamics)}, recorded)
        cpu_dynamics = copy.deepcopy(emodel.dynamics).cpu()
        errs = {e: max(err for _, err, _ in by_step)
                for e, by_step in denoiser_vs_cpu(outs, cpu_dynamics, recorded).items()}
        if not all(e <= DENOISER_TOL for e in errs.values()):
            raise AssertionError(f"the trained denoiser disagrees with the CPU: {errs}")
        xh_phar, xh_pocket = recorded[0][:2]
        shape = {"batch": xh_phar.shape[0], "node_slots": xh_phar.shape[1],
                 "pocket_rows": xh_pocket.shape[1], "hidden": ecfg.hidden_nf,
                 "layers": ecfg.n_layers, "neighbor_k": ecfg.neighbor_k, "dtype": "float32"}
        log(f"K1 and K2 at the train path's eval-sampling shape {shape}, "
            f"{len(k1_calls)} and {len(k2_calls)} recorded calls; denoiser card vs CPU {errs}")
        # K2 on the first call's inputs only: at the later ones an untrained
        # model's chain has spread the clouds so far that a layer's
        # displacement is lost to float32 rounding of the coordinates
        k1_checks, k2_checks = check_kernel_calls(k1_calls, k2_calls[:1], "float32")
        k1, k2 = time_kernel_calls(k1_calls[0], k2_calls[0], "float32", ecfg,
                                   k1_checks, k2_checks)
        dp["sample_phars"] = trained_sample_phars(ck2, dev, cfgs["k12"])
        # GCPG on the decode phase's SMILES
        corpus = tmp / "decode_smiles.txt"
        corpus.write_text("\n".join(smiles))
        props_smiles, props = cli.read_smiles_and_props(corpus)
        log(f"train phase: DiffPhar done at {time.perf_counter() - t_phase:.1f} s")
        out["gcpg"] = gcpg_train_checks(props_smiles, props, dev, tmp)
        out["gcpg"]["finetune"] = gcpg_finetune_checks(props_smiles, props, dev, tmp, repo)
    out["seconds"] = time.perf_counter() - t_phase
    kernels = {"k1": dict(k1, shape=shape, denoiser_vs_cpu=errs,
                          launches=sum(dp["eval_sampling_run"]["k1_launches_per_eval_sampling"])),
               "k3_launches": sum(dp["eval_sampling_run"]["k3_launches_per_eval_sampling"]),
               "k2": dict(k2, shape=shape,
                          launches=dp["sample_phars"]["fused"]["launches"]["egnn_forward_fused"])}
    return out, kernels


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--timesteps", type=int, default=500,
                    help="reverse steps of the flagship and joint sampling runs (default 500)")
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and check the kernels, print the checks and stop")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    repo = Path(__file__).resolve().parent
    from cmdgen_tpu_torch.ops import _build

    # the consensus stage's EM products rely on PyTorch's default: float32
    # matmuls without TF32
    tf32 = {"matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "float32_matmul_precision": torch.get_float32_matmul_precision()}
    if tf32 != {"matmul.allow_tf32": False, "float32_matmul_precision": "highest"}:
        raise AssertionError(f"float32 matmuls default to TF32 here: {tf32}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card} ({torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda})")

    t0 = time.perf_counter()
    # the profiler's first session sets up its tracing (seconds on the
    # card's host): one of a trivial op runs beside the kernels' build
    warm_s = []
    warm = threading.Thread(target=lambda: warm_s.append(synced_ms(lambda: device_profile(
        lambda: torch.ones(1, device=dev).add_(1), 1))[1] / 1e3))
    warm.start()
    logs = _build.build(ptxas_verbose=True)
    warm.join()
    if not warm_s:
        raise AssertionError("the profiler's warm-up session failed")
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs) or 'nothing (cached)'} "
        f"(the profiler's first session beside it: {warm_s[0]:.1f} s)")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    phase_s = {}
    t_main = time.perf_counter()

    def done(name):
        """Record and print the seconds since the script's start."""
        phase_s[name] = time.perf_counter() - t_main
        log(f"phase {name} done at {phase_s[name]:.1f} s")

    k1 = [check_k1(dev, d) for d in ("float32", "bfloat16")]
    k1_wide = check_k1(dev, "bfloat16", b=132)  # 12 rounds of whole items
    k2 = [check_k2(dev, d) for d in ("float32", "bfloat16")]
    k2_wide = check_k2(dev, "bfloat16", b=132)  # one sample per SM
    k3 = {name: check_k3(dev, name) for name in K3_SHAPES}
    done("kernels")
    if args.kernels_only:
        log(json.dumps({"kernel_checks": {"k1": k1, "k1_b132": k1_wide, "k2": k2,
                                          "k2_b132": k2_wide, "k3": k3}, "card": card}))
        return 0

    sampling = flagship_sampling(dev, args.timesteps)
    done("flagship")
    flagship_launches = sampling["msgpass"][2]
    if args.timesteps == 500 and not (
            flagship_launches["gcl_message_agg"] == flagship_launches["coord_update_agg"]
            == K1_FLAGSHIP_LAUNCHES):
        raise AssertionError(f"flagship run: launches {flagship_launches}, expected "
                             f"{K1_FLAGSHIP_LAUNCHES} of K1 and of K3")
    trained = trained_run(dev, repo)
    done("trained")
    with tempfile.TemporaryDirectory() as keep:
        hypothesis = Path(keep) / "consensus_gmm.posp"
        consensus = consensus_phase(dev, repo, hypothesis)
        done("consensus")
        consensus["options"] = options_phase(dev, repo)
        done("options")
        widths = widths_phase(dev, k1[-1], k2[-1])
        done("widths")
        consensus["tf32_default"] = tf32
        decode, smiles_t07 = decode_phase(dev, repo, hypothesis)
        done("decode")
        align, poses = align_phase(dev, repo, hypothesis, smiles_t07)
        done("align")
        evaluate = evaluate_phase(dev, repo, hypothesis, smiles_t07, poses)
        done("evaluate")
        train, train_kernels = train_phase(dev, repo, smiles_t07)
        done("train")
        parallel, parallel_launches, parallel_checks = parallel_phase(dev, repo, poses)
        done("parallel")
        full_atom, full_atom_launches, full_atom_kernels = full_atom_phase(dev, repo, poses)
        done("full_atom")
    run_all = run_all_phase(dev, repo)
    done("run_all")
    joint = joint_phase(dev, repo, args.timesteps)
    done("joint")

    def entry(name, source, replaces, flagship, main_path, run_all_path, joint_path,
              parallel_path, full_atom_path, widths_path):
        """The kernel's line: launches, times and bound at the main path's
        (training's) shape; run-all's, the flagship checks (bf16, the
        flagship sampling dtype, last), the joint shape's, the parallel
        path's checks, the full-atom shape's and the widths phase's beside
        them; max_abs_err is the comparison nearest its limit over every
        check."""
        width_checks = [*widths_path["widths"], widths_path["block_gemm_route_at_256"],
                        widths_path["full_atom_cutoff_exact"]]
        worst = max((c for chk in (*flagship, main_path, run_all_path, joint_path, parallel_path,
                                   full_atom_path, *width_checks)
                     for c in chk["comparisons"]),
                    key=lambda c: c["max_abs_err"] / c["tol"])
        bf16 = flagship[-1]
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": main_path["launches"],
            "max_abs_err": worst["max_abs_err"], "tol": worst["tol"],
            "ms": main_path["ms"], "plain_ms": main_path["plain_ms"],
            "bound_ms": main_path["bound_ms"], "bound_by": main_path["bound_by"],
            "library_ms": None,
            "train_shape": dict(main_path["shape"], kernel_ms=main_path["kernel_ms"],
                                comparisons=main_path["comparisons"]),
            "run_all_shape": dict(run_all["kernels"]["shape"], **{
                key: run_all_path[key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "comparisons")}),
            "flagship": {key: bf16[key] for key in (
                "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "grid")},
            "checks": flagship,
            "parallel_path": parallel_path,
            "full_atom_shape": dict(full_atom_path["shape"], **{
                key: full_atom_path[key] for key in (
                    "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "comparisons")}),
            "widths": widths_path,
        }

    # launches and times: training's (this slice's main path: K1 in its
    # eval-epoch sampling, K2 in sample-phars --engine fused on its
    # checkpoint); each earlier path's count beside it
    kernels = [
        entry("gcl_message_agg", "cmdgen_tpu_torch/csrc/egnn_msgpass.cu",
              "cmdgen_tpu/ops/egnn_msgpass.py:111", k1, train_kernels["k1"],
              run_all["kernels"]["k1"], joint["k1"], parallel_checks["k1"],
              full_atom_kernels["k1"], widths["k1"]),
        entry("egnn_forward_fused", "cmdgen_tpu_torch/csrc/egnn_fused.cu",
              "cmdgen_tpu/ops/egnn_fused.py:209", k2, train_kernels["k2"],
              run_all["kernels"]["k2"], joint["k2"], parallel_checks["k2"],
              full_atom_kernels["k2"], widths["k2"]),
    ]
    for kern, engine, key in zip(kernels, ("msgpass", "fused"), ("k1", "k2")):
        kern["launches_by_path"] = {
            "flagship_sampling": sampling[engine][2][kern["name"]],
            "trained_sample_phars": trained[engine][kern["name"]],
            "run_all": run_all["runs"][engine]["launches"][kern["name"]],
            "joint_sample_phars": joint["engines"][engine]["launches"][kern["name"]],
            "train": kern["launches"], "train_diffphar_steps":
                train["diffphar"]["eval_sampling_run"]["kernel_launches_in_train_steps"],
            "parallel": parallel_launches[kern["name"]],
            "full_atom": full_atom_launches[kern["name"]]}
        for path in ("parallel", "full_atom"):
            if not kern["launches_by_path"][path]:
                raise AssertionError(f"{kern['name']} was not launched on the {path} path")
        kern["joint"] = {k: joint[key][k] for k in (
            "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "comparisons")}
        kern["joint"]["shape"] = joint["config"]
        kern["run_all_shape"]["kernel_ms"] = run_all["kernels"][key]["kernel_ms"]
    kernels[1]["joint"]["phases"] = joint["k2"]["phases"]
    kernels[1]["run_all_shape"]["phases"] = run_all["kernels"]["k2"]["phases"]
    kernels[1]["train_shape"]["phases"] = train_kernels["k2"]["phases"]
    kernels[1]["full_atom_shape"]["phases"] = full_atom_kernels["k2"]["phases"]
    kernels[0]["flagship"]["stage_shares"] = k1[-1]["stage_shares"]
    kernels[0]["batch_132"] = {key: k1_wide[key] for key in (
        "ms", "kernel_ms", "plain_ms", "bound_ms", "grid", "stage_shares", "comparisons")}
    kernels[1]["batch_132"] = {key: k2_wide[key] for key in (
        "ms", "kernel_ms", "plain_ms", "bound_ms", "grid", "phases", "comparisons")}
    # K3 has no JAX counterpart (the JAX package runs the coordinate update
    # in XLA); its line holds the checks and times at its shapes and its
    # launches: the main path's (the train path's eval sampling), each
    # path's beside it, one a block wherever K1 runs one a GCL (one GCL a
    # block in every configuration here)
    k3_paths = {
        "flagship_sampling": sampling["msgpass"][2]["coord_update_agg"],
        "trained_sample_phars": trained["msgpass"]["coord_update_agg"],
        "run_all": run_all["runs"]["msgpass"]["launches"]["coord_update_agg"],
        "joint_sample_phars": joint["engines"]["msgpass"]["launches"]["coord_update_agg"],
        "train": train_kernels["k3_launches"], "train_diffphar_steps":
            train["diffphar"]["eval_sampling_run"]["kernel_launches_in_train_steps"],
        "parallel": parallel_launches["coord_update_agg"],
        "full_atom": full_atom_launches["coord_update_agg"]}
    for path, n in k3_paths.items():
        if path != "train_diffphar_steps" and not (
                n and n == kernels[0]["launches_by_path"][path]):
            raise AssertionError(f"K3 launched {n} times on the {path} path, K1 "
                                 f"{kernels[0]['launches_by_path'][path]}")
    kernels.append({"name": "coord_update_agg", "route": "cuda",
                    "source": "cmdgen_tpu_torch/csrc/egnn_msgpass.cu",
                    "replaces": "cmdgen_tpu_torch/models/egnn.py: EquivariantUpdate (PyTorch ops)",
                    "launches": k3_paths["train"], "launches_by_path": k3_paths,
                    "checks": k3})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({
        "flagship": {e: {"denoise_steps_per_s": v[0], "seconds": v[1], "launches": v[2],
                         "profile": v[3]} for e, v in sampling.items()},
        "timesteps": args.timesteps, "batch": B,
        "trained_launches": trained, "card": card, "phase_done_at_s": phase_s,
    }))
    log(json.dumps({"widths": {"sampling": widths["sampling"]}, "card": card}))
    log(json.dumps({"consensus": consensus, "card": card}))
    log(json.dumps({"decode": decode, "card": card}))
    log(json.dumps({"align": align, "card": card}))
    log(json.dumps({"run_all": run_all, "card": card}))
    log(json.dumps({"evaluate": evaluate, "card": card}))
    log(json.dumps({"joint": {k: v for k, v in joint.items() if k not in ("k1", "k2")},
                    "card": card}))
    log(json.dumps({"train": train, "card": card}))
    log(json.dumps({"parallel": parallel, "card": card}))
    log(json.dumps({"full_atom": full_atom, "card": card}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
