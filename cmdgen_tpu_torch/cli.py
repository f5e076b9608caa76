"""Command-line interface of the port (counterpart of ``cmdgen_tpu/cli.py``):

  python -m cmdgen_tpu_torch.cli sample-phars CKPT_DIR POCKET.pdb OUT.json \\
      --ref-ligand A:1 [--device cuda] [--engine msgpass|fused] [--chain-gif G.gif]
  python -m cmdgen_tpu_torch.cli get-phar OUT.json HYP.posp \\
      [--method gmm|kmeans|dbscan] [--dual-json T2.json [--dual-mode gmm|dbscan|indiv]]
      [--select-json ANTI.json] [--device cuda]
  python -m cmdgen_tpu_torch.cli generate HYP.posp OUT_DIR GCPG_DIR [--n 128] \\
      [--constrain-decode] [--constrain-valence] [--no-filter] [--device cuda]
  python -m cmdgen_tpu_torch.cli align SMILES.txt HYP.posp OUT_DIR \\
      [--n-conformers 10] [--num-keep 3] [--tolerance 0] [--device cuda]
  python -m cmdgen_tpu_torch.cli align POSES_DIR HYP.posp OUT_DIR --pose-pdbs \\
      [--ref-ligand A:1] [--tolerance 0] [--device cuda]
  python -m cmdgen_tpu_torch.cli run-all CKPT_DIR GCPG_DIR OUT_DIR POCKET.pdb [...] \\
      --ref-ligand A:1 [--engine msgpass|fused] [--device cuda]
  python -m cmdgen_tpu_torch.cli eval-diffphar CKPT_DIR TEST.npz [--n-pockets 20] \\
      [--engine msgpass|fused] [--device cuda]
  python -m cmdgen_tpu_torch.cli eval-gcpg GCPG_DIR SMILES.txt [--n 100] [--device cuda]
  python -m cmdgen_tpu_torch.cli preprocess PAIRS.tsv DATA_DIR [--dataset crossdock_full] \
      [--representation full-atom|CA]
  python -m cmdgen_tpu_torch.cli train-diffphar DATA_DIR OUT_DIR [--config full|ca] \
      [--epochs N] [--batch-size B] [--max-steps S] [--neighbor-k K] [--ema-decay D] \
      [--stratified-t] [--fsdp] [--seed S] [--device cuda]
  torchrun --nproc-per-node N -m cmdgen_tpu_torch.cli train-diffphar DATA_DIR OUT_DIR [--fsdp]
  python -m cmdgen_tpu_torch.cli train-gcpg SMILES.txt OUT_DIR [--epochs 32] \
      [--batch-size 128] [--max-steps S] [--finetune-from DIR] [--score-only-gate] \
      [--legacy-no-condition] [--consensus-noise F] [--seed S] [--device cuda]

Stages 1 (``sample-phars``), 2 (``get-phar``), 3 (``generate``) and 4
(``align``) are ported, and ``run-all`` chains all four as one streaming
driver; ``preprocess`` turns (pocket PDB, ligand SDF) pairs into the
training npz files; ``eval-diffphar``, ``eval-gcpg`` and ``align --pose-pdbs`` are the
evaluation harnesses; ``train-diffphar`` and ``train-gcpg`` train the two
models and write port checkpoints under ``OUT_DIR/best`` and ``OUT_DIR/last``,
which every other command reads (``OUT_DIR`` itself means its ``best/``);
under ``torchrun`` (or with ``--fsdp``) DiffPhar trains on a data-parallel
mesh, one process per GPU.
``sample-phars`` on a joint checkpoint samples by
RePaint inpainting with the pocket held fixed. ``CKPT_DIR`` is a port
checkpoint directory (``params.npz`` + ``config.json``, see
``convert.py``), e.g. ``cmdgen_tpu_torch/assets/qrun_aa``;
``GCPG_DIR`` a GCPG one, e.g. ``cmdgen_tpu_torch/assets/grun_r5cn``. Every
command runs on ``cuda`` unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path
from typing import Optional, Sequence

from cmdgen_tpu_torch.device import make_generator


def _add_preprocess(sub):
    p = sub.add_parser("preprocess", help="CrossDocked (PDB, SDF) pairs -> npz")
    p.add_argument("pairs_file", help="TSV: split<TAB>pocket.pdb<TAB>ligand.sdf")
    p.add_argument("out_dir")
    p.add_argument("--dataset", default="crossdock_full", choices=["crossdock_full", "crossdock"])
    p.add_argument("--representation", default="full-atom", choices=["full-atom", "CA"])
    p.set_defaults(run=run_preprocess)


def run_preprocess(args):
    """Write the npz splits and histograms; prints and returns the counts."""
    import json

    from cmdgen_tpu_torch.data.crossdocked import process_dataset

    pairs = [tuple(line.split("\t"))
             for line in Path(args.pairs_file).read_text().strip().split("\n")]
    stats = process_dataset(pairs, args.out_dir, args.dataset, args.representation)
    print(json.dumps(stats))
    return stats


def _add_sample_phars(sub):
    p = sub.add_parser("sample-phars", help="sample pharmacophores for a pocket")
    p.add_argument("ckpt_dir")
    p.add_argument("pdbfile")
    p.add_argument("out_json")
    p.add_argument("--ref-ligand", default=None, help="chain:resid")
    p.add_argument("--resi-list", nargs="*", default=None)
    p.add_argument("--n-samples", type=int, default=100)
    p.add_argument("--timesteps", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--neighbor-k", type=int, default=None,
                   help="sample with the fixed-K neighbor-list engine at this K")
    p.add_argument("--ddim-eta", type=float, default=None,
                   help="DDIM reverse chain at this eta (default ancestral)")
    p.add_argument("--clamp-x", type=float, default=None,
                   help="clamp sampled coordinates to +-this (normalized Å)")
    p.add_argument("--chain-gif", default=None, metavar="PATH",
                   help="also render one sampling chain as an animated GIF: the "
                        "reference's chain sampler, ancestral whatever --ddim-eta "
                        "is, with its own draws, so not the chain that made the "
                        "written samples")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--engine", default="msgpass", choices=["msgpass", "fused"],
                   help="msgpass: per-GCL message-pass kernel (K1); fused: "
                        "the whole EGNN stack in one kernel (K2)")
    p.set_defaults(run=run_sample_phars)


def _diffphar_model(ckpt_dir, args):
    """The DiffPhar model of a port checkpoint with the sampling flags of
    ``args`` applied, on ``args.device``: (model, config)."""
    from cmdgen_tpu_torch.convert import build_model, read_port_checkpoint

    cfg, params = read_port_checkpoint(ckpt_dir)
    ddpm = cfg.ddpm
    if args.ddim_eta is not None:
        ddpm = dataclasses.replace(ddpm, ddim_eta=args.ddim_eta)
    if args.clamp_x is not None:
        ddpm = dataclasses.replace(ddpm, clamp_x=args.clamp_x)
    dyn = cfg.dynamics
    if args.neighbor_k:
        dyn = dataclasses.replace(
            dyn, egnn=dataclasses.replace(dyn.egnn, neighbor_k=args.neighbor_k))
    cfg = dataclasses.replace(cfg, ddpm=ddpm, dynamics=dyn)
    return build_model(cfg, params, args.device, args.engine), cfg


def run_sample_phars(args):
    from cmdgen_tpu_torch.diffusion.joint import JointDDPM
    from cmdgen_tpu_torch.pipeline.sample_phars import sample_phars_to_json

    model, cfg = _diffphar_model(args.ckpt_dir, args)
    if args.chain_gif and isinstance(model, JointDDPM):
        raise ValueError("--chain-gif renders the conditional model's chain; "
                         "a joint checkpoint has none")
    result = sample_phars_to_json(
        model, args.pdbfile, args.out_json, dataset=cfg.data.dataset,
        representation=cfg.data.pocket_representation,
        ref_ligand=args.ref_ligand, resi_list=args.resi_list,
        n_samples=args.n_samples, timesteps=args.timesteps,
        generator=make_generator(model.device, args.seed),
    )
    print(f"wrote {args.out_json}")
    if args.chain_gif:
        from cmdgen_tpu_torch.pipeline.sample_phars import pocket_point_cloud
        from cmdgen_tpu_torch.utils.visualization import render_chain_for_pocket

        coords, onehot = pocket_point_cloud(
            args.pdbfile, cfg.data.dataset, cfg.data.pocket_representation,
            args.ref_ligand, args.resi_list)
        render_chain_for_pocket(
            model, coords, onehot, args.chain_gif, timesteps=args.timesteps,
            generator=make_generator(model.device, args.seed + 1))
        print(f"wrote {args.chain_gif}")
    return result


def _add_get_phar(sub):
    p = sub.add_parser("get-phar", help="consensus clustering -> .posp")
    p.add_argument("cloud_json")
    p.add_argument("out_posp")
    p.add_argument("--method", default="gmm", choices=["gmm", "kmeans", "dbscan"])
    p.add_argument("--n-clusters", type=int, default=7)
    p.add_argument("--eps", type=float, default=0.2)
    p.add_argument("--min-samples", type=int, default=12)
    p.add_argument("--dual-json", default=None,
                   help="second target cloud: dual-target mode")
    p.add_argument("--dual-mode", default="gmm", choices=["gmm", "dbscan", "indiv"],
                   help="dual-target clusterer: pooled GMM, standardized DBSCAN, "
                        "or per-set GMM + cross-set merge")
    p.add_argument("--select-json", default=None,
                   help="anti-target cloud: selectivity mode")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(run=run_get_phar)


def run_get_phar(args):
    from cmdgen_tpu_torch.device import resolve_device
    from cmdgen_tpu_torch.pipeline import get_phar as gp

    dev = resolve_device(args.device)
    coords, fams = gp.load_point_cloud_json(args.cloud_json)
    if args.dual_json:
        c2, f2 = gp.load_point_cloud_json(args.dual_json)
        out = Path(args.out_posp)
        if args.dual_mode == "indiv":
            cons = gp.dual_target_consensus_indiv(
                coords, fams, c2, f2, n_clusters=args.n_clusters, seed=args.seed,
                device=dev)
            gp.write_consensus(out.with_suffix(".dual_indiv.posp"), cons)
            print(f"wrote {out.with_suffix('.dual_indiv.posp')}")
            return cons
        cons2, cons1 = gp.dual_target_consensus(
            coords, fams, c2, f2, n_clusters=args.n_clusters, seed=args.seed,
            method=args.dual_mode, dbscan_eps=args.eps,
            dbscan_min_samples=args.min_samples, device=dev)
        gp.write_consensus(out.with_suffix(".dual1.posp"), cons1)
        gp.write_consensus(out.with_suffix(".dual2.posp"), cons2)
        print(f"wrote {out.with_suffix('.dual1.posp')} and .dual2.posp")
        return cons2, cons1
    if args.select_json:
        c2, _ = gp.load_point_cloud_json(args.select_json)
        cons = gp.selective_consensus(coords, fams, c2, eps=args.eps,
                                      min_samples=args.min_samples, device=dev)
    elif args.method == "gmm":
        cons = gp.consensus_gmm(coords, fams, args.n_clusters, args.seed, device=dev)
    elif args.method == "kmeans":
        cons = gp.consensus_kmeans(coords, fams, args.n_clusters, args.seed, device=dev)
    else:
        cons = gp.consensus_dbscan(coords, fams, eps=args.eps,
                                   min_samples=args.min_samples, device=dev)
    gp.write_consensus(args.out_posp, cons)
    print(f"wrote {args.out_posp} ({len(cons)} points)")
    return cons


def _add_generate(sub):
    p = sub.add_parser("generate", help=".posp -> SMILES")
    p.add_argument("phar_file")
    p.add_argument("out_dir")
    p.add_argument("ckpt_dir", help="GCPG port checkpoint directory")
    p.add_argument("--n", type=int, default=128)
    p.add_argument("--target-score", type=float, default=0.0,
                   help="docking-score condition (generate_docked.py uses -14)")
    p.add_argument("--no-filter", action="store_true")
    p.add_argument("--temperature", type=float, default=1.0,
                   help="sampling-logit temperature (<1 sharpens)")
    p.add_argument("--constrain-decode", action="store_true",
                   help="syntax-constrained decoding: mask tokens that would leave "
                        "rings/parens unclosable (and special tokens) during sampling")
    p.add_argument("--constrain-valence", action="store_true",
                   help="additionally mask valence-overflow continuations "
                        "(per-atom bond budgets)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(run=run_generate)


def run_generate(args):
    from cmdgen_tpu_torch.convert import load_port_gcpg
    from cmdgen_tpu_torch.pipeline.generate_smiles import generate_to_file

    model, tokenizer = load_port_gcpg(args.ckpt_dir, args.device)
    out = generate_to_file(
        model, tokenizer, args.phar_file, args.out_dir, n_per_condition=args.n,
        conditions={"Score": [args.target_score]}, filter_valid=not args.no_filter,
        temperature=args.temperature, constrain=args.constrain_decode,
        constrain_valence=args.constrain_valence,
        generator=make_generator(model.pos.device, args.seed),
    )
    print(f"wrote {out}")
    return out


def _add_align(sub):
    p = sub.add_parser("align", help="align SMILES (or posed PDB ligands) onto a .posp")
    p.add_argument("smiles_file", help="SMILES list, one a line, or a directory "
                                       "(or one file) of pose PDBs with --pose-pdbs")
    p.add_argument("posp_file")
    p.add_argument("out_dir")
    p.add_argument("--n-conformers", type=int, default=10)
    p.add_argument("--num-keep", type=int, default=3)
    p.add_argument("--tolerance", type=int, default=0)
    p.add_argument("--pose-pdbs", action="store_true",
                   help="treat the first argument as a directory of docked-pose "
                        "PDB ligands and run the RMSD-vs-pose eval "
                        "(align_ligandpharm_gcpg_test.py)")
    p.add_argument("--ref-ligand", default=None,
                   help="chain:resid selector inside each pose PDB (default: all "
                        "non-water HETATM/ATOM heavy atoms)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(run=run_align)


def run_align(args):
    import json

    from cmdgen_tpu_torch.device import resolve_device
    from cmdgen_tpu_torch.pipeline.align import align_smiles_list

    generator = make_generator(resolve_device(args.device), args.seed)
    if args.pose_pdbs:
        from cmdgen_tpu_torch.pipeline.evaluate import eval_alignment_rmsd_posed

        pose_dir = Path(args.smiles_file)
        paths = sorted(pose_dir.glob("*.pdb")) if pose_dir.is_dir() else [pose_dir]
        out = eval_alignment_rmsd_posed(
            paths, args.posp_file, ref_ligand=args.ref_ligand, generator=generator,
            n_conformers=args.n_conformers, tolerance=args.tolerance,
            out_dir=args.out_dir)
        out.pop("rmsd_values")
        print(json.dumps({k: round(float(v), 4) for k, v in out.items()}))
        return out
    smiles = Path(args.smiles_file).read_text().strip().split("\n")
    best = align_smiles_list(
        smiles, args.posp_file, args.out_dir,
        generator=generator,
        n_conformers=args.n_conformers, num_keep=args.num_keep,
        tolerance=args.tolerance,
    )
    print(json.dumps({k: round(v, 3) for k, v in best.items()}))
    return best


def _add_run_all(sub):
    p = sub.add_parser(
        "run-all",
        help="pocket PDB(s) -> aligned molecules, one overlapped run "
             "(sample -> consensus -> generate -> align as a streaming "
             "driver instead of four file-to-file stages)",
    )
    p.add_argument("diff_ckpt", help="DiffPhar port checkpoint dir")
    p.add_argument("gcpg_ckpt", help="GCPG port checkpoint dir")
    p.add_argument("out_dir")
    p.add_argument("pdbfiles", nargs="+")
    p.add_argument("--ref-ligand", default=None, help="chain:resid")
    p.add_argument("--resi-list", nargs="*", default=None)
    p.add_argument("--n-clouds", type=int, default=64)
    p.add_argument("--timesteps", type=int, default=None)
    p.add_argument("--consensus", default="gmm",
                   choices=["gmm", "kmeans", "dbscan"])
    p.add_argument("--cluster-counts", type=int, nargs="+", default=[4, 5])
    p.add_argument("--smiles-per-hypothesis", type=int, default=256)
    p.add_argument("--decode-batch", type=int, default=None,
                   help="decode batch size (default: min(512, "
                        "smiles-per-hypothesis))")
    p.add_argument("--n-conformers", type=int, default=5)
    p.add_argument("--neighbor-k", type=int, default=12)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--contact-filter", type=float, default=6.0,
                   help="drop sampled points farther than this (Å) from "
                        "the nearest pocket atom before consensus "
                        "(0 disables; data p99 contact is ~4.1 Å)")
    p.add_argument("--ddim-eta", type=float, default=None,
                   help="DDIM reverse chain at this eta for the cloud "
                        "sampler (0 = deterministic; default ancestral)")
    p.add_argument("--clamp-x", type=float, default=None,
                   help="static coordinate thresholding (Å) during cloud "
                        "sampling")
    p.add_argument("--keep-top-match", type=float, default=None,
                   metavar="FRAC",
                   help="rank aligned molecules by pharmacophore match "
                        "score and keep only this top fraction (stats "
                        "report the all-aligned and kept match means)")
    p.add_argument("--decode-temperature", type=float, default=1.0,
                   help="sampling-logit temperature for the SMILES "
                        "decode (<1 sharpens)")
    p.add_argument("--validity-gate", type=float, default=None,
                   metavar="THRESH",
                   help="per-hypothesis validity gate: decode a probe "
                        "batch first and skip hypotheses whose probe "
                        "validity is below THRESH")
    p.add_argument("--gate-probe", type=int, default=256,
                   help="probe decodes per hypothesis for --validity-gate")
    p.add_argument("--constrain-decode", action="store_true",
                   help="syntax-constrained SMILES decoding (mask "
                        "unclosable/special tokens during sampling)")
    p.add_argument("--constrain-valence", action="store_true",
                   help="additionally mask valence-overflow "
                        "continuations (per-atom bond budgets)")
    p.add_argument("--engine", default="msgpass", choices=["msgpass", "fused"],
                   help="stage 1's EGNN: msgpass (K1 per GCL) or fused (K2)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(run=run_run_all)


def pipeline_config(args):
    """run-all's ``PipelineConfig`` from its parsed flags."""
    from cmdgen_tpu_torch.pipeline.run_all import PipelineConfig

    return PipelineConfig(
        n_clouds_per_pocket=args.n_clouds,
        diff_timesteps=args.timesteps,
        cluster_counts=tuple(args.cluster_counts),
        consensus_method=args.consensus,
        smiles_per_hypothesis=args.smiles_per_hypothesis,
        decode_batch=(args.decode_batch if args.decode_batch
                      else min(512, args.smiles_per_hypothesis)),
        n_conformers=args.n_conformers,
        contact_filter=(args.contact_filter
                        if args.contact_filter > 0 else None),
        keep_top_match_frac=args.keep_top_match,
        decode_temperature=args.decode_temperature,
        validity_gate=args.validity_gate,
        validity_probe=args.gate_probe,
        constrain_decode=args.constrain_decode,
        constrain_valence=args.constrain_valence,
    )


def run_run_all(args):
    """Prints the stats JSON and writes the posed SDFs and results.json;
    returns (results, stats)."""
    import json

    from cmdgen_tpu_torch.convert import load_port_gcpg
    from cmdgen_tpu_torch.pipeline.run_all import run_pipeline, write_pipeline_results
    from cmdgen_tpu_torch.pipeline.sample_phars import pocket_point_cloud

    model, cfg = _diffphar_model(args.diff_ckpt, args)
    gmodel, tokenizer = load_port_gcpg(args.gcpg_ckpt, args.device)
    pockets = [
        pocket_point_cloud(
            f, cfg.data.dataset, cfg.data.pocket_representation,
            ref_ligand=args.ref_ligand, resi_list=args.resi_list,
        )
        for f in args.pdbfiles
    ]
    results, stats = run_pipeline(model, gmodel, tokenizer, pockets, args.seed,
                                  pipeline_config(args))
    out = write_pipeline_results(results, args.out_dir)
    print(json.dumps(stats))
    print(f"wrote {out}")
    return results, stats


def _add_eval(sub):
    p = sub.add_parser("eval-diffphar", help="distribution-match eval")
    p.add_argument("ckpt_dir")
    p.add_argument("test_npz")
    p.add_argument("--n-pockets", type=int, default=20)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--engine", default="msgpass", choices=["msgpass", "fused"],
                   help="the sampler's EGNN: msgpass (K1 per GCL) or fused (K2)")
    p.set_defaults(run=run_eval_diffphar)

    q = sub.add_parser("eval-gcpg", help="generation quality eval")
    q.add_argument("ckpt_dir", help="GCPG port checkpoint directory")
    q.add_argument("test_smiles_file")
    q.add_argument("--n", type=int, default=100)
    q.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    q.set_defaults(run=run_eval_gcpg)


def run_eval_diffphar(args):
    """Prints and returns eval_diffphar's metrics (seed 0, as the JAX
    package's command)."""
    import json

    from cmdgen_tpu_torch.convert import build_model, read_port_checkpoint
    from cmdgen_tpu_torch.data.dataset import DiffPharDataset
    from cmdgen_tpu_torch.pipeline.evaluate import eval_diffphar

    cfg, params = read_port_checkpoint(args.ckpt_dir)
    model = build_model(cfg, params, args.device, args.engine)
    out = eval_diffphar(model, DiffPharDataset(args.test_npz), args.n_pockets,
                        generator=make_generator(model.device, 0))
    print(json.dumps(out))
    return out


def run_eval_gcpg(args):
    """Prints and returns eval_gcpg's metrics (seed 0)."""
    import json

    from cmdgen_tpu_torch.convert import load_port_gcpg
    from cmdgen_tpu_torch.pipeline.evaluate import eval_gcpg

    model, tokenizer = load_port_gcpg(args.ckpt_dir, args.device)
    smiles = Path(args.test_smiles_file).read_text().strip().split("\n")
    out = eval_gcpg(model, tokenizer, smiles, args.n,
                    generator=make_generator(model.pos.device, 0))
    print(json.dumps(out))
    return out


def _add_train(sub):
    p = sub.add_parser("train-diffphar", help="train the diffusion model")
    p.add_argument("datadir", help="train.npz, val.npz [, size_distribution.npy]")
    p.add_argument("out_dir")
    p.add_argument("--config", default="full", choices=["full", "ca"])
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--neighbor-k", type=int, default=None,
                   help="fixed-K neighbor-list EGNN engine (default dense)")
    p.add_argument("--ema-decay", type=float, default=None,
                   help="keep an EMA of the weights for evaluation (e.g. 0.999)")
    p.add_argument("--stratified-t", action="store_true",
                   help="stratified diffusion times across the batch")
    p.add_argument("--fsdp", action="store_true",
                   help="FSDP over the data-parallel axis: weights, gradients and optimizer "
                        "state sharded (one process per GPU under torchrun, else a world "
                        "of one)")
    p.add_argument("--seed", type=int, default=None, help="the run's seed (default 0)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(run=run_train_diffphar)

    q = sub.add_parser("train-gcpg", help="train the SMILES generator")
    q.add_argument("smiles_file")
    q.add_argument("out_dir")
    q.add_argument("--props-json", default=None)
    q.add_argument("--epochs", type=int, default=32)
    q.add_argument("--batch-size", type=int, default=128)
    q.add_argument("--max-steps", type=int, default=None)
    q.add_argument("--finetune-from", default=None,
                   help="a port GCPG checkpoint (or run directory) to start from: its "
                        "model config, tokenizer and whole weights (a decode-only "
                        "checkpoint's training modules from its train_params.npz, as in "
                        "cmdgen_tpu_torch/assets/grun_r5cn)")
    q.add_argument("--score-only-gate", action="store_true",
                   help="docking-finetune condition gate [0,0,0,0,0,1,0]")
    q.add_argument("--legacy-no-condition", action="store_true",
                   help="unconditional baseline: zero condition gate and inputs, "
                        "no descriptors computed")
    q.add_argument("--consensus-noise", type=float, default=0.0,
                   help="fraction of training pp-graphs re-drawn consensus-style")
    q.add_argument("--seed", type=int, default=None, help="the run's seed (default 42)")
    q.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    q.set_defaults(run=run_train_gcpg)


def run_train_diffphar(args):
    """Train DiffPhar; returns the final TrainState."""
    import torch.distributed as dist

    from cmdgen_tpu_torch import config as cfgmod
    from cmdgen_tpu_torch.train.diffphar_train import train_diffphar
    from cmdgen_tpu_torch.utils.logging import MetricsLogger

    cfg = cfgmod.full_atom_config() if args.config == "full" else cfgmod.ca_config()
    tr = cfg.train
    for flag, field in (("epochs", "n_epochs"), ("batch_size", "batch_size"),
                        ("ema_decay", "ema_decay"), ("seed", "seed")):
        if getattr(args, flag) is not None:
            tr = dataclasses.replace(tr, **{field: getattr(args, flag)})
    if args.fsdp:
        tr = dataclasses.replace(tr, fsdp=True)
    cfg = dataclasses.replace(cfg, train=tr)
    if args.stratified_t:
        cfg = dataclasses.replace(cfg, ddpm=dataclasses.replace(cfg.ddpm, stratified_t=True))
    if args.neighbor_k:
        dyn = cfg.dynamics
        cfg = dataclasses.replace(cfg, dynamics=dataclasses.replace(
            dyn, egnn=dataclasses.replace(dyn.egnn, neighbor_k=args.neighbor_k)))
    owned = not dist.is_initialized()  # a group the caller made stays theirs
    try:
        with MetricsLogger(args.out_dir, cfg.train.run_name) as logger:
            return train_diffphar(cfg, args.datadir, args.out_dir, max_steps=args.max_steps,
                                  log_fn=logger.log, device=args.device)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def read_smiles_and_props(smiles_file, props_file=None):
    """(SMILES, {property: values}): the properties from ``props_file``
    (JSON) or computed, dropping SMILES whose descriptors fail."""
    import json

    smiles = Path(smiles_file).read_text().strip().split("\n")
    if props_file:
        return smiles, json.loads(Path(props_file).read_text())
    from cmdgen_tpu_torch.chem.descriptors import all_properties

    keys = ["MW", "logP", "QED", "SAS", "HBA", "HBD", "RotaNumBonds"]
    props = {k: [] for k in keys}
    kept = []
    for s in smiles:
        p = all_properties(s)
        if p is None:
            continue
        kept.append(s)
        for k in keys:
            props[k].append(p[k])
    return kept, props


def run_train_gcpg(args):
    """Train the GCPG; returns (model, tokenizer)."""
    from cmdgen_tpu_torch.config import GCPGModelConfig, GCPGTrainConfig
    from cmdgen_tpu_torch.data.dataset import PROPERTY_KEYS
    from cmdgen_tpu_torch.train.gcpg_train import FINETUNE_GATE, train_gcpg
    from cmdgen_tpu_torch.utils.logging import MetricsLogger

    if args.legacy_no_condition:
        smiles = [s for s in Path(args.smiles_file).read_text().strip().split("\n") if s]
        props = {k: [0.0] * len(smiles) for k in PROPERTY_KEYS}
    else:
        smiles, props = read_smiles_and_props(args.smiles_file, args.props_json)
    tcfg = GCPGTrainConfig(batch_size=args.batch_size, n_epochs=args.epochs,
                           consensus_noise=args.consensus_noise)
    if args.seed is not None:
        tcfg = dataclasses.replace(tcfg, seed=args.seed)
    if args.score_only_gate:
        tcfg = dataclasses.replace(tcfg, condition_gate=FINETUNE_GATE)
    if args.legacy_no_condition:
        tcfg = dataclasses.replace(tcfg, condition_gate=(0,) * 7)
    with MetricsLogger(args.out_dir, "gcpg") as logger:
        return train_gcpg(GCPGModelConfig(), tcfg, smiles, props, args.out_dir,
                          max_steps=args.max_steps, finetune_from=args.finetune_from,
                          log_fn=logger.log, device=args.device)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """The parsed command line; ``args.run(args)`` runs its command."""
    parser = argparse.ArgumentParser(prog="cmdgen_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    _add_preprocess(sub)
    _add_sample_phars(sub)
    _add_get_phar(sub)
    _add_generate(sub)
    _add_align(sub)
    _add_run_all(sub)
    _add_eval(sub)
    _add_train(sub)
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    return args.run(args)


if __name__ == "__main__":
    main()
