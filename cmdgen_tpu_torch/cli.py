"""Command-line interface of the port (counterpart of ``cmdgen_tpu/cli.py``):

  python -m cmdgen_tpu_torch.cli sample-phars CKPT_DIR POCKET.pdb OUT.json \\
      --ref-ligand A:1 [--device cuda] [--engine msgpass|fused]

Only ``sample-phars`` is ported so far (without ``--chain-gif``). ``CKPT_DIR`` is a port checkpoint
directory (``params.npz`` + ``config.json``, see ``convert.py``), e.g.
``cmdgen_tpu_torch/assets/qrun_aa``.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

from cmdgen_tpu_torch.device import make_generator


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
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--engine", default="msgpass", choices=["msgpass", "fused"],
                   help="msgpass: per-GCL message-pass kernel (K1); fused: "
                        "the whole EGNN stack in one kernel (K2)")
    p.set_defaults(run=run_sample_phars)


def run_sample_phars(args):
    from cmdgen_tpu_torch.convert import build_model, read_port_checkpoint
    from cmdgen_tpu_torch.pipeline.sample_phars import sample_phars_to_json

    cfg, params = read_port_checkpoint(args.ckpt_dir)
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
    model = build_model(cfg, params, args.device, args.engine)
    result = sample_phars_to_json(
        model, args.pdbfile, args.out_json, dataset=cfg.data.dataset,
        representation=cfg.data.pocket_representation,
        ref_ligand=args.ref_ligand, resi_list=args.resi_list,
        n_samples=args.n_samples, timesteps=args.timesteps,
        generator=make_generator(model.device, args.seed),
    )
    print(f"wrote {args.out_json}")
    return result


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(prog="cmdgen_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    _add_sample_phars(sub)
    args = parser.parse_args(argv)
    return args.run(args)


if __name__ == "__main__":
    main()
