#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``cmdgen_tpu_torch``) on one GPU.

  python3 chip_smoke.py [--timesteps 500]

Run from the repository root on a machine with an NVIDIA Hopper GPU and
``nvcc``. It

1. builds every CUDA kernel of the port from ``cmdgen_tpu_torch/csrc``;
2. holds each kernel's wrapper against its plain PyTorch version at the
   flagship shape (B=48, N=8+110, K=12, H=256, 5 layers), in float32 and
   bfloat16, and times both (CUDA events) beside the card's bound for the
   work;
3. samples pharmacophores at the flagship CA configuration (hidden 256,
   5 layers, K=12, bf16, random weights from a seed) through
   ``ConditionalDDPM.sample_given_pocket`` with the msgpass engine (K1 in
   every GCL) and the fused engine (K2), counting kernel launches, then
   profiles a few steps of each (``torch.profiler``: the device's busy
   share of the wall time and the kernels that take most of it);
4. runs the ``sample-phars`` CLI entry on the trained ``qrun_aa`` weights
   and a synthetic CA pocket, and holds the trained denoiser on the card
   against the same denoiser on the CPU.

Prints the card, a ``kernels`` JSON line, the throughput, and as the last
line ``{"ok": true, "device": {...}}``. Any failure raises (exit code != 0).
Without CUDA it exits with code 1 before printing any result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
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
# pocket centroid (with --clamp-x 8, the repo's end-to-end setting)
RADIUS = 30.0
B, N_P, N_Q, K, H, L = 48, 8, 110, 12, 256, 5


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


def flagship_dynamics(dev, dtype):
    import torch

    import dataclasses

    from cmdgen_tpu_torch.config import ca_config
    from cmdgen_tpu_torch.models.dynamics import EGNNDynamics

    cfg = ca_config()
    egnn = dataclasses.replace(cfg.dynamics.egnn, compute_dtype=dtype, neighbor_k=K)
    dyn_cfg = dataclasses.replace(cfg.dynamics, egnn=egnn)
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
    log(f"  kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound:.5f} ({by})")
    return dict(dtype=dtype_name, comparisons=checks, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes)


def check_k1(dev, dtype_name):
    """K1's wrapper at the flagship shape on layer-0 weights: kernel vs
    plain, on a radial from moved coordinates and dist0 from the entry
    ones (so the two edge-feature rows are told apart)."""
    import torch

    from cmdgen_tpu_torch.models.egnn import build_neighbor_list
    from cmdgen_tpu_torch.ops.egnn_msgpass import (
        gather_rows, gcl_message_agg, gcl_message_agg_plain)

    cdt = getattr(torch, dtype_name)
    _, dyn = flagship_dynamics(dev, cdt)
    gcl = dyn.egnn.e_block_0.gcl_0
    _, x0, edge_mask = flagship_geometry(1, B, dev)
    g = torch.Generator(device=dev).manual_seed(2)
    kmask, idx = build_neighbor_list(x0, edge_mask, K)
    x = x0 + 0.5 * torch.randn(x0.shape, generator=g, device=dev)
    radial = ((x[:, :, None] - gather_rows(x, idx)) ** 2).sum(-1)
    dist0 = ((x0[:, :, None] - gather_rows(x0, idx)) ** 2).sum(-1)
    h = torch.randn(B, N_P + N_Q, H, generator=g, device=dev)
    wi, wj = gcl.edge_in.project(h, cdt)
    args = (wi, wj, idx.int(), radial, dist0, kmask,
            gcl.edge_in.w_e.weight.t().contiguous(), gcl.edge_out.weight.t().contiguous(),
            gcl.edge_out.bias, (gcl.att.weight.reshape(H), gcl.att.bias), 100.0, cdt)
    log(f"K1 {dtype_name}:")
    with torch.no_grad():
        out = gcl_message_agg(*args)
        ref = gcl_message_agg_plain(*args)
        torch.cuda.synchronize()
        checks = [compare("agg", out, ref, TOL_REL[dtype_name])]
        ms = cuda_ms(lambda: gcl_message_agg(*args), 50)
        plain_ms = cuda_ms(lambda: gcl_message_agg_plain(*args), 10)
    es = 4 if dtype_name == "float32" else 2
    n = N_P + N_Q
    edges = B * n * K
    flops = 2 * edges * H * H + 2 * edges * H
    nbytes = 3 * B * n * H * es + 4 * edges * 4 + (H * H + 2 * H + H) * es + (H + 1) * 4
    return timed_check(dtype_name, checks, ms, plain_ms, flops, nbytes)


def check_k2(dev, dtype_name):
    """K2's wrapper at the flagship shape, on the inputs the fused engine
    gives it (``make_fused_apply``: float32 type encoders, the 6 Å cutoff,
    pocket rows held): kernel vs plain. h and the displacement
    x_out - x_in are compared each on its own scale."""
    import torch

    from cmdgen_tpu_torch.ops.egnn_fused import (
        egnn_forward_fused, egnn_forward_fused_plain, fused_params)

    cdt = getattr(torch, dtype_name)
    _, dyn = flagship_dynamics(dev, cdt)
    ecfg = dyn.cfg.egnn
    params = fused_params(dyn.egnn, cdt)
    pocket, x, _ = flagship_geometry(3, B, dev)
    n = N_P + N_Q
    g = torch.Generator(device=dev).manual_seed(4)
    phar_h = torch.eye(8, device=dev)[torch.randint(0, 8, (B, N_P), generator=g, device=dev)]
    xh_phar = torch.cat([x[:, :N_P], phar_h], -1)
    xh_pocket = torch.cat([pocket.x, pocket.h], -1)
    t = torch.rand(B, 1, generator=g, device=dev)
    with torch.no_grad():
        h, x, mask, edge_mask, ucm = dyn._inputs(
            xh_phar, xh_pocket, t, torch.ones(B, N_P, device=dev), pocket.mask,
            lambda mlp, v: mlp.forward_f32(v))
    args = (params, h, x, edge_mask, mask, ucm)
    kw = dict(n_layers=ecfg.n_layers, neighbor_k=ecfg.neighbor_k,
              norm_constant=ecfg.norm_constant, coords_range=ecfg.coords_range,
              normalization_factor=ecfg.normalization_factor, tanh=ecfg.tanh,
              update_rows=N_P, compute_dtype=cdt)
    log(f"K2 {dtype_name}:")
    with torch.no_grad():
        oh, ox = egnn_forward_fused(*args, **kw)
        rh, rx = egnn_forward_fused_plain(*args, **kw)
        torch.cuda.synchronize()
        if not torch.equal(ox[:, N_P:], x[:, N_P:]):
            raise AssertionError(f"K2 {dtype_name} moved pocket rows")
        rel = TOL_REL_FUSED[dtype_name]
        checks = [compare("h", oh, rh, rel["h"]),
                  compare("dx", ox[:, :N_P] - x[:, :N_P], rx[:, :N_P] - x[:, :N_P], rel["dx"])]
        ms = cuda_ms(lambda: egnn_forward_fused(*args, **kw), 10)
        plain_ms = cuda_ms(lambda: egnn_forward_fused_plain(*args, **kw), 5)
    es = 4 if dtype_name == "float32" else 2
    r = N_P
    per_layer = (2 * 2 * n * H * H            # edge w_i, w_j
                 + 2 * n * K * H * H + 2 * n * K * H   # edge_out, att
                 + 3 * 2 * n * H * H          # node_in (two halves), node_out
                 + 2 * n * H * H + 2 * r * H * H      # coord w_j, w_i
                 + 2 * r * K * H * H + 2 * r * K * H)  # coord_mid, gate
    flops = B * L * per_layer
    nbytes = (B * n * H * es + B * n * 3 * 4 + 3 * B * n * K * 4 + B * n * 4
              + L * (9 * H * H + 6 * H) * es + L * (7 * H) * 4
              + B * n * H * 4 + B * n * 3 * 4)
    return timed_check(dtype_name, checks, ms, plain_ms, flops, nbytes)


def device_profile(fn, reps):
    """Profile reps calls of fn (torch.profiler, CUDA activity): the wall
    ms and device ms per call, the device's busy share of the wall time and
    the three kernels that take most of the device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    by_name = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    return {"wall_ms": wall, "device_ms": busy, "busy_share": busy / wall,
            "top_kernels_ms": {k[:60]: v for k, v in top}}


def flagship_sampling(dev, timesteps):
    """Both engines through sample_given_pocket at the flagship CA config;
    returns {engine: (steps/s, seconds, launches dict, profile)}."""
    import torch

    from cmdgen_tpu_torch.diffusion.cddpm import ConditionalDDPM
    from cmdgen_tpu_torch.models.dynamics import make_fused_apply
    from cmdgen_tpu_torch.ops.egnn_fused import egnn_forward_fused
    from cmdgen_tpu_torch.ops.egnn_msgpass import gcl_message_agg

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
        gcl_message_agg.launches = 0
        egnn_forward_fused.launches = 0
        t0 = time.perf_counter()
        phar, pocket_out = model.sample_given_pocket(pocket, num_nodes, N_P,
                                                     timesteps=timesteps, generator=gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {"gcl_message_agg": gcl_message_agg.launches,
                    "egnn_forward_fused": egnn_forward_fused.launches}
        if not (torch.isfinite(phar.x).all() and torch.isfinite(pocket_out.x).all()):
            raise AssertionError(f"{engine}: non-finite samples")
        if tuple(phar.x.shape) != (B, N_P, 3):
            raise AssertionError(f"{engine}: samples of shape {tuple(phar.x.shape)}")
        calls = timesteps + 1  # reverse steps + the final decode
        want = ({"gcl_message_agg": calls * L, "egnn_forward_fused": 0} if engine == "msgpass"
                else {"gcl_message_agg": 0, "egnn_forward_fused": calls})
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
    from cmdgen_tpu_torch.ops.egnn_fused import egnn_forward_fused
    from cmdgen_tpu_torch.ops.egnn_msgpass import gcl_message_agg
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
            gcl_message_agg.launches = 0
            egnn_forward_fused.launches = 0
            t0 = time.perf_counter()
            cli.main(["sample-phars", str(ckpt), str(pdb), str(out_json),
                      "--ref-ligand", "L:1", "--n-samples", "24", "--timesteps", "100",
                      "--clamp-x", "8", "--seed", "0", "--device", "cuda",
                      "--engine", engine])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches[engine] = {"gcl_message_agg": gcl_message_agg.launches,
                                "egnn_forward_fused": egnn_forward_fused.launches}
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
            used = "gcl_message_agg" if engine == "msgpass" else "egnn_forward_fused"
            if launches[engine][used] == 0:
                raise AssertionError(f"{engine}: {used} never launched")
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
    log(f"trained denoiser, card vs CPU plain (f32): max_abs_err={errs} tol=1e-3")
    if not all(e <= 1e-3 for e in errs.values()):
        raise AssertionError(f"trained denoiser disagrees with the CPU: {errs}")
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--timesteps", type=int, default=500,
                    help="reverse steps of the flagship sampling runs (default 500)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    repo = Path(__file__).resolve().parent
    from cmdgen_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card} ({torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda})")

    t0 = time.perf_counter()
    logs = _build.build(ptxas_verbose=True)
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs) or 'nothing (cached)'}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    k1 = [check_k1(dev, d) for d in ("float32", "bfloat16")]
    k2 = [check_k2(dev, d) for d in ("float32", "bfloat16")]

    sampling = flagship_sampling(dev, args.timesteps)
    trained = trained_run(dev, repo)

    def entry(name, source, replaces, checks, launches):
        main_check = checks[-1]  # bf16, the flagship sampling dtype
        # the comparison nearest its limit, over both dtypes
        worst = max((c for chk in checks for c in chk["comparisons"]),
                    key=lambda c: c["max_abs_err"] / c["tol"])
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches,
            "max_abs_err": worst["max_abs_err"], "tol": worst["tol"],
            "ms": main_check["ms"], "kernel_ms": main_check["ms"],
            "plain_ms": main_check["plain_ms"], "bound_ms": main_check["bound_ms"],
            "bound_by": main_check["bound_by"], "library_ms": None,
            "checks": checks,
        }

    kernels = [
        entry("gcl_message_agg", "cmdgen_tpu_torch/csrc/egnn_msgpass.cu",
              "cmdgen_tpu/ops/egnn_msgpass.py:111", k1,
              sampling["msgpass"][2]["gcl_message_agg"]),
        entry("egnn_forward_fused", "cmdgen_tpu_torch/csrc/egnn_fused.cu",
              "cmdgen_tpu/ops/egnn_fused.py:209", k2,
              sampling["fused"][2]["egnn_forward_fused"]),
    ]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({
        "flagship": {e: {"denoise_steps_per_s": v[0], "seconds": v[1], "launches": v[2],
                         "profile": v[3]} for e, v in sampling.items()},
        "timesteps": args.timesteps, "batch": B,
        "trained_launches": trained, "card": card,
    }))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
