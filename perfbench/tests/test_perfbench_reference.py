"""The plain reference against the port's CPU path at a tiny size, with the
same seeded weights and noise, for the dense rule, K1's neighbour list and
K2; and the imports of the benchmark's modules."""
import ast
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.harness import inputs
from perfbench.harness.check import final_gaps
from perfbench.harness.pockets import ca_pocket
from perfbench.reference.dynamics import denoise
from perfbench.reference.sampler import sample as reference_sample

PACKAGE = Path(__file__).resolve().parents[1]
# (engine, neighbor_k): K=6 cuts some rows' in-cutoff edges at the K nearest
ENGINES = {"dense": ("msgpass", None), "k1": ("msgpass", 6), "k2": ("fused", 6)}


def tiny_config(timesteps=8):
    cfg = json.loads((PACKAGE / "configs" / "diffphar-ca.json").read_text())
    cfg["dynamics"]["egnn"].update(hidden_nf=32, n_layers=2)
    cfg["ddpm"]["timesteps"] = timesteps
    return cfg


def port_model(cfg_dict, weights, engine, k):
    from cmdgen_tpu_torch.config import DiffPharConfig, from_dict
    from cmdgen_tpu_torch.convert import build_model

    cfg = from_dict(DiffPharConfig, cfg_dict)
    egnn = dataclasses.replace(cfg.dynamics.egnn, neighbor_k=k)
    cfg = dataclasses.replace(cfg, dynamics=dataclasses.replace(cfg.dynamics, egnn=egnn))
    return build_model(cfg, {p: w.numpy() for p, w in weights.items()}, "cpu", engine)


def pocket_batch(b, atoms=30, seed=0):
    x, h = ca_pocket(np.random.RandomState(seed), atoms)
    x, h = torch.from_numpy(x), torch.from_numpy(h)
    return x.expand(b, *x.shape), h.expand(b, *h.shape), torch.ones(b, atoms)


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_denoiser_matches_port(name):
    engine, k = ENGINES[name]
    cfg = tiny_config()
    weights = inputs.make_weights(cfg, 5, torch.device("cpu"))
    model = port_model(cfg, weights, engine, k)
    b, npr = 3, 16
    px, ph, pm = pocket_batch(b)
    g = torch.Generator().manual_seed(1)
    # pharmacophore nodes inside the pocket's shell, so that they have
    # pocket neighbours within the cutoff
    z = torch.randn(b, npr, 11, generator=g)
    z[..., :3] = z[..., :3] * 4.0
    mask = (torch.arange(npr)[None] < torch.tensor([[16], [9], [3]])).float()
    z = z * mask[..., None]
    xh_pocket = torch.cat([px, ph / 4.0], dim=-1)
    t = torch.full((b, 1), 0.3)
    with torch.no_grad():
        got, _ = model._apply(z, xh_pocket, t, mask, pm)
        want = denoise(weights, cfg["dynamics"], z, xh_pocket, t, mask, pm, k)
    scale = want.abs().max()
    assert scale > 0.1
    assert (got - want).abs().max() <= 1e-5 * scale


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_chain_matches_port(name):
    engine, k = ENGINES[name]
    cfg = tiny_config()
    weights = inputs.make_weights(cfg, 6, torch.device("cpu"))
    model = port_model(cfg, weights, engine, k)
    b, npr = 4, 16
    px, ph, pm = pocket_batch(b, seed=2)
    nodes = torch.tensor([3, 12, 7, 16])
    noise = inputs.chain_noise((b, npr, 11), 8, 9, 0, torch.device("cpu"))
    from cmdgen_tpu_torch.containers import PointCloud

    phar, pocket = model.sample_given_pocket(PointCloud(x=px, h=ph, mask=pm), nodes, npr,
                                             noise=noise)
    with torch.no_grad():
        ref = reference_sample(weights, cfg, px, ph, pm, nodes, npr, noise, k)
    per_cloud = final_gaps(phar.x, phar.h, phar.mask, pocket.x, ref, nodes)
    assert float(per_cloud["x_gap"].max()) <= 1e-5
    assert float(per_cloud["type_gap"].max()) <= 1e-5
    assert float(per_cloud["mask_mismatch"].max()) == 0
    # the check is not vacuous: a cloud moved by 0.5 A reads far above it
    moved = final_gaps(phar.x + 0.5 * phar.mask[..., None], phar.h, phar.mask, pocket.x, ref,
                       nodes)
    assert float(moved["x_gap"].min()) > 1e-3


def top_level_imports(path: Path):
    """Top-level names of every module a file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def test_no_jax_and_no_port_in_the_reference():
    files = sorted(PACKAGE.rglob("*.py"))
    assert files
    for path in files:
        found = top_level_imports(path) & {"jax", "jaxlib", "flax", "optax", "orbax",
                                           "cmdgen_tpu"}
        assert not found, f"{path} imports {found}"
    for path in sorted((PACKAGE / "reference").rglob("*.py")):
        assert "cmdgen_tpu_torch" not in top_level_imports(path), path
