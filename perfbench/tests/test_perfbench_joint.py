"""The joint model's sampler in the harness, on the CPU: the plain joint
reference against the port's ``JointDDPM`` at a tiny size (both eps,
every inpainting op and the final decode, on the dense engine and on the
neighbour-list engine's plain K1 path); the faults the joint check has to
read as not correct; a configuration of a mode the harness has no sampler
for; and the conditional cells' draws, checked chain, checked steps and
work counts pinned to the values they had before the joint sampler came."""
import dataclasses
import hashlib
import inspect
import json
import textwrap
import time
import types

import numpy as np
import pytest
import torch

from perfbench.harness import cell as cellmod, check, inputs, samplers, spec, work
from perfbench.harness.check import final_gaps
from perfbench.harness.pockets import ca_pocket
from perfbench.reference import joint as refjoint
from perfbench.reference.dynamics import denoise_joint
from perfbench.reference.sampler import gamma_table

from conftest import ROOT

CPU = torch.device("cpu")
JOINT_CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
               if spec.load_cell(ROOT, w["name"]).config["train"]["mode"] == "joint"]
# (engine, neighbor_k): K=6 cuts some rows' in-cutoff edges at the K nearest
ENGINES = {"dense": ("msgpass", None), "k1": ("msgpass", 6)}
# float32 agreement at this size: the reference and the port order their
# sums differently, and the joint velocity's mean is taken over all rows
TOL = 1e-5


def quiet(*_):
    pass


def tiny_joint_config(timesteps=8):
    cfg = json.loads((ROOT / "perfbench/configs/diffphar-ca-joint.json").read_text())
    cfg["dynamics"]["egnn"].update(hidden_nf=32, n_layers=2)
    cfg["ddpm"]["timesteps"] = timesteps
    return cfg


def port_joint(cfg_dict, weights, k):
    from cmdgen_tpu_torch.config import DiffPharConfig, from_dict
    from cmdgen_tpu_torch.convert import build_model

    cfg = from_dict(DiffPharConfig, cfg_dict)
    egnn = dataclasses.replace(cfg.dynamics.egnn, neighbor_k=k)
    cfg = dataclasses.replace(cfg, dynamics=dataclasses.replace(cfg.dynamics, egnn=egnn))
    return build_model(cfg, {p: w.numpy() for p, w in weights.items()}, "cpu", "msgpass")


def close(got, want):
    scale = want.abs().max()
    assert scale > 1e-3
    assert (got - want).abs().max() <= TOL * scale, float((got - want).abs().max() / scale)


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_the_joint_reference_matches_the_port(name):
    """Both eps on one state, every inpainting op from the program's state
    before it, and the final decode, on seeded weights and draws."""
    from cmdgen_tpu_torch.containers import PointCloud
    from cmdgen_tpu_torch.diffusion.joint import JointDDPM

    _, k = ENGINES[name]
    T, b, npr, atoms = 8, 3, 16, 30
    cfg = tiny_joint_config(T)
    weights = inputs.make_weights(cfg, 5, CPU)
    model = port_joint(cfg, weights, k)
    x, h = ca_pocket(np.random.RandomState(2), atoms)
    px, ph = torch.from_numpy(x).expand(b, atoms, 3), torch.from_numpy(h).expand(b, atoms, 20)
    pm = torch.ones(b, atoms)
    nodes = np.array([3, 12, 16])
    mask = (torch.arange(npr)[None] < torch.from_numpy(nodes)[:, None]).float()
    noise = inputs.joint_noise((b, npr, 11), (b, atoms, 23), nodes, T, 9, 0, CPU)
    tap = check.Tap(model.dynamics, range(T + 1))
    sampler = JointDDPM(model.cfg, model.dynamics, apply_fn=tap)
    phar0 = PointCloud(x=torch.zeros(b, npr, 3), h=torch.zeros(b, npr, 8), mask=mask)
    phar, pocket = sampler.inpaint(phar0, PointCloud(x=px, h=ph, mask=pm),
                                   torch.zeros_like(mask), torch.ones_like(pm), noise=noise)
    assert tap.n == T + 1
    gamma = gamma_table(cfg["ddpm"]["noise_schedule"], T, cfg["ddpm"]["noise_precision"])
    known = refjoint.known_pocket(cfg, px, ph, pm)
    init, ops, last = noise
    assert all(torch.equal(a, v) for a, v in zip(tap.records[0][:2], init))
    with torch.no_grad():
        z, zq, eps_p, eps_q = tap.records[3]
        t = torch.full((b, 1), (T - 3) / T)
        want_p, want_q = denoise_joint(weights, cfg["dynamics"], z, zq, t, mask, pm, k)
        close(eps_p, want_p)
        close(eps_q, want_q)
        for s in range(T):
            z, zq, eps_p, eps_q = tap.records[s]
            (nz, nq), (ep, eq) = refjoint.reverse(weights, cfg, gamma, (z, zq),
                                                  torch.full((b,), s), ops[s][0], ops[s][1],
                                                  known, mask, pm, k)
            close(ep, eps_p)
            close(eq, eps_q)
            close(tap.records[s + 1][0], nz)
            close(tap.records[s + 1][1], nq)
        ref = refjoint.final(weights, cfg, gamma, tap.records[T][:2], last, mask, pm, k)
    close(tap.records[T][2], ref["eps"])
    gaps = final_gaps(phar.x, phar.h, phar.mask, pocket.x, ref, torch.from_numpy(nodes))
    assert float(gaps["x_gap"].max()) <= TOL
    assert float(gaps["type_gap"].max()) == 0 and float(gaps["mask_mismatch"].max()) == 0
    # the pocket is the known one, spliced in: it moves with the noise
    # only, and every op's splice is what the reference splices
    moved = final_gaps(phar.x + 0.5 * phar.mask[..., None], phar.h, phar.mask, pocket.x, ref,
                       torch.from_numpy(nodes))
    assert float(moved["x_gap"].min()) > 1e-3


def run_correct(checkout, name, seed=2 ** 31 + 3):
    c = spec.load_cell(checkout, name, checkout / "perfbench")
    out = cellmod.run(c, seed, 0.2, False, time.perf_counter(), CPU, quiet)
    return out["correct"], out["failed"], out["checks"]


def inpaint_mutated(monkeypatch, old: str, new: str):
    """``JointDDPM.inpaint`` with the line ``old`` of its source replaced by
    ``new``: a fault inside the RePaint loop, which no method exposes."""
    from cmdgen_tpu_torch.diffusion import joint

    source = textwrap.dedent(inspect.getsource(joint.JointDDPM.inpaint))
    assert source.count(old) == 1, old
    scope = {}
    exec(compile(source.replace(old, new), joint.__file__, "exec"), vars(joint), scope)
    monkeypatch.setattr(joint.JointDDPM, "inpaint", scope["inpaint"])


def splice_shift_left_out(monkeypatch):
    inpaint_mutated(monkeypatch, "zk_q = torch.cat([zk_q[..., :nd] + shift, zk_q[..., nd:]], -1)",
                    "zk_q = torch.cat([zk_q[..., :nd], zk_q[..., nd:]], -1)")


def op_returns_its_state(monkeypatch):
    """Each op calls the denoiser and splices, and hands on its input."""
    inpaint_mutated(monkeypatch,
                    "z_p, z_q = combine_known(z_p_un, z_q_un, step_sc[i], draw(1, i, 1))",
                    "combine_known(z_p_un, z_q_un, step_sc[i], draw(1, i, 1))")


def op_skipped(monkeypatch):
    inpaint_mutated(monkeypatch, "for i, kind in enumerate(kinds):",
                    "for i, kind in list(enumerate(kinds))[1:]:")


def wrapped_apply(monkeypatch, change):
    """Every ``JointDDPM``'s denoiser output passed through ``change``."""
    from cmdgen_tpu_torch.diffusion.joint import JointDDPM

    init = JointDDPM.__init__

    def wrapped(self, *a, **k):
        init(self, *a, **k)
        apply = self._apply
        self._apply = lambda *args: change(*apply(*args))

    monkeypatch.setattr(JointDDPM, "__init__", wrapped)


def pocket_eps_zeroed(monkeypatch):
    wrapped_apply(monkeypatch, lambda p, q: (p, torch.zeros_like(q)))


def eps_scaled(monkeypatch):
    """The pharmacophore's eps off by a part in a thousand."""
    wrapped_apply(monkeypatch, lambda p, q: (p * 1.001, q))


def half_batch(monkeypatch):
    from cmdgen_tpu_torch.diffusion.joint import JointDDPM

    denoise = JointDDPM._denoise

    def half(self, z_p, z_q, *a):
        new_p, new_q = denoise(self, z_p, z_q, *a)
        h = z_p.shape[0] // 2
        return torch.cat([new_p[:h], z_p[h:]]), torch.cat([new_q[:h], z_q[h:]])

    monkeypatch.setattr(JointDDPM, "_denoise", half)


def answer_altered(monkeypatch):
    from cmdgen_tpu_torch.diffusion.joint import JointDDPM

    finalize = JointDDPM._finalize

    def altered(self, *a):
        phar, pocket = finalize(self, *a)
        return dataclasses.replace(phar, x=phar.x + 0.5 * torch.tensor([1.0, 0.0, 0.0])), pocket

    monkeypatch.setattr(JointDDPM, "_finalize", altered)


def step_not_repeatable(monkeypatch):
    from cmdgen_tpu_torch.diffusion.joint import JointDDPM

    denoise = JointDDPM._denoise

    def noisy(self, *a):
        z_p, z_q = denoise(self, *a)
        return z_p + 1e-4 * torch.rand_like(z_p), z_q

    monkeypatch.setattr(JointDDPM, "_denoise", noisy)


@pytest.mark.parametrize("fault", [splice_shift_left_out, pocket_eps_zeroed, op_returns_its_state,
                                   op_skipped, eps_scaled, half_batch, answer_altered,
                                   step_not_repeatable], ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", JOINT_CELLS)
def test_a_broken_joint_sampler_is_not_correct(tiny_checkout, monkeypatch, name, fault):
    assert run_correct(tiny_checkout, name)[:2] == (True, 0)
    fault(monkeypatch)
    correct, failed, checks = run_correct(tiny_checkout, name)
    assert not correct and failed > 0
    if fault is op_skipped:
        assert checks["calls_mismatch"]["value"] == 1


def test_a_mode_without_a_sampler_is_refused_before_set_up(tiny_checkout, monkeypatch):
    path = tiny_checkout / "perfbench/configs/diffphar-ca-joint.json"
    cfg = json.loads(path.read_text())
    cfg["train"]["mode"] = "unconditional"
    path.write_text(json.dumps(cfg))

    def no_set_up(*_):
        raise AssertionError("set-up ran")

    monkeypatch.setattr(inputs, "make_weights", no_set_up)
    c = spec.load_cell(tiny_checkout, JOINT_CELLS[0], tiny_checkout / "perfbench")
    with pytest.raises(ValueError, match="'unconditional'"):
        cellmod.run(c, 1, 0.2, False, time.perf_counter(), CPU, quiet)


def digest(tensors) -> str:
    return hashlib.sha256(b"".join(t.numpy().tobytes() for t in tensors)).hexdigest()


# the conditional sampler's draws (B=3, Np=16, F=11, T=6, chain 2), checked
# steps (T=500), checked chain (of 9) and node counts (B=8, chain 1) of
# three seeds, as the harness drew them before the joint sampler came
PINNED = {
    7: ("1081c94bd7377d6b6434207516ff14e182626da0d222590c9bc87745113a86a6",
        [0, 30, 35, 48, 63, 67, 83, 150, 161, 163, 167, 173, 183, 211, 217, 229, 263, 309, 354,
         359, 369, 374, 404, 409, 425, 429, 445, 446, 460, 484, 485, 494], 1,
        [10, 9, 9, 12, 8, 6, 8, 10]),
    2 ** 31 + 11: ("5d9b19648348a653010712b08b34ddefa26c903cca20b39c3fa62c56da991e40",
                   [0, 4, 12, 15, 28, 71, 84, 108, 121, 127, 139, 181, 209, 230, 235, 242, 253,
                    257, 269, 296, 318, 343, 356, 361, 365, 376, 379, 396, 405, 410, 424, 433], 7,
                   [7, 12, 7, 11, 7, 10, 7, 8]),
    3 * 10 ** 9: ("dddb227eecb056dd95d4d028dbfc95e1fde7c0a89ffeab113ca4b87cedbb493a",
                  [0, 3, 7, 27, 40, 73, 78, 90, 95, 97, 104, 112, 130, 145, 154, 155, 182, 232,
                   239, 271, 324, 338, 375, 379, 381, 402, 406, 418, 450, 465, 482, 486], 0,
                  [4, 3, 5, 12, 9, 8, 12, 9]),
}


@pytest.mark.parametrize("seed", sorted(PINNED))
def test_the_conditional_cells_draw_and_check_what_they_did(seed):
    draws, steps, chain, nodes = PINNED[seed]
    cfg = json.loads((ROOT / "perfbench/configs/diffphar-ca.json").read_text())
    cell = types.SimpleNamespace(config=cfg, traffic={"batch": 3, "n_phar_max": 16})
    assert digest(samplers.of(cfg).draws(cell, seed, 2, 6, CPU)) == draws
    assert check.steps_to_check(500, seed) == steps
    assert check.chain_to_check(9, seed) == chain
    assert inputs.node_counts({"nodes": [3, 12], "batch": 8}, seed, 1).tolist() == nodes


def count_state(seed=4, atoms=40, npr=16, b=3):
    x, _ = ca_pocket(np.random.RandomState(seed), atoms)
    xq = torch.from_numpy(x).expand(b, *x.shape)
    xp = torch.randn(b, npr, 3, generator=torch.Generator().manual_seed(seed)) * 3.0
    mp = (torch.arange(npr)[None] < torch.tensor([[npr], [9], [3]])).float()
    return xp * mp[..., None], xq, mp, torch.ones(b, atoms)


# the conditional counts of ``count_state`` with K unset and K=4: (nodes,
# moving rows, pocket rows, edges, moving rows' edges, denoiser flops, K1's
# (flops, bytes), K2's (flops, bytes) at H=256 and 5 layers), as before
COUNTS = {None: (148, 28, 120, 522, 185, 1071530496, (68686848, 727164),
                 (1065459200, 12170860)),
          4: (148, 28, 120, 435, 108, 963631616, (57239040, 726120), (957560320, 12169816))}


@pytest.mark.parametrize("k", [None, 4], ids=str)
def test_the_work_counts_follow_the_rows_that_move(k):
    cond_cfg = json.loads((ROOT / "perfbench/configs/diffphar-ca.json").read_text())
    joint_cfg = json.loads((ROOT / "perfbench/configs/diffphar-ca-joint.json").read_text())
    state = count_state()
    g = work.graph(*state, cond_cfg["dynamics"], k)
    assert (g.nodes, g.moving, g.pocket, g.edges, g.moving_edges, work.denoiser_flops(g, cond_cfg),
            work.k1(g, 256, "float32"), work.k2(g, 256, 5, "float32")) == COUNTS[k]
    assert g.phar == g.moving
    j = work.graph(*state, joint_cfg["dynamics"], k)
    assert (j.moving, j.moving_edges, j.phar) == (j.nodes, j.edges, g.phar)
    assert (j.nodes, j.pocket, j.edges) == (g.nodes, g.pocket, g.edges)
    # K1 takes every receiver in both models; the joint coordinate update
    # adds the pocket rows' products and gates
    assert work.k1(j, 256, "float32") == work.k1(g, 256, "float32")
    h2 = 256 * 256
    extra = 5 * (2 * (j.nodes - g.phar) * h2 + 2 * (j.edges - g.moving_edges) * (h2 + 256))
    assert work.denoiser_flops(j, joint_cfg) - work.denoiser_flops(g, cond_cfg) == extra
