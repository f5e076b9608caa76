"""The comparison that decides ``correct`` fails where it should.

On the CPU, at a tiny size: a whole run with the conditional sampler broken
underneath comes out not correct, once for each fault a sampling cell can
have (a
reverse step that returns its state unchanged; half of the batch left
out; an answer altered where it is produced; a run on one chip has no
exchange between chips to leave out), and for two more: a step that is
not repeatable, so that the timed chain and its second run part, and a
denoiser whose eps is off by a part in a thousand; and so does the
program's own bfloat16 path, in every cell. (The joint sampler's faults:
``test_perfbench_joint``.) On the card (``cuda``), at the cells' widths, T
and checked steps with four clouds: the program is within every limit and
the control, the reference with its products in TF32, is not, on three
seeds.
"""
import dataclasses
import json
import time

import pytest
import torch

from perfbench.harness import cell as cellmod, spec

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
CONDITIONAL_CELLS = [name for name in CELLS if spec.load_cell(ROOT, name).config["train"]["mode"]
                     == "pocket_conditioning"]


def quiet(*_):
    pass


def run_correct(checkout, name, seed=2 ** 31 + 3):
    c = spec.load_cell(checkout, name, checkout / "perfbench")
    out = cellmod.run(c, seed, 0.2, False, time.perf_counter(), torch.device("cpu"), quiet)
    return out["correct"], out["failed"]


def step_unchanged(monkeypatch):
    from cmdgen_tpu_torch.diffusion.cddpm import ConditionalDDPM

    monkeypatch.setattr(ConditionalDDPM, "reverse_step",
                        lambda self, z, xh_pocket, *a: (z, xh_pocket))


def half_batch(monkeypatch):
    from cmdgen_tpu_torch.diffusion.cddpm import ConditionalDDPM

    step = ConditionalDDPM.reverse_step

    def half(self, z, xh_pocket, *a):
        new_z, new_pocket = step(self, z, xh_pocket, *a)
        h = z.shape[0] // 2
        return (torch.cat([new_z[:h], z[h:]]), torch.cat([new_pocket[:h], xh_pocket[h:]]))

    monkeypatch.setattr(ConditionalDDPM, "reverse_step", half)


def answer_altered(monkeypatch):
    from cmdgen_tpu_torch.diffusion.cddpm import ConditionalDDPM

    decode = ConditionalDDPM._final_decode

    def altered(self, *a):
        x_phar, *rest = decode(self, *a)
        return (x_phar + 0.5 * torch.tensor([1.0, 0.0, 0.0]), *rest)

    monkeypatch.setattr(ConditionalDDPM, "_final_decode", altered)


def step_not_repeatable(monkeypatch):
    """A step that adds a little noise of its own: the timed chain and its
    second run part."""
    from cmdgen_tpu_torch.diffusion.cddpm import ConditionalDDPM

    step = ConditionalDDPM.reverse_step

    def noisy(self, *a):
        z, pocket = step(self, *a)
        return z + 1e-4 * torch.rand_like(z), pocket

    monkeypatch.setattr(ConditionalDDPM, "reverse_step", noisy)


def eps_scaled(monkeypatch):
    """A denoiser whose eps is off by a part in a thousand, on either
    engine."""
    from cmdgen_tpu_torch.diffusion.cddpm import ConditionalDDPM

    init = ConditionalDDPM.__init__

    def scaled(self, *a, **k):
        init(self, *a, **k)
        apply = self._apply

        def off(*args):
            eps, *rest = apply(*args)
            return (eps * 1.001, *rest)

        self._apply = off

    monkeypatch.setattr(ConditionalDDPM, "__init__", scaled)


@pytest.mark.parametrize("fault", [step_unchanged, half_batch, answer_altered,
                                   step_not_repeatable, eps_scaled],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CONDITIONAL_CELLS)
def test_a_broken_sampler_is_not_correct(tiny_checkout, monkeypatch, name, fault):
    assert run_correct(tiny_checkout, name) == (True, 0)
    fault(monkeypatch)
    correct, failed = run_correct(tiny_checkout, name)
    assert not correct and failed > 0


@pytest.mark.parametrize("name", CELLS)
def test_the_programs_bf16_path_is_not_correct(tiny_checkout, name):
    for path in (tiny_checkout / "perfbench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["dynamics"]["egnn"]["compute_dtype"] = "bfloat16"
        path.write_text(json.dumps(cfg))
    correct, failed = run_correct(tiny_checkout, name)
    assert not correct and failed > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_tf32_control_fails_and_the_program_passes(cuda_device, name):
    from perfbench.readings import readings

    cell = spec.load_cell(ROOT, name)
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic, batch=4))
    for seed in (101, 2 ** 31 + 7, 3 * 10 ** 9):
        got = readings(cell, seed, cuda_device, quiet)
        assert all(v <= cell.limits[k] for k, v in got["program"].items()), got
        assert any(v > cell.limits[k] for k, v in got["tf32_reference"].items()), got
