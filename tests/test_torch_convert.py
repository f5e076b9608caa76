"""Weights carried across: the committed port checkpoint
(``cmdgen_tpu_torch/assets/qrun_aa``) is the EMA params of
``runs/qrun_aa/ckpt_302k.tgz`` array for array, and the converted weights
give the same denoiser output in both packages (f32)."""
import json
import tarfile
from pathlib import Path

import numpy as np
import pytest
import torch

from cmdgen_tpu.config import DiffPharConfig
from cmdgen_tpu.config import from_dict as jfrom_dict
from cmdgen_tpu.models.dynamics import EGNNDynamics
from cmdgen_tpu.train import checkpoint as ckpt
from cmdgen_tpu.utils.synthetic import realistic_ca_pocket
from cmdgen_tpu_torch.convert import (
    dynamics_state_dict,
    flatten_params,
    load_flax_params,
    load_port_checkpoint,
    read_port_checkpoint,
)
from cmdgen_tpu_torch.models.dynamics import make_fused_apply

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
ASSET = REPO / "cmdgen_tpu_torch" / "assets" / "qrun_aa"


def test_committed_params_equal_restored_checkpoint(tmp_path):
    """Repeats the one-time export: untar (into a temp dir), restore with
    load_checkpoint, take eval_params_from_payload (the EMA params), flatten."""
    with tarfile.open(REPO / "runs" / "qrun_aa" / "ckpt_302k.tgz") as tf:
        tf.extractall(tmp_path, filter="data")
    payload, meta = ckpt.load_checkpoint(tmp_path, "last")
    assert "ema_params" in payload
    want = flatten_params(ckpt.eval_params_from_payload(payload)["params"])
    cfg, got = read_port_checkpoint(ASSET)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert json.loads((ASSET / "config.json").read_text()) == meta["config"]
    assert cfg.dynamics.egnn.hidden_nf == 128 and cfg.dynamics.egnn.neighbor_k == 16


def _qrun_inputs(b=2, n_p=6, seed=0):
    rng = np.random.RandomState(seed)
    nq = 40
    pocket = np.stack([realistic_ca_pocket(rng, nq) for _ in range(b)])
    xh_q = np.concatenate(
        [pocket, np.eye(20, dtype=np.float32)[rng.randint(0, 20, (b, nq))] / 4], -1)
    xh_p = np.concatenate(
        [rng.randn(b, n_p, 3) * 2, np.eye(8)[rng.randint(0, 8, (b, n_p))] / 4], -1)
    m_p = (np.arange(n_p)[None] < np.array([[n_p], [n_p - 2]])).astype(np.float32)
    return [a.astype(np.float32) for a in
            (xh_p, xh_q, rng.rand(b, 1), m_p, np.ones((b, nq)))]


@pytest.mark.parametrize("engine", ["msgpass", "fused"])
def test_qrun_aa_weights_same_dynamics_in_both_packages(engine):
    cfg, flat = read_port_checkpoint(ASSET)
    jcfg = jfrom_dict(DiffPharConfig, json.loads((ASSET / "config.json").read_text()))
    nested = {}
    for path, arr in flat.items():
        d = nested
        *mods, leaf = path.split("/")
        for m in mods:
            d = d.setdefault(m, {})
        d[leaf] = arr
    inputs = _qrun_inputs()
    ref_p, ref_q = EGNNDynamics(jcfg.dynamics).apply({"params": nested}, *inputs)
    model, _ = load_port_checkpoint(ASSET, "cpu", engine)
    fn = make_fused_apply(model.dynamics) if engine == "fused" else model.dynamics
    with torch.no_grad():
        out_p, out_q = fn(*[torch.from_numpy(a) for a in inputs])
    np.testing.assert_allclose(out_p.numpy(), np.asarray(ref_p), atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(out_q.numpy(), np.asarray(ref_q), atol=5e-4, rtol=5e-4)


def test_conversion_rejects_unmapped_and_unfilled():
    model, _ = load_port_checkpoint(ASSET, "cpu")
    _, flat = read_port_checkpoint(ASSET)
    # a Dense kernel [in, out] becomes a Linear weight [out, in]
    sd = dynamics_state_dict(flat)
    k = "egnn/e_block_0/gcl_0/node_in/kernel"
    assert tuple(sd["egnn.e_block_0.gcl_0.node_in.weight"].shape) == flat[k].shape[::-1]
    with pytest.raises(KeyError, match="unmapped"):
        dynamics_state_dict({**flat, "egnn/embedding/scale": np.ones(3, np.float32)})
    missing = dict(flat)
    del missing["egnn/e_block_1/coord_update/coord_gate/kernel"]
    with pytest.raises(KeyError, match="unfilled"):
        load_flax_params(model.dynamics, missing)
    extra = {**flat, "egnn/e_block_9/gcl_0/att/bias": np.ones(1, np.float32)}
    with pytest.raises(KeyError, match="unmapped"):
        load_flax_params(model.dynamics, extra)
