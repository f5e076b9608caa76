"""Weights carried across: the committed port checkpoints are the JAX
checkpoints' arrays, array for array (``assets/qrun_aa``: the EMA params of
``runs/qrun_aa/ckpt_302k.tgz``; ``assets/grun_r5cn``: the prior decode's
arrays of ``runs/grun_r5cn/gcpg_ckpt.tgz``), and the converted weights give
the same outputs in both packages (f32): the denoiser, and the trained
GCPG's teacher-forced logits (the full tree converted from the tgz here,
within 5e-4)."""
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
from cmdgen_tpu.chem.tokenizer import Tokenizer as JTokenizer
from cmdgen_tpu.config import GCPGModelConfig as JGCPGModelConfig
from cmdgen_tpu.models.gcpg import GCPG as JGCPG
from cmdgen_tpu_torch.convert import (
    DECODE_MODULES,
    build_gcpg,
    dynamics_state_dict,
    flatten_params,
    gcpg_state_dict,
    load_flax_params,
    load_port_checkpoint,
    load_port_gcpg,
    load_state,
    read_port_checkpoint,
    read_port_gcpg,
)
from cmdgen_tpu_torch.models.dynamics import make_fused_apply

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
ASSET = REPO / "cmdgen_tpu_torch" / "assets" / "qrun_aa"
GRUN = REPO / "cmdgen_tpu_torch" / "assets" / "grun_r5cn"


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


# ------------------------------------------------------------- grun_r5cn

@pytest.fixture(scope="module")
def grun_checkpoint(tmp_path_factory):
    """runs/grun_r5cn/gcpg_ckpt.tgz restored with the JAX package's loader:
    (flattened params, the checkpoint's config)."""
    tmp = tmp_path_factory.mktemp("grun")
    with tarfile.open(REPO / "runs" / "grun_r5cn" / "gcpg_ckpt.tgz") as tf:
        tf.extractall(tmp, filter="data")
    payload, meta = ckpt.load_checkpoint(tmp / "gcpg_ckpt", "last")
    return flatten_params(payload["params"]["params"]), meta["config"]


def test_grun_committed_params_equal_checkpoint(grun_checkpoint):
    """The committed GCPG arrays are the checkpoint's prior-decode arrays,
    array for array; config.json holds its model config and tokenizer."""
    full, config = grun_checkpoint
    want = {k: v for k, v in full.items() if k.split("/")[0] in DECODE_MODULES}
    cfg, tok, got = read_port_gcpg(GRUN)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert json.loads((GRUN / "config.json").read_text()) == {
        "model": config["model"], "tokenizer": config["tokenizer"]}
    assert (cfg.hidden_dim, cfg.n_layers, cfg.ff_dim, cfg.max_len, len(tok)) == (
        256, 6, 512, 80, 53)
    model, _ = load_port_gcpg(GRUN, "cpu")
    assert not model.training_modules
    assert sum(p.numel() for p in model.parameters()) == sum(v.size for v in want.values())


def test_grun_trained_logits_same_in_both_packages(grun_checkpoint):
    """The full trained tree, converted here from the tgz, gives the JAX
    package's teacher-forced logits (and mapping scores, lm_loss, kl) at
    B=2, with JAX's posterior eps."""
    import jax
    import jax.numpy as jnp

    from cmdgen_tpu.config import from_dict as jfrom
    from cmdgen_tpu_torch.config import GCPGModelConfig, from_dict

    full, config = grun_checkpoint
    jcfg = jfrom(JGCPGModelConfig, config["model"])
    jtok = JTokenizer.from_list(config["tokenizer"])
    nested = {}
    for path, arr in full.items():
        d = nested
        *mods, leaf = path.split("/")
        for m in mods:
            d = d.setdefault(m, {})
        d[leaf] = arr
    smiles = ["CC(=O)Nc1ccc(O)cc1", "O=C(O)c1ccccc1Br"]
    ids = [jtok.parse(s) for s in smiles]
    s = max(map(len, ids))
    toks = np.full((2, s), jtok.PAD, np.int64)
    for i, row in enumerate(ids):
        toks[i, :len(row)] = row
    valid = (toks != jtok.PAD).astype(np.float32)
    rng = np.random.RandomState(0)
    pp_h = np.zeros((2, 8, 8), np.float32)
    pp_h[:, :5, :7] = np.eye(7, dtype=np.float32)[rng.randint(0, 7, (2, 5))]
    pp_h[:, :5, 7] = 1.0
    pp_e = (rng.rand(2, 8, 8, 1) * 6).astype(np.float32)
    pp_mask = (np.arange(8)[None] < np.array([[5], [4]])).astype(np.float32)
    conds = np.array([[400.0, 4.0, 0.6, 4.0, 4.0, 0.0, 0.0]] * 2, np.float32)
    data = (toks, valid, pp_h, pp_e, pp_mask, toks, conds)
    key = jax.random.PRNGKey(3)
    ref = JGCPG(jcfg, vocab_size=len(jtok)).apply(
        {"params": nested}, key, *[jnp.asarray(a) for a in data])
    model = build_gcpg(from_dict(GCPGModelConfig, config["model"]), full, len(jtok), "cpu")
    assert model.training_modules
    eps = torch.from_numpy(np.asarray(jax.random.normal(key, (2, jcfg.hidden_dim))))
    with torch.no_grad():
        out = model(*[torch.from_numpy(a) for a in data], eps=eps)
    for name, o, r in zip(("logits", "mapping_scores", "lm_loss", "kl"), out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=5e-4, rtol=5e-4,
                                   err_msg=name)


def test_gcpg_conversion_rejects_unmapped_and_unfilled():
    cfg, tok, flat = read_port_gcpg(GRUN)
    sd = gcpg_state_dict(flat)
    # kernels transpose, LayerNorm scales and PReLU slopes become weights
    k = "decoder/layer_0/ff/Dense_0/kernel"
    assert tuple(sd["decoder.layer_0.ff.Dense_0.weight"].shape) == flat[k].shape[::-1]
    assert tuple(sd["word_pred.PReLU_0.weight"].shape) == (1,)
    assert torch.equal(sd["decoder.final_ln.weight"],
                       torch.from_numpy(flat["decoder/final_ln/scale"]))
    missing = dict(flat)
    del missing["decoder/layer_3/cross_attn/v/bias"]
    with pytest.raises(KeyError, match="unfilled"):
        build_gcpg(cfg, missing, len(tok), "cpu")
    with pytest.raises(KeyError, match="unmapped"):
        build_gcpg(cfg, {**flat, "decoder/layer_9/ln1/scale": np.ones(256, np.float32)},
                   len(tok), "cpu")
    model, _ = load_port_gcpg(GRUN, "cpu")
    with pytest.raises(KeyError, match="unmapped"):
        gcpg_state_dict({**flat, "expand/Dense_0/scale": np.ones(3, np.float32)})
    with pytest.raises(KeyError, match="unmapped"):
        load_state(model, gcpg_state_dict({**flat, "expand/Dense_0/gain": np.ones(3)}))
