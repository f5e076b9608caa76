"""Fine-tuning from the shipped GCPG (``assets/grun_r5cn``) in the port
against the JAX package on the CPU at f32.

``train_params.npz`` holds the training modules (the posterior encoder and
the mapping heads) of ``runs/grun_r5cn/gcpg_ckpt.tgz``, array for array,
beside the decode-only ``params.npz``; ``read_port_gcpg(...,
with_training=True)`` merges them and raises, naming the modules, where
they are missing. One score-only-gate step (``FINETUNE_GATE``) from the
whole trained tree with a fresh AdamW state, as the JAX package's
``train_gcpg(finetune_from=...)`` starts (``optimizer.init(params)``), is
held against its jitted ``make_gcpg_train_step``: dropout rate 0 in both,
so the step's randomness is the posterior draw alone, which the port takes
from JAX's key. ``train-gcpg --finetune-from`` through the CLI starts from
the shipped weights and writes a checkpoint that ``generate`` reads.

Tolerances as ``tests/test_torch_train_gcpg.py``'s: values atol 2e-4 /
rtol 1e-4; the weights after the step within a quarter of its learning
rate each, and all but 0.5% of them at atol 2e-6 / rtol 1e-5.
"""
import dataclasses
import json
import shutil
import tarfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmdgen_tpu.config import GCPGModelConfig as JGCPGModelConfig
from cmdgen_tpu.config import GCPGTrainConfig as JGCPGTrainConfig
from cmdgen_tpu.config import from_dict as jfrom_dict
from cmdgen_tpu.models import gcpg as jgcpg
from cmdgen_tpu.train import checkpoint as jckpt
from cmdgen_tpu.train import gcpg_train as jtrain
from cmdgen_tpu_torch import cli, convert
from cmdgen_tpu_torch.config import GCPGModelConfig, GCPGTrainConfig
from cmdgen_tpu_torch.data.dataset import GCPGSmilesDataset
from cmdgen_tpu_torch.models.gcpg import TRAINING_MODULES
from cmdgen_tpu_torch.train import gcpg_train as ttrain

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GRUN = REPO / "cmdgen_tpu_torch" / "assets" / "grun_r5cn"
TOL = dict(atol=2e-4, rtol=1e-4)
CORPUS = ["CC(=O)Nc1ccc(O)cc1", "O=C(O)c1ccccc1Br", "c1ccncc1", "CCN(CC)CC", "COc1ccccc1",
          "CC(C)CO", "OCC(O)CO", "Clc1ccc(N)cc1"]
SCORES = [-7.5, -8.25, -6.0, -5.5, -6.75, -5.0, -4.5, -7.0]
B, BETA = 8, 3e-4


@pytest.fixture(scope="module")
def grun(tmp_path_factory):
    """runs/grun_r5cn/gcpg_ckpt.tgz restored with the JAX package's loader:
    (its directory, the params tree, the flattened leaves, its config)."""
    tmp = tmp_path_factory.mktemp("grun")
    with tarfile.open(REPO / "runs" / "grun_r5cn" / "gcpg_ckpt.tgz") as tf:
        tf.extractall(tmp, filter="data")
    payload, meta = jckpt.load_checkpoint(tmp / "gcpg_ckpt", "last")
    params = jax.tree_util.tree_map(np.asarray, payload["params"])
    return tmp / "gcpg_ckpt", params, convert.flatten_params(params["params"]), meta["config"]


def test_train_params_equal_checkpoint(grun):
    """train_params.npz is the tgz's training leaves, array for array;
    params.npz its decode leaves, and the two cover the tree."""
    _, _, full, _ = grun
    with np.load(GRUN / convert.TRAIN_PARAMS) as npz:
        train = {k: npz[k] for k in npz.files}
    with np.load(GRUN / "params.npz") as npz:
        decode = {k: npz[k] for k in npz.files}
    want = {k: v for k, v in full.items() if k.split("/")[0] in TRAINING_MODULES}
    assert sorted(train) == sorted(want) and {k.split("/")[0] for k in train} == set(
        TRAINING_MODULES)
    for k in want:
        assert train[k].dtype == np.float32, k
        np.testing.assert_array_equal(train[k], want[k], err_msg=k)
    assert sorted(full) == sorted([*train, *decode])
    for k in decode:
        np.testing.assert_array_equal(decode[k], full[k], err_msg=k)


def test_with_training_merges_and_decode_stays_decode_only():
    _, _, decode = convert.read_port_gcpg(GRUN)
    cfg, tok, whole = convert.read_port_gcpg(GRUN, with_training=True)
    assert not {k.split("/")[0] for k in decode} & set(TRAINING_MODULES)
    assert set(whole) - set(decode) and set(decode) <= set(whole)
    model = convert.build_gcpg(cfg, whole, len(tok), "cpu")
    assert model.training_modules
    model, _ = convert.load_port_gcpg(GRUN, "cpu")
    assert not model.training_modules


def test_missing_training_modules_raise(tmp_path):
    """A decode-only checkpoint without train_params.npz raises, naming
    the missing modules and the file; so does one whose file lacks some."""
    for name in ("config.json", "params.npz"):
        shutil.copy(GRUN / name, tmp_path / name)
    with pytest.raises(KeyError) as err:
        convert.read_port_gcpg(tmp_path, with_training=True)
    msg = str(err.value)
    assert all(m in msg for m in TRAINING_MODULES) and convert.TRAIN_PARAMS in msg
    assert "not there" in msg
    with pytest.raises(KeyError, match="not there"):
        ttrain.train_gcpg(GCPGModelConfig(), GCPGTrainConfig(batch_size=2), CORPUS, {},
                          tmp_path / "run", max_steps=1, finetune_from=tmp_path, device="cpu")
    with np.load(GRUN / convert.TRAIN_PARAMS) as npz:
        np.savez(tmp_path / convert.TRAIN_PARAMS,
                 **{k: npz[k] for k in npz.files if not k.startswith("mapping_v/")})
    with pytest.raises(KeyError, match=r"\['mapping_v'\].*incomplete"):
        convert.read_port_gcpg(tmp_path, with_training=True)
    # a decode-only checkpoint still reads as one
    _, _, leaves = convert.read_port_gcpg(tmp_path)
    assert not {k.split("/")[0] for k in leaves} & set(TRAINING_MODULES)


def test_finetune_step_matches_jax(grun):
    """One FINETUNE_GATE step from the whole trained tree (fresh AdamW
    state, steps_per_epoch 2 as the trainer's on 16 molecules at B=8):
    losses, the raw norm, and every weight after it."""
    _, params, _, config = grun
    jcfg = dataclasses.replace(jfrom_dict(JGCPGModelConfig, config["model"]), dropout=0.0)
    cfg, tok, leaves = convert.read_port_gcpg(GRUN, with_training=True)
    cfg = dataclasses.replace(cfg, dropout=0.0)
    data = GCPGSmilesDataset(CORPUS, {"Score": SCORES}, tok, max_len=cfg.max_len,
                             use_random_input_smiles=True, corrupt=True, seed=0)
    batch = data.padded_batch(list(range(B)))
    assert (batch["props"][:, 7] != 0).all()  # the gate keeps the docking score

    jmodel = jgcpg.GCPG(jcfg, vocab_size=len(tok))
    tcfg = JGCPGTrainConfig(condition_gate=jtrain.FINETUNE_GATE)
    opt = jtrain.gcpg_optimizer(tcfg, steps_per_epoch=2)
    jstep = jax.jit(jtrain.make_gcpg_train_step(jmodel, opt, tcfg.condition_gate,
                                                tcfg.grad_clip))
    key = jax.random.PRNGKey(3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    p, _, jmet = jstep(params, opt.init(params), key, jb, BETA)

    tmodel = convert.build_gcpg(cfg, leaves, len(tok), "cpu").train()
    topt = ttrain.gcpg_optimizer(tmodel, GCPGTrainConfig(), steps_per_epoch=2)
    tstep = ttrain.make_gcpg_train_step(ttrain.FINETUNE_GATE, 5.0)
    eps = np.array(jax.random.normal(jax.random.split(key)[0], (B, cfg.hidden_dim)))
    tmet = tstep(tmodel, topt, ttrain.batch_to_device(batch, "cpu"), BETA,
                 eps=torch.from_numpy(eps))
    for k in ("loss", "lm_loss", "kl_loss", "mapping_loss", "grad_norm"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **TOL, err_msg=k)
    ref = convert.flatten_params(jax.tree_util.tree_map(np.asarray, p["params"]))
    got = convert.model_leaves(tmodel)
    assert sorted(got) == sorted(ref)
    lr = ttrain.cosine_decay(3e-4, 8)(0)
    close = total = 0
    for k, r in ref.items():
        np.testing.assert_allclose(got[k], r, atol=0.25 * lr, rtol=0, err_msg=k)
        close += int(np.sum(np.abs(got[k] - r) <= 2e-6 + 1e-5 * np.abs(r)))
        total += r.size
    assert close >= 0.995 * total, (close, total)
    assert topt.count == 1


def test_finetune_cli_from_shipped_weights(tmp_path):
    """train-gcpg --finetune-from assets/grun_r5cn --score-only-gate: one
    step from the shipped weights (every weight within one learning rate
    of them), the shipped tokenizer and model config, a fresh AdamW state
    (count 1 after the step); generate reads the checkpoint it wrote."""
    from cmdgen_tpu_torch.chem.posp import save_posp

    smiles, props = tmp_path / "smiles.txt", tmp_path / "props.json"
    smiles.write_text("\n".join(CORPUS))
    props.write_text(json.dumps({"Score": SCORES}))
    out = tmp_path / "ft"
    model, tok = cli.main(["train-gcpg", str(smiles), str(out), "--props-json", str(props),
                           "--finetune-from", str(GRUN), "--score-only-gate", "--batch-size",
                           "4", "--max-steps", "1", "--epochs", "1", "--device", "cpu"])
    cfg, stok, shipped = convert.read_port_gcpg(GRUN, with_training=True)
    assert tok.to_list() == stok.to_list() and len(tok) == 53
    meta = json.loads((out / "last" / "config.json").read_text())
    assert meta["model"] == json.loads((GRUN / "config.json").read_text())["model"]
    assert meta["train"]["condition_gate"] == list(ttrain.FINETUNE_GATE)
    lr = ttrain.cosine_decay(3e-4, 8)(0)
    _, _, after = convert.read_port_gcpg(out / "last")
    assert sorted(after) == sorted(shipped)
    moved = max(float(np.abs(after[k] - v).max()) for k, v in shipped.items())
    assert 0 < moved <= lr * (1 + 1e-3)
    with np.load(out / "last" / "opt_state.npz") as npz:
        assert int(npz["count"]) == 1
    posp = tmp_path / "hyp.posp"
    save_posp(posp, ["HYBL", "AROM", "HDON"],
              np.array([[0.0, 0.0, 0.0], [3.0, 0.0, 0.0], [0.0, 4.0, 0.0]]))
    cli.main(["generate", str(posp), str(tmp_path / "gen"), str(out), "--n", "4",
              "--no-filter", "--device", "cpu"])
    assert len((tmp_path / "gen" / "hyp_result.txt").read_text().splitlines()) == 4
