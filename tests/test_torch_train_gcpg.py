"""GCPG training in the port against the JAX package on the CPU at f32: the
KL-beta annealer, the weighted mapping BCE, the teacher-forced forward's
losses and every leaf's gradient (dropout off: the JAX package's
``deterministic=True``, the port's ``eval()`` mode), one whole train step
(clip at global norm 5, the condition gate), ``gcpg_optimizer`` against
``optax.adamw`` on its cosine schedule across ``decay_steps``, dropout,
and the trainer (``train_gcpg``), its checkpoint read by ``generate`` and
by ``--finetune-from``.

Tolerances: values atol 2e-4 / rtol 1e-4; gradients within 1e-3 of each
leaf's largest |g| plus 1e-5 of the tree's; optimizer states and weights
after optax's steps 1e-6 relative. The posterior's draw is the JAX
package's (``k_z, k_drop = split(rng)``, eps = normal(k_z, [B, H])).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cmdgen_tpu.config import GCPGModelConfig as JGCPGModelConfig
from cmdgen_tpu.config import GCPGTrainConfig as JGCPGTrainConfig
from cmdgen_tpu.config import to_dict
from cmdgen_tpu.models import gcpg as jgcpg
from cmdgen_tpu.train import gcpg_train as jtrain
from cmdgen_tpu_torch import cli, convert
from cmdgen_tpu_torch.chem.tokenizer import Tokenizer, gen_vocabs
from cmdgen_tpu_torch.config import GCPGModelConfig, GCPGTrainConfig, from_dict
from cmdgen_tpu_torch.data.dataset import GCPGSmilesDataset
from cmdgen_tpu_torch.models.transformer import Dropout
from cmdgen_tpu_torch.train import gcpg_train as ttrain
from cmdgen_tpu_torch.train.state import AdamW, cosine_decay

torch.set_num_threads(1)

TOL = dict(atol=2e-4, rtol=1e-4)
CORPUS = ["CCO", "CC(=O)O", "c1ccccc1", "CC(C)CO", "CCN", "CCOC", "CC(=O)Nc1ccccc1",
          "OCC(O)CO", "c1ccncc1", "CCCCN"]
MAX_LEN = 24


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jcfg(dropout):
    return JGCPGModelConfig(max_len=MAX_LEN, hidden_dim=32, n_layers=2, ff_dim=64, n_head=4,
                            pp_encoder_n_layer=2, dropout=dropout)


@pytest.fixture(scope="module")
def setup():
    """A batch of the port's dataset (the JAX package's copy), the flax
    GCPG's params (dropout 0.1) and the vocabulary size."""
    tok = Tokenizer(gen_vocabs(CORPUS))
    props = {"MW": list(np.linspace(40, 140, len(CORPUS))), "logP": [0.5] * len(CORPUS),
             "QED": [0.4] * len(CORPUS)}
    data = GCPGSmilesDataset(CORPUS, props, tok, max_len=MAX_LEN, use_random_input_smiles=True,
                             corrupt=True, seed=0)
    batch = data.padded_batch(list(range(8)))
    jmodel = jgcpg.GCPG(_jcfg(0.1), vocab_size=len(tok))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jax.random.PRNGKey(1), batch["inputs"],
                         batch["input_valid"], batch["pp_h"], batch["pp_e"], batch["pp_mask"],
                         batch["targets"], batch["props"][:, jtrain.COND_IDX])
    return batch, params, len(tok)


def _port(params, vocab, dropout):
    tcfg = from_dict(GCPGModelConfig, to_dict(_jcfg(dropout)))
    return convert.build_gcpg(tcfg, _np(params["params"]), vocab, "cpu")


def _eps(rng, b):
    k_z, _ = jax.random.split(rng)
    return jax.random.normal(k_z, (b, 32))


def test_gen_beta_matches_jax():
    ref = jtrain.default_beta_schedule(JGCPGTrainConfig())
    out = ttrain.default_beta_schedule(GCPGTrainConfig())
    for _ in range(40):
        assert next(out) == next(ref)


def test_mapping_bce_matches_jax(setup):
    batch, _, _ = setup
    rng = np.random.RandomState(0)
    scores = rng.rand(*batch["mapping"].shape).astype(np.float32)
    ref = jtrain.mapping_bce(jnp.asarray(scores), jnp.asarray(batch["mapping"]),
                             jnp.asarray(batch["pp_h"][..., :7]))
    out = ttrain.mapping_bce(torch.from_numpy(scores), torch.from_numpy(batch["mapping"]),
                             torch.from_numpy(batch["pp_h"][..., :7]))
    assert (batch["mapping"] == -100).any() and (batch["mapping"] == 1).any()
    np.testing.assert_allclose(out.item(), float(ref), **TOL)


def test_forward_losses_and_gradients_match_jax(setup):
    """The deterministic teacher-forced forward: logits, mapping scores, LM
    and KL losses, and the gradient of LM + beta KL + mapping BCE per leaf."""
    batch, params, vocab = setup
    jmodel = jgcpg.GCPG(_jcfg(0.1), vocab_size=vocab)
    tmodel = _port(params, vocab, 0.1)  # eval() mode: dropout off
    key = jax.random.PRNGKey(5)
    k_z = jax.random.split(key)[0]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    conds = jb["props"][:, jtrain.COND_IDX]
    beta = 0.01

    def loss(p):
        logits, scores, lm, kl = jmodel.apply(p, k_z, jb["inputs"], jb["input_valid"],
                                              jb["pp_h"], jb["pp_e"], jb["pp_mask"],
                                              jb["targets"], conds, deterministic=True)
        mp = jtrain.mapping_bce(scores, jb["mapping"], jb["pp_h"][..., :7])
        return lm + beta * kl + mp, (logits, scores, lm, kl)

    (total, (logits, scores, lm, kl)), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(params)
    tb = ttrain.batch_to_device(batch, "cpu")
    eps = torch.from_numpy(np.array(jax.random.normal(k_z, (8, 32))))
    out = tmodel(tb["inputs"], tb["input_valid"], tb["pp_h"], tb["pp_e"], tb["pp_mask"],
                 tb["targets"], tb["props"][:, torch.from_numpy(ttrain.COND_IDX)], eps=eps)
    for got, ref in zip(out, (logits, scores, lm, kl)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    ttotal = out[2] + beta * out[3] + ttrain.mapping_bce(out[1], tb["mapping"],
                                                         tb["pp_h"][..., :7])
    np.testing.assert_allclose(ttotal.item(), float(total), **TOL)
    ttotal.backward()
    ref = convert.flatten_params(_np(grads["params"]))
    # a weight the loss does not reach (the last layer's edge output) has
    # no gradient here and a zero one in JAX
    got = convert.model_leaves(tmodel, {n: torch.zeros_like(p) if p.grad is None else p.grad
                                        for n, p in tmodel.named_parameters()})
    assert set(got) == set(ref)
    tree_max = max(np.abs(v).max() for v in ref.values())
    for path, r in ref.items():
        tol = 1e-3 * np.abs(r).max() + 1e-5 * tree_max
        assert np.abs(got[path] - r).max() <= tol, path


def test_train_step_matches_jax(setup):
    """One step of ``make_gcpg_train_step`` (dropout rate 0, so the JAX
    step's randomness is the posterior draw alone): losses, the raw norm
    (above 5: the clip acts), the weights and AdamW's state after it,
    from an AdamW state carried over from two JAX steps."""
    batch, params, vocab = setup
    jmodel = jgcpg.GCPG(_jcfg(0.0), vocab_size=vocab)
    cfg = JGCPGTrainConfig()
    opt = jtrain.gcpg_optimizer(cfg, steps_per_epoch=2)
    jstep = jax.jit(jtrain.make_gcpg_train_step(jmodel, opt, cfg.condition_gate,
                                                cfg.grad_clip))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    p, st = params, opt.init(params)
    for seed in (1, 2):
        p, st, _ = jstep(p, st, jax.random.PRNGKey(seed), jb, 3e-4)
    tmodel = _port(p, vocab, 0.0).train()
    topt = ttrain.gcpg_optimizer(tmodel, GCPGTrainConfig(), steps_per_epoch=2)
    convert.load_optimizer_arrays(tmodel, topt, convert.port_opt_state(_np(st)))
    key = jax.random.PRNGKey(3)
    p, st, jmet = jstep(p, st, key, jb, 3e-4)
    tstep = ttrain.make_gcpg_train_step(GCPGTrainConfig().condition_gate, 5.0)
    tmet = tstep(tmodel, topt, ttrain.batch_to_device(batch, "cpu"), 3e-4,
                 eps=torch.from_numpy(np.array(_eps(key, 8))))
    for k in ("loss", "lm_loss", "kl_loss", "mapping_loss", "grad_norm"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **TOL, err_msg=k)
    ref = convert.flatten_params(_np(p["params"]))
    got = convert.model_leaves(tmodel)
    # Adam divides each element's gradient by its own scale, so an element
    # whose gradient lies at float32 rounding (an attention's key bias,
    # which the softmax removes; weights the loss barely reaches) moves by
    # a rounding-set fraction of the learning rate in either package:
    # every element is held within a quarter of this step's learning rate,
    # and all but 0.5% of them at atol 2e-6 / rtol 1e-5
    lr = ttrain.cosine_decay(3e-4, 8)(2)
    close = total = 0
    for k, r in ref.items():
        np.testing.assert_allclose(got[k], r, atol=0.25 * lr, rtol=0, err_msg=k)
        close += int(np.sum(np.abs(got[k] - r) <= 2e-6 + 1e-5 * np.abs(r)))
        total += r.size
    assert close >= 0.995 * total, (close, total)
    assert topt.count == 3
    back = convert.optax_state(convert.optimizer_arrays(tmodel, topt), st)
    assert int(back[0].count) == int(back[2].count) == 3


def test_gcpg_optimizer_matches_optax_across_decay_steps():
    """AdamW on the cosine schedule, T = cosine_t_max * steps_per_epoch = 4,
    over 7 steps: parameters and state within 1e-6 of optax's at each step;
    the learning rate is 0 from step T on (the clamped cosine)."""
    cfg = JGCPGTrainConfig(lr=1e-2)
    opt = jtrain.gcpg_optimizer(cfg, steps_per_epoch=1)
    rng = np.random.RandomState(0)
    p0 = {"w": rng.randn(5, 4).astype(np.float32)}
    jp = {"w": jnp.asarray(p0["w"])}
    st = opt.init(jp)
    w = torch.nn.Parameter(torch.from_numpy(p0["w"].copy()))
    topt = AdamW([w], cosine_decay(1e-2, 4), weight_decay=1e-6)
    lrs = []
    for _ in range(7):
        g = rng.randn(5, 4).astype(np.float32)
        lrs.append(topt.lr())
        up, st = opt.update({"w": jnp.asarray(g)}, st, jp)
        jp = optax.apply_updates(jp, up)
        w.grad = torch.from_numpy(g)
        topt.step()
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(jp["w"]), rtol=1e-6, atol=0)
        for key in ("mu", "nu"):
            np.testing.assert_allclose(topt.state[w][key].numpy(),
                                       np.asarray(getattr(st[0], key)["w"]), rtol=1e-6)
    sched = optax.cosine_decay_schedule(1e-2, 4)
    np.testing.assert_allclose(lrs, [float(sched(i)) for i in range(7)], rtol=1e-6, atol=0)
    assert lrs[4:] == [0.0, 0.0, 0.0] and lrs[3] > 0


def test_dropout_train_and_eval():
    """Train mode: about 10% of a large tensor zeroed, the rest scaled by
    1 / 0.9, the mask drawn from the given generator; eval mode: the
    input unchanged."""
    drop = Dropout(0.1)
    x = torch.ones(200_000)
    drop.generator = torch.Generator().manual_seed(0)
    y = drop.train()(x)
    frac = float((y == 0).float().mean())
    assert abs(frac - 0.1) < 0.005
    np.testing.assert_allclose(y[y != 0].numpy(), 1 / 0.9, rtol=1e-6)
    drop.generator = torch.Generator().manual_seed(0)
    assert torch.equal(drop(x), y)
    assert drop.eval()(x) is x


def test_eval_mode_forward_unchanged_by_dropout(setup):
    """At rate 0.1 in eval() mode the model computes exactly what it does
    at rate 0 (every decode runs so); in train() mode it differs."""
    batch, params, vocab = setup
    tb = ttrain.batch_to_device(batch, "cpu")
    conds = tb["props"][:, torch.from_numpy(ttrain.COND_IDX)]
    eps = torch.zeros(8, 32)
    args = (tb["inputs"], tb["input_valid"], tb["pp_h"], tb["pp_e"], tb["pp_mask"],
            tb["targets"], conds)
    with torch.no_grad():
        a = _port(params, vocab, 0.1)(*args, eps=eps)[0]
        b = _port(params, vocab, 0.0)(*args, eps=eps)[0]
        c = _port(params, vocab, 0.1).train()(*args, eps=eps)[0]
    assert torch.equal(a, b)
    assert not torch.allclose(a, c)


def test_step_loss_falls_on_a_fixed_batch(setup):
    """Eight port steps on one batch (dropout on, as the JAX package's
    test_gcpg_dataset_and_train_step): the loss falls."""
    batch, params, vocab = setup
    tmodel = _port(params, vocab, 0.1).train()
    opt = ttrain.gcpg_optimizer(tmodel, GCPGTrainConfig(), steps_per_epoch=10)
    step = ttrain.make_gcpg_train_step(GCPGTrainConfig().condition_gate)
    gen = torch.Generator().manual_seed(2)
    ttrain.set_dropout_generator(tmodel, gen)
    tb = ttrain.batch_to_device(batch, "cpu")
    losses = [float(step(tmodel, opt, tb, 3e-4, generator=gen)["loss"]) for _ in range(8)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


@pytest.fixture(scope="module")
def gcpg_run(tmp_path_factory):
    """train-gcpg through the CLI at a small width: 8 steps (4 epochs of
    2) on the corpus."""
    import dataclasses

    out = tmp_path_factory.mktemp("gcpg_run")
    smiles = tmp_path_factory.mktemp("gcpg_data") / "smiles.txt"
    smiles.write_text("\n".join(CORPUS * 2))
    small = from_dict(GCPGModelConfig, to_dict(_jcfg(0.1)))
    logs = []
    real = ttrain.train_gcpg

    def small_width(model_cfg, tcfg, *a, **kw):
        kw["log_fn"] = lambda s, m: logs.append(m)
        return real(small, dataclasses.replace(tcfg, save_freq=2), *a, **kw)

    ttrain.train_gcpg = small_width
    try:
        model, tok = cli.main(["train-gcpg", str(smiles), str(out), "--batch-size", "8",
                               "--epochs", "4", "--max-steps", "8", "--device", "cpu"])
    finally:
        ttrain.train_gcpg = real
    return out, model, tok, logs


def test_train_gcpg_checkpoints_and_loss(gcpg_run):
    out, model, tok, logs = gcpg_run
    epochs = [m["loss/train"] for m in logs if "loss/train" in m]
    assert len(epochs) == 4 and all(np.isfinite(epochs)) and epochs[-1] < epochs[0]
    for name in ("best", "last"):
        assert sorted(p.name for p in (out / name).iterdir()) == [
            "config.json", "opt_state.npz", "params.npz"]
    _, ttok, leaves = convert.read_port_gcpg(out / "last")
    assert ttok.to_list() == tok.to_list()
    np.testing.assert_array_equal(leaves["word_embed/embedding"],
                                  model.word_embed.weight.detach().numpy())
    with np.load(out / "last" / "opt_state.npz") as npz:
        assert int(npz["count"]) == 8


def test_generate_and_finetune_from_checkpoint(gcpg_run, tmp_path):
    import dataclasses

    from cmdgen_tpu_torch.chem.posp import save_posp

    out, _, tok, _ = gcpg_run
    posp = tmp_path / "hyp.posp"
    save_posp(posp, ["HYBL", "AROM", "HDON"],
              np.array([[0.0, 0.0, 0.0], [3.0, 0.0, 0.0], [0.0, 4.0, 0.0]]))
    cli.main(["generate", str(posp), str(tmp_path / "gen"), str(out), "--n", "4",
              "--no-filter", "--device", "cpu"])
    # one line a row, an empty decode an empty line (--no-filter keeps it)
    lines = (tmp_path / "gen" / "hyp_result.txt").read_text().splitlines()
    assert len(lines) == 4
    small = from_dict(GCPGModelConfig, to_dict(_jcfg(0.1)))
    logs = []
    model, ftok = ttrain.train_gcpg(
        small, dataclasses.replace(GCPGTrainConfig(), batch_size=8,
                                   condition_gate=ttrain.FINETUNE_GATE, n_epochs=1),
        CORPUS, {}, tmp_path / "ft", max_steps=1, finetune_from=out, device="cpu",
        gen_eval_every=1, gen_eval_n=2, log_fn=lambda s, m: logs.append(m))
    assert ftok.to_list() == tok.to_list() and not model.training
    gen = [m for m in logs if "gen/n_eval" in m]
    assert len(gen) == 1 and gen[0]["gen/n_eval"] == 2
    with np.load(tmp_path / "ft" / "last" / "opt_state.npz") as npz:
        assert int(npz["count"]) == 1


def test_train_gcpg_resident_plan(tmp_path):
    """Without max_steps, a corpus whose variants fit trains from rows on
    the device: 2 pre-drawn variants per molecule, an epoch of
    len // batch steps drawn with RandomState(seed + 1), rebuilt at full
    precision (input_valid = inputs != PAD)."""
    import dataclasses

    small = from_dict(GCPGModelConfig, to_dict(_jcfg(0.1)))
    tcfg = dataclasses.replace(GCPGTrainConfig(), batch_size=4, n_epochs=2, save_freq=1,
                               resident_data="on", resident_variants=2)
    logs = []
    ttrain.train_gcpg(small, tcfg, CORPUS, {}, tmp_path, log_fn=lambda s, m: logs.append((s, m)),
                      device="cpu")
    epochs = [(s, m["loss/train"]) for s, m in logs if "loss/train" in m]
    assert [s for s, _ in epochs] == [2, 4] and all(np.isfinite([v for _, v in epochs]))
    with np.load(tmp_path / "last" / "opt_state.npz") as npz:
        assert int(npz["count"]) == 4
