"""Stage 3 parity: the port's GCPG (``cmdgen_tpu_torch.models``: transformer,
pp encoder, GCPG and its constrained decode) against the JAX package on
the CPU at f32, with the same numpy-seeded inputs and flax params, at the
small shape of ``tests/test_gcpg.py`` (hidden 32, 2 layers, pp encoder 2,
max_len 24) over a ``VALENCE_CORPUS`` vocabulary.

Tolerance: atol 2e-4 / rtol 1e-4. Random draws are JAX's own: the
posterior eps and prior z from their keys, and for sampled decode the
Gumbel noise of every step (``generate``'s ``k_z, k_scan = split(rng)``,
then ``key, sub = split(key)`` and ``gumbel(sub, (B, V))`` per step), which
reproduce ``jax.random.categorical``. Decoded tokens must be equal; a row
may differ only where, at its first differing step, JAX's top two
(masked, tempered, noised) scores lie within 1e-4 of each other. One JAX
compile per static configuration of ``generate``, shared by a
module-scoped fixture. The reference's three corners of the constrained
mask (ROADMAP section C) are pinned as they are, not fixed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmdgen_tpu.chem.tokenizer import Tokenizer as JTokenizer
from cmdgen_tpu.chem.tokenizer import gen_vocabs as jgen_vocabs
from cmdgen_tpu.chem.tokenizer import syntax_tables as jsyntax_tables
from cmdgen_tpu.config import GCPGModelConfig as JGCPGModelConfig
from cmdgen_tpu.config import to_dict
from cmdgen_tpu.models import gcpg as jgcpg
from cmdgen_tpu.models.ppencoder import PPEncoder as JPPEncoder
from cmdgen_tpu_torch.chem.mol import mol_from_smiles
from cmdgen_tpu_torch.chem.tokenizer import Tokenizer, gen_vocabs, syntax_tables
from cmdgen_tpu_torch.config import GCPGModelConfig, from_dict
from cmdgen_tpu_torch.convert import DECODE_MODULES, build_gcpg, gcpg_state_dict, load_state
from cmdgen_tpu_torch.models.gcpg import (
    SyntaxConstraints,
    SyntaxState,
    generate,
    popcount32,
)
from cmdgen_tpu_torch.models.ppencoder import PPEncoder
from cmdgen_tpu_torch.models.transformer import valid_bias
from test_gcpg import VALENCE_CORPUS

torch.set_num_threads(1)

TOL = dict(atol=2e-4, rtol=1e-4)
TIE_GAP = 1e-4
JCFG = JGCPGModelConfig(max_len=24, hidden_dim=32, n_layers=2, ff_dim=64, n_head=4,
                        pp_encoder_n_layer=2, dropout=0.0)
B, S = 8, 16


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def setup():
    """The flax GCPG and its params over a VALENCE_CORPUS vocabulary, the
    port's model built from the same params, and numpy-seeded inputs."""
    tok = JTokenizer(jgen_vocabs(VALENCE_CORPUS))
    vocab = len(tok)
    rng = np.random.RandomState(0)
    inputs = rng.randint(4, vocab, (B, S))
    input_valid = (np.arange(S)[None] < rng.randint(8, S + 1, (B, 1))).astype(np.float32)
    pp_h = rng.rand(B, 8, 8).astype(np.float32)
    pp_e = (rng.rand(B, 8, 8, 1) * 5).astype(np.float32)
    pp_mask = (np.arange(8)[None] < rng.randint(3, 9, (B, 1))).astype(np.float32)
    targets = rng.randint(3, vocab, (B, S))
    targets[:, 0] = tok.SOS
    targets[:, -3:] = tok.PAD
    conds = rng.rand(B, 7).astype(np.float32)
    data = (inputs, input_valid, pp_h, pp_e, pp_mask, targets, conds)
    jmodel = jgcpg.GCPG(JCFG, vocab_size=vocab)
    params = jmodel.init(jax.random.PRNGKey(0), jax.random.PRNGKey(1),
                         *[jnp.asarray(a) for a in data])
    tcfg = from_dict(GCPGModelConfig, to_dict(JCFG))
    tmodel = build_gcpg(tcfg, _np(params["params"]), vocab, "cpu")
    return jmodel, params, tmodel, tok, data


def _apply(jmodel, params, fn, *args):
    """Run ``fn(module, *args)`` inside the bound flax module."""
    return jmodel.apply(params, *args, method=fn)


def test_transformer_encoder_matches_jax(setup):
    jmodel, params, tmodel, _, _ = setup
    rng = np.random.RandomState(1)
    x = rng.randn(B, 12, 32).astype(np.float32)
    valid = (np.arange(12)[None] < rng.randint(4, 13, (B, 1))).astype(np.float32)
    ref = _apply(jmodel, params, lambda m, x, v: m.encoder(x, v), x, valid)
    with torch.no_grad():
        out = tmodel.encoder(_t(x), _t(valid))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_transformer_decoder_matches_jax(setup):
    jmodel, params, tmodel, _, _ = setup
    rng = np.random.RandomState(2)
    x = rng.randn(B, 9, 32).astype(np.float32)
    mem = rng.randn(B, 10, 32).astype(np.float32)
    mem_valid = (np.arange(10)[None] < rng.randint(3, 11, (B, 1))).astype(np.float32)
    ref = _apply(jmodel, params, lambda m, x, mm, v: m.decoder(x, mm, v), x, mem, mem_valid)
    with torch.no_grad():
        out = tmodel.decoder(_t(x), _t(mem), _t(mem_valid))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_decode_step_matches_full_decoder(setup):
    """The KV-cache decode, one token at a time into the fixed cache,
    against the full causal decoder over the same prefix, in both
    packages (the port's decode against JAX's full decoder)."""
    jmodel, params, tmodel, _, (_, _, pp_h, pp_e, pp_mask, targets, conds) = setup
    z = np.random.RandomState(3).randn(B, 32).astype(np.float32)
    with torch.no_grad():
        mem, mem_valid = tmodel.prior_memory(_t(pp_h), _t(pp_e), _t(pp_mask), _t(conds), z=_t(z))
        cache_k, cache_v = tmodel.init_cache(B)
        mem_kv, mem_bias = tmodel.decoder.memory_kv(mem), valid_bias(mem_valid)
        steps = [tmodel.decode_one(_t(targets[:, t]), t, mem_kv, mem_bias, cache_k,
                                   cache_v)[0] for t in range(10)]
        inc = torch.stack(steps, dim=1)
        full = tmodel.word_pred(tmodel.decoder(
            tmodel.word_embed(_t(targets[:, :10])) + tmodel.pos[None, :10], mem, mem_valid))
    torch.testing.assert_close(inc, full, **TOL)

    def jfull(m, prefix, z):
        jmem, jvalid = m.fuse_memory(z, m.process_p(pp_h, pp_e, pp_mask)[1], pp_mask,
                                     m.embed_cond(conds))
        out = m.decoder(m.word_embed(prefix) + m.pos[None, :10], jmem, jvalid)
        return m.word_pred(out)

    ref = _apply(jmodel, params, jfull, targets[:, :10], z)
    np.testing.assert_allclose(inc.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("variant", ["egat", "ggcn", "gine", "graphtransformer"])
def test_ppencoder_variants_match_jax(variant):
    rng = np.random.RandomState(4)
    b, n, d = 3, 8, 32
    h = rng.randn(b, n, d).astype(np.float32)
    e = rng.randn(b, n, n, d).astype(np.float32)
    mask = (np.arange(n)[None] < np.array([[3], [5], [8]])).astype(np.float32)
    enc = JPPEncoder(d, n_layers=2, variant=variant)
    params = enc.init(jax.random.PRNGKey(0), h, e, mask)
    ref = enc.apply(params, h, e, mask)
    port = PPEncoder(d, n_layers=2, variant=variant)
    load_state(port, gcpg_state_dict(_np(params["params"])))
    with torch.no_grad():
        out = port.eval()(_t(h), _t(e), _t(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert float(out[mask == 0].abs().max()) == 0.0


def test_gcpg_forward_matches_jax(setup):
    """Teacher-forced logits, mapping scores, lm_loss and kl, with JAX's
    posterior eps."""
    jmodel, params, tmodel, _, data = setup
    key = jax.random.PRNGKey(5)
    ref = jmodel.apply(params, key, *[jnp.asarray(a) for a in data])
    eps = _t(jax.random.normal(key, (B, JCFG.hidden_dim)))
    with torch.no_grad():
        out = tmodel(*[_t(a) for a in data], eps=eps)
    for name, o, r in zip(("logits", "mapping_scores", "lm_loss", "kl"), out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), err_msg=name, **TOL)


def test_prior_memory_matches_jax(setup):
    jmodel, params, tmodel, _, (_, _, pp_h, pp_e, pp_mask, _, conds) = setup
    key = jax.random.PRNGKey(6)
    ref_mem, ref_valid = jmodel.apply(params, key, pp_h, pp_e, pp_mask, conds,
                                      method=jgcpg.GCPG.prior_memory)
    z = _t(jax.random.normal(key, (B, JCFG.hidden_dim)))
    with torch.no_grad():
        mem, valid = tmodel.prior_memory(_t(pp_h), _t(pp_e), _t(pp_mask), _t(conds), z=z)
    np.testing.assert_allclose(mem.numpy(), np.asarray(ref_mem), **TOL)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))


def test_decode_only_model_matches_and_refuses_training(setup):
    """A model built from the decode modules' arrays alone gives the same
    prior memory, and its training entry points raise, saying why."""
    _, params, tmodel, tok, (inputs, iv, pp_h, pp_e, pp_mask, targets, conds) = setup
    flat = {k: v for k, v in _np(params["params"]).items() if k in DECODE_MODULES}
    small = build_gcpg(tmodel.cfg, flat, len(tok), "cpu")
    assert not small.training_modules and not hasattr(small, "encoder")
    z = torch.randn(B, 32, generator=torch.Generator().manual_seed(0))
    args = [_t(a) for a in (pp_h, pp_e, pp_mask, conds)]
    with torch.no_grad():
        torch.testing.assert_close(small.prior_memory(*args, z=z)[0],
                                   tmodel.prior_memory(*args, z=z)[0], rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="decode-only"):
        small(*[_t(a) for a in (inputs, iv, pp_h, pp_e, pp_mask, targets, conds)])
    with pytest.raises(RuntimeError, match="decode-only"):
        small.posterior_memory(*[_t(a) for a in (inputs, iv, pp_h, pp_e, pp_mask, conds)])


def test_popcount_counts_bit_31():
    x = torch.tensor([0, 1, 7, -1, np.int32(1) << np.int32(31), (1 << 30) | 5],
                     dtype=torch.int32)
    assert popcount32(x, torch.arange(32, dtype=torch.int32)).tolist() == [0, 1, 3, 32, 1, 3]


# ------------------------------------------------------------------ decode

def _jax_draws(rng, steps, vocab):
    """generate's draws: z from k_z, and per step gumbel(sub, (B, V)) from
    k_scan's splits."""
    k_z, k_scan = jax.random.split(rng)
    z = jax.random.normal(k_z, (B, JCFG.hidden_dim))
    subs, key = [], k_scan
    for _ in range(steps):
        key, sub = jax.random.split(key)
        subs.append(sub)
    g = jnp.stack([jax.random.gumbel(sub, (B, vocab)) for sub in subs])
    return z, g, subs


def test_gumbel_draws_reproduce_categorical():
    rng = np.random.RandomState(7)
    logits = jnp.asarray(rng.randn(B, 40).astype(np.float32) * 2)
    logits = logits.at[:, 5].set(-1e9)  # a masked column stays unpicked
    _, g, subs = _jax_draws(jax.random.PRNGKey(8), 6, 40)
    for sub, gi in zip(subs, g):
        want = jax.random.categorical(sub, logits / 0.7, axis=-1)
        got = torch.argmax(_t(logits) / torch.tensor(0.7) + _t(gi), dim=-1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


MODES = {"free": (False, False), "constraints": (True, False), "valence": (True, True)}


@pytest.fixture(scope="module")
def jax_decodes(setup):
    """JAX's generate once per static configuration, its tokens cached by
    (mode, sampled, temperature)."""
    jmodel, params, _, tok, (_, _, pp_h, pp_e, pp_mask, _, conds) = setup
    tables = jnp.asarray(jsyntax_tables(tok))
    cache = {}

    def run(mode, sampled, temperature):
        k = (mode, sampled, temperature)
        if k not in cache:
            constrain, valence = MODES[mode]
            cache[k] = np.asarray(jgcpg.generate(
                jmodel, params, jax.random.PRNGKey(9), pp_h, pp_e, pp_mask, conds,
                random_sample=sampled, temperature=temperature,
                constraints=tables if constrain else None, valence=valence))
        return cache[k]

    return run


def _replay_forbidden(con, toks, t, max_len, valence):
    """The port's mask at scan step t after the prefix toks[:, :t-1]."""
    b = toks.shape[0]
    state = SyntaxState.initial(b, "cpu")
    prev = torch.zeros(b, dtype=torch.int64)
    for i in range(t - 1):
        nxt = torch.from_numpy(toks[:, i]).long()
        state = con.update(state, nxt, valence)
        prev = nxt
    return con.forbidden(state, prev, t, max_len, valence)


def _jax_scores(setup, jtoks, t, z, g, temperature, sampled, con, valence):
    """JAX's scores at scan step t for every row, from JAX's prefix: its
    full decoder's logits over [<sos>, tokens before t], the port's
    integer mask of that prefix, then temperature and noise as decoded."""
    jmodel, params, _, _, (_, _, pp_h, pp_e, pp_mask, _, conds) = setup
    prefix = np.concatenate([np.zeros((B, 1), np.int64), jtoks[:, :t - 1]], axis=1)

    def f(m):
        mem, valid = m.fuse_memory(z, m.process_p(pp_h, pp_e, pp_mask)[1], pp_mask,
                                   m.embed_cond(conds))
        out = m.decoder(m.word_embed(prefix) + m.pos[None, :t], mem, valid)
        return m.word_pred(out[:, -1])

    logits = _t(_apply(jmodel, params, f))
    if con is not None:
        forb = _replay_forbidden(con, jtoks, t, JCFG.max_len, valence)
        logits = torch.where(forb, -1e9, logits)
    if sampled:
        logits = logits / torch.tensor(max(temperature, 1e-6)) + _t(g[t - 1])
    return logits


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("sampled,temperature", [(False, 1.0), (True, 1.0), (True, 2.5)],
                         ids=["greedy", "sampled_T1", "sampled_T2.5"])
def test_generate_matches_jax(setup, jax_decodes, mode, sampled, temperature):
    """Greedy and sampled decode token for token on JAX's draws,
    unconstrained, constrained and with the valence state machine."""
    jmodel, params, tmodel, tok, (_, _, pp_h, pp_e, pp_mask, _, conds) = setup
    constrain, valence = MODES[mode]
    want = jax_decodes(mode, sampled, temperature)
    z, g, _ = _jax_draws(jax.random.PRNGKey(9), JCFG.max_len - 1, len(tok))
    tables = torch.from_numpy(jsyntax_tables(tok)) if constrain else None
    got = generate(tmodel, _t(pp_h), _t(pp_e), _t(pp_mask), _t(conds), random_sample=sampled,
                   z=_t(z), temperature=temperature, constraints=tables, valence=valence,
                   gumbel=_t(g) if sampled else None).numpy()
    assert got.shape == want.shape == (B, JCFG.max_len - 1)
    con = None if tables is None else SyntaxConstraints(tables)
    for r in np.flatnonzero((got != want).any(axis=1)):
        t = int(np.flatnonzero(got[r] != want[r])[0]) + 1
        scores = _jax_scores(setup, want, t, z, g, temperature, sampled, con, valence)[r]
        top2 = torch.topk(scores, 2).values
        gap = float(top2[0] - top2[1])
        assert gap < TIE_GAP, f"row {r} differs at step {t} where JAX's top-two gap is {gap}"


# ------------------------------------------------ the reference's corners

def _state_after(smiles, vocab_smiles, max_len=40):
    """(tokenizer, forbidden row after the whole string, final state)."""
    tok = Tokenizer(gen_vocabs(vocab_smiles))
    tab = syntax_tables(tok)
    con = SyntaxConstraints(torch.from_numpy(tab))
    ids = tok.parse(smiles)[:-1]  # without <eos>
    state = SyntaxState.initial(1, "cpu")
    for nxt in ids[1:]:
        state = con.update(state, torch.tensor([nxt]), True)
    t = len(ids)
    forb = con.forbidden(state, torch.tensor([ids[-1]]), t, max_len, True)[0]
    return tok, forb, state


def test_corner_all_forbidden_after_exhausted_branch():
    """ROADMAP C4, gcpg.py:426: after O1(C) the ring is open at depth 0 and
    O's budget is spent, and without '.' in the vocabulary every token is
    forbidden (every logit becomes -1e9)."""
    tok, forb, state = _state_after("O1(C)", VALENCE_CORPUS)
    assert "." not in tok.s2i
    assert state.prev.item() == 0 and state.rings.item() != 0 and state.depth.item() == 0
    assert bool(forb.all())


def test_corner_liveness_masks_cl_in_dot_fragment():
    """ROADMAP C4, gcpg.py:422: with a ring open at depth 0, a new
    fragment's one-valent atom is masked though 'C1CC.Cl1' is valid."""
    assert mol_from_smiles("C1CC.Cl1") is not None
    tok, forb, _ = _state_after("C1CC.", VALENCE_CORPUS + ["C1CC.Cl1"])
    assert bool(forb[tok.s2i["Cl"]])
    assert not bool(forb[tok.s2i["C"]])


@pytest.mark.parametrize("prefix,fresh", [("C(", True), ("C(1", False), ("C(C", False)])
def test_corner_ring_label_after_open_clears_fresh(prefix, fresh):
    """ROADMAP C4, gcpg.py:482: '(' sets fresh (the attachment atom is the
    stacked copy); a ring label right after it clears fresh, as an atom
    does."""
    _, _, state = _state_after(prefix, VALENCE_CORPUS + ["C1(C1)"])
    assert bool(state.fresh.item()) is fresh
