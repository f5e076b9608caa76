"""Stage 3's host side in the port against the JAX package: the tokenizer
and its ``syntax_tables``, ``canonical_smiles`` over ``VALENCE_CORPUS``
and its random forms, and the constrained decode's mask
(``SyntaxConstraints``) replayed over the corpus: it equals the JAX test
suite's numpy mirror of ``generate``'s mask at every step and never
forbids the next token of a valid SMILES (the reference's three corners
of the mask are pinned in ``tests/test_torch_gcpg.py``)."""
import random

import numpy as np
import torch

from cmdgen_tpu.chem.mol import canonical_smiles as jcanonical_smiles
from cmdgen_tpu.chem.mol import random_smiles as jrandom_smiles
from cmdgen_tpu.chem.tokenizer import Tokenizer as JTokenizer
from cmdgen_tpu.chem.tokenizer import gen_vocabs as jgen_vocabs
from cmdgen_tpu.chem.tokenizer import syntax_tables as jsyntax_tables
from cmdgen_tpu_torch.chem.mol import canonical_smiles, mol_from_smiles, random_smiles
from cmdgen_tpu_torch.chem.tokenizer import Tokenizer, gen_vocabs, syntax_tables
from cmdgen_tpu_torch.models.gcpg import STACK_D, SyntaxConstraints, SyntaxState
from test_gcpg import VALENCE_CORPUS, _sim_masks, _sim_update

torch.set_num_threads(1)

EXTRA = ["[nH]c1ccccc1[C@@H](O)[13CH3]", "C%10CC%10", "CC(C)(C)O", "C1CC.Cl1",
         "[Na+].[Cl-]", "O=C([O-])CC[N+](C)(C)C"]


def _forms():
    """VALENCE_CORPUS, a few molecules with '.', '%nn' and brackets, and
    six random forms of each valid one (one seeded draw)."""
    rng = random.Random(0)
    forms = []
    for s in VALENCE_CORPUS + EXTRA:
        forms.append(s)
        if mol_from_smiles(s) is None:
            continue
        for _ in range(6):
            r = random_smiles(s, rng)
            if r and mol_from_smiles(r) is not None:
                forms.append(r)
    return forms


FORMS = _forms()


def test_random_forms_equal_jax():
    rng, jrng = random.Random(1), random.Random(1)
    for s in VALENCE_CORPUS + EXTRA:
        assert random_smiles(s, rng) == jrandom_smiles(s, jrng), s


def test_tokenizer_and_syntax_tables_equal_jax():
    tok, jtok = Tokenizer(gen_vocabs(FORMS)), JTokenizer(jgen_vocabs(FORMS))
    assert tok.to_list() == jtok.to_list()
    for s in FORMS:
        ids = tok.parse(s, return_atom_idx=True)
        assert ids == jtok.parse(s, return_atom_idx=True), s
        assert tok.get_text([ids[0][1:]]) == [s]
    np.testing.assert_array_equal(syntax_tables(tok), jsyntax_tables(jtok))
    assert syntax_tables(tok).dtype == np.int32
    grun = Tokenizer.from_list(jtok.to_list())
    np.testing.assert_array_equal(syntax_tables(grun), jsyntax_tables(jtok))


def test_canonical_smiles_equal_jax():
    for s in FORMS + ["C1CC", "C(C", "", "c1cc1X"]:
        assert canonical_smiles(s) == jcanonical_smiles(s), s


def _replay(con, tab, ids, max_len, valence=True):
    """Step through ids [<sos>, ..., <eos>]: yields (t, next id, the port's
    forbidden row, the JAX mirror's forbidden row)."""
    state = SyntaxState.initial(1, "cpu")
    mirror = (0, 0, -1, 0, False, [0] * STACK_D)
    prev = ids[0]
    for t, nxt in enumerate(ids[1:], start=1):
        forb = con.forbidden(state, torch.tensor([prev]), t, max_len, valence)[0]
        yield t, nxt, forb.numpy(), _sim_masks(tab, mirror, prev, t, max_len)
        state = con.update(state, torch.tensor([nxt]), valence)
        mirror = _sim_update(tab, mirror, nxt)
        prev = nxt


def test_mask_replay_equals_mirror_and_never_blocks_valid():
    """Every valid form of the corpus, replayed through the port's mask with
    valence on: the forbidden set equals the JAX suite's mirror of
    ``generate``'s mask at every step, and no actual next token is ever
    forbidden ("C1CC.Cl1" is left out: the reference masks its Cl)."""
    forms = [s for s in FORMS if mol_from_smiles(s) is not None and s != "C1CC.Cl1"]
    tok = Tokenizer(gen_vocabs(FORMS))
    tab = syntax_tables(tok)
    con = SyntaxConstraints(torch.from_numpy(tab))
    checked = 0
    for s in forms:
        ids = tok.parse(s)
        for t, nxt, forb, mirror in _replay(con, tab, ids, len(ids) + 8):
            np.testing.assert_array_equal(forb, mirror, err_msg=f"{s!r} step {t}")
            assert not forb[nxt], f"masked valid token {tok.i2s[nxt]!r} at {t} in {s!r}"
            checked += 1
    assert checked > 1500
