"""Regex SMILES tokenizer.

Behavioral equivalent of GCPG's Tokenizer (GCPG/utils/dataset.py:20-116):
same token pattern (bracket atoms; two-char halogens; aromatic organic
subset; stereo @@/@; two-digit ring closures %dd; any other single char),
same 32 reserved special-token slots, same unknown→<mask> policy, and the
same vocabulary ordering rule (specials first, then tokens sorted by
(length, lexicographic)) so vocab files are interoperable across runs.

A copy of ``cmdgen_tpu/chem/tokenizer.py`` that reads the port's
``chem.mol``.
"""
from __future__ import annotations

import re
from typing import Iterable, List, Sequence, Tuple

NUM_RESERVED_TOKENS = 32
SPECIAL_TOKENS: Tuple[str, ...] = ("<sos>", "<eos>", "<pad>", "<mask>", "<sep>", "<unk>")
SPECIAL_TOKENS += tuple(
    f"<t_{i}>" for i in range(len(SPECIAL_TOKENS), NUM_RESERVED_TOKENS)
)

PATTERN = re.compile(
    r"\[[^\]]+\]"
    r"|B[r]?|C[l]?|N|O|P|S|F|I"
    r"|[bcnops]"
    r"|@@|@"
    r"|%\d{2}"
    r"|."
)

ATOM_PATTERN = re.compile(
    r"\[[^\]]+\]"
    r"|B[r]?|C[l]?|N|O|P|S|F|I"
    r"|[bcnops]"
)


def gen_vocabs(smiles_list: Iterable[str]) -> set:
    vocabs = set()
    for s in set(smiles_list):
        vocabs.update(PATTERN.findall(s))
    return vocabs


class Tokenizer:
    SOS, EOS, PAD, MASK = 0, 1, 2, 3

    def __init__(self, vocabs: Iterable[str]):
        specials = list(SPECIAL_TOKENS)
        rest = sorted(set(vocabs) - set(specials), key=lambda x: (len(x), x))
        self.vocabs: List[str] = specials + rest
        self.i2s = dict(enumerate(self.vocabs))
        self.s2i = {s: i for i, s in self.i2s.items()}

    def __len__(self) -> int:
        return len(self.vocabs)

    def parse(self, smiles: str, return_atom_idx: bool = False):
        """SMILES -> [<sos>, tokens..., <eos>] ids; unknown tokens map to
        <mask> (id 3), matching the reference (dataset.py:78-80)."""
        ids: List[int] = []
        atom_idx: List[int] = []
        for i, tok in enumerate(("<sos>", *PATTERN.findall(smiles), "<eos>")):
            ids.append(self.s2i.get(tok, self.MASK))
            if return_atom_idx and ATOM_PATTERN.fullmatch(tok) is not None:
                atom_idx.append(i)
        if return_atom_idx:
            return ids, atom_idx
        return ids

    def get_text(self, predictions: Sequence[Sequence[int]]) -> List[str]:
        """Decode id sequences, stopping at <eos> (dataset.py:102-116)."""
        out = []
        for p in predictions:
            chars = []
            for i in p:
                tok = self.i2s[int(i)]
                if tok == "<eos>":
                    break
                chars.append(tok)
            out.append("".join(chars))
        return out

    def to_list(self) -> List[str]:
        """Serializable vocabulary (replaces the reference's tokenizer
        pickles, train_chembl33_baseline.py:457-458)."""
        return list(self.vocabs)

    @classmethod
    def from_list(cls, vocabs: Sequence[str]) -> "Tokenizer":
        t = cls([])
        t.vocabs = list(vocabs)
        t.i2s = dict(enumerate(t.vocabs))
        t.s2i = {s: i for i, s in t.i2s.items()}
        return t


_BOND_ORDERS = {"-": 1, "/": 1, "\\": 1, ":": 1, "=": 2, "#": 3}


def _atom_bond_budget(s: str) -> int:
    """Bonds an atom token may form per ``chem.mol``'s valence checker
    (``check_valence``: bond-order sum + explicit H <= max default
    valence adjusted for charge), or -1 if ``s`` is not an atom token.

    Mirrors the checker exactly so valence-constrained decoding masks
    only continuations the validity metric itself would reject: charge
    adds to the budget for N/P and subtracts |charge| otherwise; an
    explicit bracket H count is pre-spent; elements outside
    DEFAULT_VALENCES pass the checker unconditionally (budget 8).
    Aromatic bonds are charged at their *written* order (1), which the
    kekulizer can only raise — so this budget never over-masks.
    """
    from cmdgen_tpu_torch.chem.mol import DEFAULT_VALENCES

    if ATOM_PATTERN.fullmatch(s) is None:
        return -1
    if s.startswith("["):
        body = s[1:-1]
        m = re.match(r"\d*([A-Za-z][a-z]?|\*)", body)
        if m is None:
            return 8
        sym = m.group(1)
        rest = body[m.end():]
        hm = re.search(r"H(\d*)", rest)
        n_h = (int(hm.group(1)) if hm and hm.group(1) else (1 if hm else 0))
        cm = re.search(r"(\++|-+)(\d*)$", rest) or re.search(
            r"([+-])(\d+)", rest
        )
        charge = 0
        if cm:
            sign = 1 if cm.group(1)[0] == "+" else -1
            charge = sign * (int(cm.group(2)) if cm.group(2)
                             else len(cm.group(1)))
    else:
        sym, n_h, charge = s, 0, 0
    sym = sym.capitalize()  # aromatic lowercase forms share the table
    if sym not in DEFAULT_VALENCES:
        return 8
    adj = charge if sym in ("N", "P") else -abs(charge)
    return max(0, max(DEFAULT_VALENCES[sym]) + adj - n_h)


def syntax_tables(tok: "Tokenizer"):
    """Per-vocab-id syntax descriptors for constrained decoding.

    Returns an int32 ``[V, 6]`` array: column 0 is the parenthesis depth
    delta (+1 for "(", -1 for ")"), column 1 the ring-closure toggle bit
    (each distinct ring-label token — a single digit or "%dd" — gets its
    own bit; SMILES reuses labels by open/close toggling, which a XOR of
    this bit tracks exactly), column 2 flags <eos> with 1 and every
    OTHER special/reserved token (<sos>, <pad>, <mask>, <sep>, <unk>,
    <t_i> — all of which would appear literally in the decoded text and
    fail the parser) with 2. Bracket atoms (whose digits are inside the
    bracket token) have zero in columns 0-2. Column 4 is the atom bond
    budget (``_atom_bond_budget``; -1 for non-atom tokens) and column 5
    the bond-token order (1 for -//\\:, 2 for =, 3 for #; -1 for the
    disconnect dot; 0 otherwise) — consumed only when valence masking is
    enabled. Consumed by ``models.gcpg.generate``'s ``constraints=``
    argument; built once per tokenizer on the host.

    With >32 distinct ring labels the extras share the last bit (two
    shared-bit labels open at once would cancel); real vocabularies have
    ~10.
    """
    import numpy as np

    t = np.zeros((len(tok), 6), dtype=np.int32)
    ring_bits: dict = {}
    for i, s in tok.i2s.items():
        if s == "(":
            t[i, 0] = 1
        elif s == ")":
            t[i, 0] = -1
        elif (len(s) == 1 and s.isdigit()) or (
            s.startswith("%") and s[1:].isdigit()
        ):
            bit = ring_bits.setdefault(s, min(len(ring_bits), 31))
            t[i, 1] = np.int32(1) << np.int32(bit)
        elif s == "<eos>":
            t[i, 2] = 1
        elif s in SPECIAL_TOKENS:
            t[i, 2] = 2
        # column 3: tokens that cannot START a SMILES (structural glue —
        # branches, ring labels, bonds, dot, bare stereo marks)
        if s in ("(", ")", "=", "#", "-", "/", "\\", ":", ".", "@", "@@") \
                or t[i, 1] != 0:
            t[i, 3] = 1
        t[i, 4] = _atom_bond_budget(s)
        t[i, 5] = _BOND_ORDERS.get(s, 0) if s != "." else -1
    return t
