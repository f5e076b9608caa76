"""Minimal molecular graph engine: SMILES in/out, valence, rings, aromaticity.

This image ships no RDKit, so the framework carries its own small chemistry
core. It covers what the pipeline needs (reference usages in
GCPG/utils/dataset.py, smiles2ppgraph.py, match_eval.py and
DiffPhar/analysis/metrics.py):

- SMILES parsing (organic subset, brackets, charges, ring closures incl.
  %nn, branches, bond orders, aromatic lowercase; stereo tokens are parsed
  and discarded — the reference also trains on non-isomeric SMILES,
  dataset.py:201-208),
- implicit-hydrogen / valence model and molecule validity checking,
- ring perception (a cycle basis) and kekulization via perfect matching
  (a fail-first backtracking search),
- a canonical SMILES writer (iterative-refinement canonical ranks + DFS),
  self-consistent for uniqueness/novelty metrics (NOT guaranteed to equal
  RDKit's canonical form),
- random-order SMILES enumeration for input augmentation.

A copy of ``cmdgen_tpu/chem/mol.py`` (pure Python). Where the
kekulization search runs out of budget, the JAX package falls back to
networkx's blossom matching; this copy runs the same search without a
budget (``_perfect_matching_exact``), which reaches the same verdict.
"""
from __future__ import annotations

import dataclasses
import random as _random
import re
from typing import Dict, List, Optional, Tuple

# Standard atomic weights (CRC), enough elements for drug-like molecules.
ATOMIC_WEIGHTS = {
    "H": 1.008, "B": 10.81, "C": 12.011, "N": 14.007, "O": 15.999,
    "F": 18.998, "Na": 22.990, "Mg": 24.305, "Al": 26.982, "Si": 28.085,
    "P": 30.974, "S": 32.06, "Cl": 35.45, "K": 39.098, "Ca": 40.078,
    "Zn": 65.38, "Se": 78.971, "Br": 79.904, "I": 126.904, "Fe": 55.845,
    "Cu": 63.546, "Mn": 54.938, "As": 74.922, "Li": 6.94, "Sn": 118.71,
}

# Default valences for the SMILES implicit-H model (Daylight rules).
DEFAULT_VALENCES = {
    "B": (3,), "C": (4,), "N": (3, 5), "O": (2,), "P": (3, 5),
    "S": (2, 4, 6), "F": (1,), "Cl": (1,), "Br": (1,), "I": (1,),
}

ORGANIC_SUBSET = {"B", "C", "N", "O", "P", "S", "F", "Cl", "Br", "I"}
AROMATIC_OK = {"B", "C", "N", "O", "P", "S", "Se", "As"}


@dataclasses.dataclass
class Atom:
    symbol: str
    charge: int = 0
    aromatic: bool = False
    explicit_h: Optional[int] = None  # None => implicit per valence model
    isotope: int = 0
    idx: int = -1
    # Tetrahedral chirality, stored order-independently: 0 means '@'
    # (counterclockwise) with the 4 neighbors listed in ascending index
    # order (implicit H = -1, lone pair / phantom = -2). None = achiral.
    chirality: Optional[int] = None


@dataclasses.dataclass
class Bond:
    a1: int
    a2: int
    order: int = 1          # 1, 2, 3 (kekulized); aromatic flagged separately
    aromatic: bool = False
    # Raw directional symbol ('/' or '\\') as written in a1->a2 orientation
    # (single bonds only; parse artifact used to derive double-bond stereo).
    direction: Optional[str] = None
    # Double-bond stereo, order-independent: (ref neighbor of a1,
    # ref neighbor of a2, True if the two refs are cis / same side).
    stereo: Optional[Tuple[int, int, bool]] = None

    def other(self, i: int) -> int:
        return self.a2 if i == self.a1 else self.a1


def _perm_parity(a: List, b: List) -> int:
    """Parity (0/1) of the permutation mapping list a onto list b
    (same distinct elements)."""
    idx = {v: i for i, v in enumerate(b)}
    perm = [idx[v] for v in a]
    seen = [False] * len(perm)
    parity = 0
    for i in range(len(perm)):
        if seen[i]:
            continue
        j, clen = i, 0
        while not seen[j]:
            seen[j] = True
            j = perm[j]
            clen += 1
        parity ^= (clen - 1) & 1
    return parity


def _perfect_matching(
    need: set, adj: Dict[int, List[int]], budget: int = 20000
):
    """Perfect matching on a tiny general graph by fail-first backtracking.

    Picks the minimum-remaining-degree unmatched node each step, so chains
    and isolated rings resolve with zero backtracks; fused polycyclics
    backtrack a handful of times. Aromatic kekulization subgraphs are
    bounded (max degree 3, typically < 30 nodes), where this beats the
    general blossom algorithm by ~30x and avoids networkx's per-call
    decorator overhead in the canonical_smiles hot path.

    Returns a list of (i, j) pairs if a perfect matching exists, an empty
    tuple if provably none exists, or None if the node-expansion budget is
    exhausted (caller falls back to :func:`_perfect_matching_exact`).
    """
    if len(need) % 2:
        return ()
    unmatched = set(need)
    pairs: List[Tuple[int, int]] = []
    steps = 0

    def bt() -> Optional[bool]:
        nonlocal steps
        if not unmatched:
            return True
        steps += 1
        if steps > budget:
            return None
        u = min(
            unmatched,
            key=lambda i: (sum(1 for v in adj[i] if v in unmatched), i),
        )
        cands = [v for v in adj[u] if v in unmatched]
        if not cands:
            return False
        unmatched.discard(u)
        for v in cands:
            unmatched.discard(v)
            pairs.append((u, v))
            r = bt()
            if r:
                return True
            pairs.pop()
            unmatched.add(v)
            if r is None:
                break
        unmatched.add(u)
        return None if steps > budget else False

    r = bt()
    if r is None:
        return None
    return pairs if r else ()


def _perfect_matching_exact(need: set, adj: Dict[int, List[int]]):
    """:func:`_perfect_matching`'s search without a budget: the same
    fail-first order, so the same matching where that one finds one, but
    each step first refuses a remainder with a connected component of odd
    size, which no perfect matching covers (so a system with no matching
    is refuted without walking every branch). Returns the pairs, or an
    empty tuple if none exists."""
    if len(need) % 2:
        return ()
    unmatched = set(need)
    pairs: List[Tuple[int, int]] = []

    def odd_component() -> bool:
        left = set(unmatched)
        while left:
            stack = [left.pop()]
            size = 0
            while stack:
                u = stack.pop()
                size += 1
                for v in adj[u]:
                    if v in left:
                        left.discard(v)
                        stack.append(v)
            if size % 2:
                return True
        return False

    def bt() -> bool:
        if not unmatched:
            return True
        if odd_component():
            return False
        u = min(
            unmatched,
            key=lambda i: (sum(1 for v in adj[i] if v in unmatched), i),
        )
        cands = [v for v in adj[u] if v in unmatched]
        unmatched.discard(u)
        for v in cands:
            unmatched.discard(v)
            pairs.append((u, v))
            if bt():
                return True
            pairs.pop()
            unmatched.add(v)
        unmatched.add(u)
        return False

    return pairs if bt() else ()


class Mol:
    def __init__(self):
        self.atoms: List[Atom] = []
        self.bonds: List[Bond] = []
        self._nbrs: Optional[List[List[Tuple[int, int]]]] = None  # (atom, bond)
        self._rings: Optional[List[List[int]]] = None

    # ----------------------------------------------------------- structure

    def add_atom(self, atom: Atom) -> int:
        atom.idx = len(self.atoms)
        self.atoms.append(atom)
        self._nbrs = None
        self._rings = None
        return atom.idx

    def add_bond(self, a1: int, a2: int, order: int = 1, aromatic: bool = False):
        if a1 == a2:
            raise ValueError("self bond")
        for b in self.bonds:
            if {b.a1, b.a2} == {a1, a2}:
                raise ValueError("duplicate bond")
        self.bonds.append(Bond(a1, a2, order, aromatic))
        self._nbrs = None
        self._rings = None

    @property
    def n_atoms(self) -> int:
        return len(self.atoms)

    def neighbors(self, i: int) -> List[Tuple[int, int]]:
        """[(neighbor atom idx, bond idx)] of atom i."""
        if self._nbrs is None:
            self._nbrs = [[] for _ in self.atoms]
            for bi, b in enumerate(self.bonds):
                self._nbrs[b.a1].append((b.a2, bi))
                self._nbrs[b.a2].append((b.a1, bi))
        return self._nbrs[i]

    def bond_between(self, a1: int, a2: int) -> Optional[Bond]:
        for n, bi in self.neighbors(a1):
            if n == a2:
                return self.bonds[bi]
        return None

    # ------------------------------------------------------------- valence

    def bond_order_sum(self, i: int) -> int:
        """Sum of bond orders. NOTE: aromatic bonds count their *kekulized*
        order; call kekulize() first (mol_from_smiles does)."""
        return sum(self.bonds[bi].order for _, bi in self.neighbors(i))

    def implicit_h(self, i: int) -> int:
        a = self.atoms[i]
        if a.explicit_h is not None:
            return a.explicit_h
        if a.symbol not in DEFAULT_VALENCES:
            return 0
        bos = self.bond_order_sum(i)
        adj = a.charge if a.symbol in ("N", "P") else -abs(a.charge)
        for v in DEFAULT_VALENCES[a.symbol]:
            target = v + adj
            if bos <= target:
                return target - bos
        return 0

    def total_h(self, i: int) -> int:
        return self.implicit_h(i)

    def degree(self, i: int) -> int:
        return len(self.neighbors(i))

    def heavy_neighbors(self, i: int) -> List[int]:
        return [n for n, _ in self.neighbors(i)]

    def check_valence(self) -> bool:
        """Each atom's bond order sum + H must not exceed its max valence
        (adjusted for charge). Unknown elements pass (like bracket atoms)."""
        for i, a in enumerate(self.atoms):
            if a.symbol not in DEFAULT_VALENCES:
                continue
            bos = self.bond_order_sum(i)
            h = a.explicit_h if a.explicit_h is not None else self.implicit_h(i)
            adj = a.charge if a.symbol in ("N", "P") else -abs(a.charge)
            max_v = max(DEFAULT_VALENCES[a.symbol]) + adj
            if bos + h > max_v:
                return False
        return True

    # --------------------------------------------------------------- rings

    def rings(self) -> List[List[int]]:
        """Smallest set of smallest rings (cached).

        Custom SSSR: the shortest cycle through each ring bond (BFS with
        that bond removed), then a greedy GF(2)-independent selection of
        the cyclomatic-number smallest cycles. ~50× faster than the
        networkx minimum_cycle_basis this replaced and equivalent on
        drug-like ring systems.
        """
        if self._rings is not None:
            return [list(r) for r in self._rings]
        n = self.n_atoms
        n_edges = len(self.bonds)
        # connected components (iterative DFS)
        seen = [False] * n
        n_comp = 0
        for s in range(n):
            if seen[s]:
                continue
            n_comp += 1
            stack = [s]
            seen[s] = True
            while stack:
                cur = stack.pop()
                for nb, _ in self.neighbors(cur):
                    if not seen[nb]:
                        seen[nb] = True
                        stack.append(nb)
        cyclomatic = n_edges - n + n_comp
        if cyclomatic <= 0:
            self._rings = []
            return []

        ring_flags = self.ring_bond_flags()
        candidates: List[Tuple[frozenset, List[int], int]] = []
        seen_cycles = set()
        for bi, b in enumerate(self.bonds):
            if not ring_flags[bi]:
                continue
            # shortest path b.a1 -> b.a2 avoiding bond bi
            parent = {b.a1: None}
            queue = [b.a1]
            found = False
            while queue and not found:
                nxt = []
                for cur in queue:
                    for nb, bj in self.neighbors(cur):
                        if bj == bi or nb in parent:
                            continue
                        parent[nb] = cur
                        if nb == b.a2:
                            found = True
                            break
                        nxt.append(nb)
                    if found:
                        break
                queue = nxt
            if not found:
                continue
            path = [b.a2]
            while parent[path[-1]] is not None:
                path.append(parent[path[-1]])
            key = frozenset(path)
            if key in seen_cycles:
                continue
            seen_cycles.add(key)
            # edge bitmask of the cycle for GF(2) independence
            emask = 1 << bi
            for k in range(len(path) - 1):
                for nb, bj in self.neighbors(path[k]):
                    if nb == path[k + 1]:
                        emask |= 1 << bj
                        break
            candidates.append((key, path, emask))
        candidates.sort(key=lambda c: len(c[1]))
        basis: List[List[int]] = []
        pivots: dict = {}  # leading bit -> reduced vector
        for _, path, emask in candidates:
            v = emask
            while v:
                lb = v.bit_length() - 1
                if lb not in pivots:
                    pivots[lb] = v
                    basis.append(path)
                    break
                v ^= pivots[lb]
            if len(basis) == cyclomatic:
                break
        self._rings = basis
        return [list(r) for r in basis]

    def ring_membership(self) -> List[bool]:
        in_ring = [False] * self.n_atoms
        for ring in self.rings():
            for i in ring:
                in_ring[i] = True
        return in_ring

    def ring_bond_flags(self) -> List[bool]:
        """Whether each bond is in a ring (iterative Tarjan bridge finding;
        a bond is in a ring iff it is not a bridge)."""
        n = self.n_atoms
        disc = [-1] * n
        low = [0] * n
        is_bridge = [False] * len(self.bonds)
        timer = 0
        for root in range(n):
            if disc[root] != -1:
                continue
            # stack entries: (node, parent_bond, neighbor iterator index)
            stack = [(root, -1, 0)]
            disc[root] = low[root] = timer
            timer += 1
            while stack:
                cur, pbond, idx = stack[-1]
                nbrs = self.neighbors(cur)
                if idx < len(nbrs):
                    stack[-1] = (cur, pbond, idx + 1)
                    nb, bi = nbrs[idx]
                    if bi == pbond:
                        continue
                    if disc[nb] == -1:
                        disc[nb] = low[nb] = timer
                        timer += 1
                        stack.append((nb, bi, 0))
                    else:
                        low[cur] = min(low[cur], disc[nb])
                else:
                    stack.pop()
                    if stack:
                        parent = stack[-1][0]
                        low[parent] = min(low[parent], low[cur])
                        if low[cur] > disc[parent]:
                            is_bridge[pbond] = True
        return [not br for br in is_bridge]

    def aromatic_rings(self) -> List[List[int]]:
        return [
            r for r in self.rings()
            if all(self.atoms[i].aromatic for i in r)
        ]

    # --------------------------------------------------------- kekulization

    def kekulize(self) -> bool:
        """Assign alternating single/double bonds to the aromatic system.

        Each aromatic atom that still has free valence needs exactly one
        double bond inside the aromatic subgraph; that is a perfect matching
        problem on those atoms, solved with a fail-first backtracking search
        (_perfect_matching — aromatic subgraphs are tiny and max-degree-3,
        where backtracking beats the general blossom solver by ~30x and
        removes networkx from the canonical_smiles hot path; the same
        search without a budget, pruned by component parity, is the
        budget-exhaustion fallback).
        Returns False if no valid assignment exists (invalid aromaticity).
        """
        arom_atoms = [i for i, a in enumerate(self.atoms) if a.aromatic]
        if not arom_atoms:
            return True

        def extra_pi(i: int) -> int:
            """Order beyond sigma already fixed by non-aromatic bonds
            (e.g. the exocyclic C=O of aromatic carbonyls)."""
            return sum(
                self.bonds[bi].order - 1
                for _, bi in self.neighbors(i)
                if not self.bonds[bi].aromatic
            )

        def needs_double(i: int) -> bool:
            a = self.atoms[i]
            sigma = self.degree(i)
            pi = extra_pi(i)
            h = a.explicit_h if a.explicit_h is not None else None
            if a.symbol == "C":
                if a.charge != 0:
                    return False
                nh = h if h is not None else max(0, 3 - sigma - pi)
                return sigma + nh + pi < 4
            if a.symbol == "N" or a.symbol == "P":
                if a.charge == 1:
                    nh = h if h is not None else 0
                    return sigma + nh + pi < 4
                if a.charge == -1:
                    return False
                # neutral aromatic N: pyridine-type (2 sigma bonds, no H)
                # gets a double bond; pyrrole-type (3 bonds or has H) not
                nh = h if h is not None else 0
                return sigma + nh + pi == 2
            if a.symbol in ("O", "S", "Se", "B"):
                return False
            return False

        need = {i for i in arom_atoms if needs_double(i)}
        adj: Dict[int, List[int]] = {i: [] for i in need}
        for b in self.bonds:
            if b.aromatic and b.a1 in need and b.a2 in need:
                adj[b.a1].append(b.a2)
                adj[b.a2].append(b.a1)
        matching = _perfect_matching(need, adj)
        if matching is None:
            # budget exhausted on a pathological fused system: the same
            # search without a budget, pruned by component parity
            matching = _perfect_matching_exact(need, adj)
        matched = {i for e in matching for i in e}
        if matched != need:
            return False
        pairs = {frozenset(e) for e in matching}
        for b in self.bonds:
            if b.aromatic:
                b.order = 2 if frozenset((b.a1, b.a2)) in pairs else 1

        # Hückel 4n+2 sanity check for *isolated* aromatic rings (fused
        # systems are exempt — per-ring counting is wrong there, cf. azulene)
        ring_count = [0] * self.n_atoms
        arings = self.aromatic_rings()
        for r in arings:
            for i in r:
                ring_count[i] += 1
        for r in arings:
            if any(ring_count[i] > 1 for i in r):
                continue  # fused
            pi_e = 0
            ring_set = set(r)
            for i in r:
                a = self.atoms[i]
                has_ring_double = any(
                    self.bonds[bi].aromatic and self.bonds[bi].order == 2
                    and nb in ring_set
                    for nb, bi in self.neighbors(i)
                )
                if has_ring_double:
                    pi_e += 1
                elif a.symbol in ("N", "O", "S", "Se", "P") or a.charge < 0:
                    pi_e += 2  # lone-pair donor (pyrrole/furan/thiophene type)
                # else: sp3-like / exocyclic-double atom contributes 0
            if pi_e % 4 != 2:
                return False
        return True

    def molecular_weight(self) -> float:
        w = 0.0
        for i, a in enumerate(self.atoms):
            w += ATOMIC_WEIGHTS.get(a.symbol, 0.0)
            w += ATOMIC_WEIGHTS["H"] * self.total_h(i)
        return w


# ------------------------------------------------------------------ parser

_BRACKET_RE = re.compile(
    r"\[(?P<iso>\d+)?(?P<sym>[A-Z][a-z]?|[a-z]{1,2}|\*)(?P<chiral>@{1,2}(?:TH\d|AL\d|SP\d|TB\d+|OH\d+)?)?"
    r"(?P<h>H\d*)?(?P<chg>[+-]+\d*|\+\d+|-\d+)?(?::(?P<map>\d+))?\]"
)

_BOND_ORDERS = {"-": 1, "=": 2, "#": 3, ":": 1, "/": 1, "\\": 1, "~": 1}


class SmilesError(ValueError):
    pass


def parse_smiles(smiles: str) -> Mol:
    """Parse SMILES into a Mol (raises SmilesError on malformed input).

    Stereochemistry: tetrahedral '@'/'@@' tags and '/'\\'' directional
    bonds are converted into the order-independent Atom.chirality /
    Bond.stereo representations (reference behavior: RDKit keeps isomeric
    SMILES through canonicalization, GCPG/utils/dataset.py:201-208)."""
    mol = Mol()
    prev: List[Optional[int]] = [None]  # stack of attachment atoms
    pending_bond: Optional[str] = None
    ring_map: Dict[int, Tuple[int, Optional[str]]] = {}
    nbr_order: Dict[int, List] = {}   # written neighbor order per atom
    chiral_tags: Dict[int, int] = {}  # atom idx -> 0 ('@') / 1 ('@@')
    i = 0
    n = len(smiles)
    if not smiles:
        raise SmilesError("empty")

    def finish_atom(atom: Atom, chiral_tag: Optional[int] = None):
        idx = mol.add_atom(atom)
        nonlocal pending_bond
        nbr_order[idx] = []
        if prev[-1] is not None:
            a, b = prev[-1], idx
            order, aromatic = _resolve_bond(mol, a, b, pending_bond)
            try:
                mol.add_bond(a, b, order, aromatic)
            except ValueError as e:
                raise SmilesError(str(e))
            if pending_bond in ("/", "\\"):
                mol.bonds[-1].direction = pending_bond
            nbr_order[a].append(idx)
            nbr_order[idx].append(a)
        if chiral_tag is not None:
            chiral_tags[idx] = chiral_tag
            if (atom.explicit_h or 0) == 1:
                # the bracket H occupies the slot right after the preceding
                # atom (or first, when the chiral atom opens the SMILES)
                nbr_order[idx].append(-1)
        pending_bond = None
        prev[-1] = idx
        return idx

    while i < n:
        c = smiles[i]
        if c == "[":
            j = smiles.find("]", i)
            if j < 0:
                raise SmilesError("unclosed bracket")
            m = _BRACKET_RE.fullmatch(smiles[i : j + 1])
            if m is None:
                raise SmilesError(f"bad bracket atom {smiles[i:j+1]}")
            sym = m.group("sym")
            aromatic = sym[0].islower()
            sym_t = sym.capitalize() if sym != "*" else "*"
            if aromatic and sym_t not in AROMATIC_OK:
                raise SmilesError(f"{sym} cannot be aromatic")
            hgrp = m.group("h")
            nh = 0
            if hgrp:
                nh = int(hgrp[1:]) if len(hgrp) > 1 else 1
            chg = 0
            cgrp = m.group("chg")
            if cgrp:
                if cgrp in ("+", "-"):
                    chg = 1 if cgrp == "+" else -1
                elif set(cgrp) <= {"+"}:
                    chg = len(cgrp)
                elif set(cgrp) <= {"-"}:
                    chg = -len(cgrp)
                else:
                    chg = int(cgrp)
            iso = int(m.group("iso")) if m.group("iso") else 0
            cgrp_ch = m.group("chiral")
            if cgrp_ch in ("@", "@TH1"):
                chiral_tag = 0
            elif cgrp_ch in ("@@", "@TH2"):
                chiral_tag = 1
            else:
                chiral_tag = None  # exotic (@AL/@SP/...) or absent: dropped
            finish_atom(Atom(sym_t, chg, aromatic, nh, iso), chiral_tag)
            i = j + 1
        elif c.isalpha():
            if smiles[i : i + 2] in ("Cl", "Br"):
                sym, i = smiles[i : i + 2], i + 2
                finish_atom(Atom(sym))
            elif c in "BCNOPSFI":
                finish_atom(Atom(c))
                i += 1
            elif c in "bcnops":
                finish_atom(Atom(c.upper(), aromatic=True))
                i += 1
            else:
                raise SmilesError(f"unknown atom {c!r}")
        elif c in _BOND_ORDERS:
            pending_bond = c
            i += 1
        elif c == "(":
            if prev[-1] is None:
                raise SmilesError("branch with no atom")
            prev.append(prev[-1])
            i += 1
        elif c == ")":
            if len(prev) < 2:
                raise SmilesError("unbalanced )")
            prev.pop()
            i += 1
        elif c.isdigit() or c == "%":
            if c == "%":
                if i + 2 >= n or not smiles[i + 1 : i + 3].isdigit():
                    raise SmilesError("bad %ring")
                num, i = int(smiles[i + 1 : i + 3]), i + 3
            else:
                num, i = int(c), i + 1
            if prev[-1] is None:
                raise SmilesError("ring digit before atom")
            if num in ring_map:
                a, open_bond = ring_map.pop(num)
                b = prev[-1]
                sym = pending_bond or open_bond
                order, aromatic = _resolve_bond(mol, a, b, sym)
                try:
                    mol.add_bond(a, b, order, aromatic)
                except ValueError as e:
                    raise SmilesError(str(e))
                if sym in ("/", "\\"):
                    # written at the closer => orientation closer->opener;
                    # Bond stores a1=opener, so flip closer-written symbols
                    if pending_bond in ("/", "\\"):
                        mol.bonds[-1].direction = (
                            "\\" if pending_bond == "/" else "/"
                        )
                    else:
                        mol.bonds[-1].direction = open_bond
                # fill the opener's placeholder slot; closer appends now
                slots = nbr_order[a]
                slots[slots.index(("r", num))] = b
                nbr_order[b].append(a)
                pending_bond = None
            else:
                ring_map[num] = (prev[-1], pending_bond)
                nbr_order[prev[-1]].append(("r", num))
                pending_bond = None
        elif c == ".":
            prev[-1] = None
            pending_bond = None
            i += 1
        else:
            raise SmilesError(f"unexpected char {c!r}")
    if ring_map:
        raise SmilesError(f"unmatched ring closures {sorted(ring_map)}")
    if len(prev) != 1:
        raise SmilesError("unbalanced (")
    _finalize_tetrahedral(mol, chiral_tags, nbr_order)
    _finalize_bond_stereo(mol)
    return mol


def _finalize_tetrahedral(mol: Mol, chiral_tags: Dict[int, int],
                          nbr_order: Dict[int, List]):
    """Convert written-order '@'/'@@' tags into the order-independent
    parity stored on Atom.chirality (parity w.r.t. ascending-index
    neighbors). 3-coordinate chiral centers get a phantom (-2) in the last
    slot (lone pair / trailing implicit H, Daylight convention)."""
    for i, tag in chiral_tags.items():
        written = list(nbr_order.get(i, []))
        if any(isinstance(v, tuple) for v in written):
            continue  # unresolved ring slot — malformed, drop
        if len(written) == 3:
            written = written + [-2]
        if len(written) != 4 or len(set(written)) != 4:
            continue  # chirality undefined at this center — drop
        mol.atoms[i].chirality = tag ^ _perm_parity(written, sorted(written))


def _finalize_bond_stereo(mol: Mol):
    """Derive double-bond cis/trans from '/'\\'' directional single bonds
    (convention: 'p/q' puts p at the lower end)."""

    def side_ref(bond: Bond, a: int):
        for nb, bi in mol.neighbors(a):
            bb = mol.bonds[bi]
            if bb is bond or bb.direction is None:
                continue
            lower = bb.a1 if bb.direction == "/" else bb.a2
            return nb, (-1 if lower == nb else 1)
        return None, 0

    for b in mol.bonds:
        if b.order != 2 or b.aromatic:
            continue
        x, sx = side_ref(b, b.a1)
        y, sy = side_ref(b, b.a2)
        if x is not None and y is not None:
            b.stereo = (x, y, sx == sy)


def _resolve_bond(mol: Mol, a: int, b: int, sym: Optional[str]):
    if sym is None:
        if mol.atoms[a].aromatic and mol.atoms[b].aromatic:
            return 1, True
        return 1, False
    if sym == ":":
        return 1, True
    return _BOND_ORDERS[sym], False


def mol_from_smiles(smiles: str) -> Optional[Mol]:
    """Parse + sanitize; returns None for invalid molecules (the RDKit
    MolFromSmiles contract the reference code relies on everywhere)."""
    try:
        mol = parse_smiles(smiles)
    except (SmilesError, KeyError, IndexError):
        return None
    if mol.n_atoms == 0:
        return None
    # aromaticity must admit a kekulé structure (assigns real bond orders so
    # the valence model below is exact); every aromatic atom must be in a ring
    arom = [i for i, a in enumerate(mol.atoms) if a.aromatic]
    if arom:
        in_ring = mol.ring_membership()
        if not all(in_ring[i] for i in arom):
            return None
        if not mol.kekulize():
            return None
    if not mol.check_valence():
        return None
    return mol


# ------------------------------------------------------------------ writer

def _invariants(mol: Mol) -> List[Tuple]:
    """Deterministic per-atom invariant keys. (Must NOT use Python hash():
    string hashing is salted per process, which would make canonical SMILES
    unstable across runs.)"""
    inv = []
    in_ring = mol.ring_membership()
    for i, a in enumerate(mol.atoms):
        inv.append(
            (
                a.symbol,
                a.charge,
                a.aromatic,
                mol.degree(i),
                mol.total_h(i),
                in_ring[i],
            )
        )
    return inv


def canonical_ranks_ex(mol: Mol, first_choice: Optional[int] = None):
    """Iterative neighborhood refinement (Morgan-style) with deterministic
    tie-breaking, yielding a canonical atom order.

    Returns (ranks, first_tie_class): the members of the first tied class
    encountered (empty when refinement fully discriminates). Passing one of
    them as ``first_choice`` promotes that atom at the first tie instead of
    the min-index default — used by the stereo-aware canonical writer to
    enumerate automorphic writings."""
    n = mol.n_atoms
    inv = _invariants(mol)

    def refine(ranks: List[int]) -> List[int]:
        for _ in range(n):
            keys = []
            for i in range(n):
                nb = sorted(ranks[j] for j, _ in mol.neighbors(i))
                keys.append((ranks[i], tuple(nb)))
            order = sorted(range(n), key=lambda i: keys[i])
            new_ranks = [0] * n
            r = 0
            for k, i in enumerate(order):
                if k > 0 and keys[i] != keys[order[k - 1]]:
                    r = k
                new_ranks[i] = r
            if new_ranks == ranks:
                break
            ranks = new_ranks
        return ranks

    # initial ranks from invariants
    order = sorted(range(n), key=lambda i: inv[i])
    ranks = [0] * n
    r = 0
    for k, i in enumerate(order):
        if k > 0 and inv[i] != inv[order[k - 1]]:
            r = k
        ranks[i] = r
    ranks = refine(ranks)
    # break remaining ties deterministically
    first_tie_class: List[int] = []
    first = True
    while len(set(ranks)) < n:
        counts: Dict[int, List[int]] = {}
        for i, rk in enumerate(ranks):
            counts.setdefault(rk, []).append(i)
        tie = min((rk for rk, idxs in counts.items() if len(idxs) > 1))
        if first:
            first_tie_class = list(counts[tie])
            chosen = (
                first_choice
                if first_choice in counts[tie]
                else min(counts[tie])
            )
            first = False
        else:
            chosen = min(counts[tie])
        ranks = [rk * 2 for rk in ranks]
        ranks[chosen] -= 1
        ranks = refine(ranks)
    return ranks, first_tie_class


def canonical_ranks(mol: Mol) -> List[int]:
    return canonical_ranks_ex(mol)[0]


def write_smiles(mol: Mol, canonical: bool = True,
                 rng: Optional[_random.Random] = None,
                 _ranks: Optional[List[int]] = None) -> str:
    """DFS SMILES writer. canonical=True uses canonical ranks for root and
    neighbor ordering; otherwise a random order (for data augmentation,
    replacing MolToSmiles(doRandom=True), dataset.py:204).

    Stereo + symmetry: automorphic tie-break choices write identical strings
    for achiral molecules but can flip stereo tags (e.g. the two ring paths
    of a 1,4-disubstituted cyclohexane). When the molecule carries stereo
    and refinement left a tie, the writer enumerates the first tie class and
    returns the lexicographically smallest string, so every labeling of the
    same stereoisomer canonicalizes identically (single-symmetry-axis case;
    nested independent symmetries fall back to min-index)."""
    n = mol.n_atoms
    if n == 0:
        return ""
    if canonical:
        if _ranks is not None:
            ranks = _ranks
        else:
            ranks, tie_class = canonical_ranks_ex(mol)
            has_stereo = any(a.chirality is not None for a in mol.atoms) or any(
                b.stereo is not None for b in mol.bonds
            )
            if has_stereo and tie_class and len(tie_class) <= 8:
                return min(
                    write_smiles(
                        mol, True, _ranks=canonical_ranks_ex(mol, c)[0]
                    )
                    for c in tie_class
                )
        key = lambda i: ranks[i]
        roots = sorted(range(n), key=key)
    else:
        rng = rng or _random.Random()
        perm = list(range(n))
        rng.shuffle(perm)
        key = lambda i: perm[i]
        roots = sorted(range(n), key=key)

    visited = [False] * n
    ring_bonds: Dict[frozenset, int] = {}
    ring_counter = [0]

    # find ring-closure bonds via DFS spanning tree
    tree_edges = set()

    def mark(root):
        stack = [root]
        seen = {root}
        while stack:
            cur = stack.pop()
            for nb, bi in sorted(mol.neighbors(cur), key=lambda t: key(t[0])):
                if nb not in seen:
                    seen.add(nb)
                    tree_edges.add(frozenset((cur, nb)))
                    stack.append(nb)
        return seen

    comps = []
    seen_all = set()
    for root in roots:
        if root not in seen_all:
            comp_seen = mark(root)
            seen_all |= comp_seen
            comps.append(root)

    ring_digit: Dict[frozenset, int] = {}
    free_digits = list(range(1, 100))

    # --- directional-slash assignment for double-bond stereo ------------
    # slash_lower[bond idx] = the atom at the lower end of that single bond.
    # Reference substituents and orientation are chosen by the writer's own
    # atom key (canonical ranks / random perm), NOT the parse-time stored
    # refs — the stored (x, y) pair depends on the input labeling and would
    # make canonical output unstable across writings of the same isomer.
    slash_lower: Dict[int, int] = {}

    def _bond_idx(a: int, b: int) -> Optional[int]:
        for nb, bi in mol.neighbors(a):
            if nb == b:
                return bi
        return None

    def _side_subs(a: int, other: int) -> List[int]:
        """Tree-edge single-bond substituents of a (excluding the double-bond
        partner), in key order; ring-closure refs are skipped (symbol
        placement at digits is ambiguous across parsers)."""
        return sorted(
            (
                nb
                for nb, bi in mol.neighbors(a)
                if nb != other
                and mol.bonds[bi].order == 1
                and not mol.bonds[bi].aromatic
                and frozenset((a, nb)) in tree_edges
            ),
            key=key,
        )

    stereo_dbl = sorted(
        (
            bi
            for bi, b in enumerate(mol.bonds)
            if b.stereo is not None and b.order == 2
        ),
        key=lambda bi: min(key(mol.bonds[bi].a1), key(mol.bonds[bi].a2)),
    )
    for dbi in stereo_dbl:
        db = mol.bonds[dbi]
        p, q = sorted((db.a1, db.a2), key=key)
        x, y, cis = db.stereo
        x_p, x_q = (x, y) if p == db.a1 else (y, x)
        subs_p = _side_subs(p, q)
        subs_q = _side_subs(q, p)
        if not subs_p or not subs_q:
            continue
        r_p, r_q = subs_p[0], subs_q[0]
        # re-express the stored cis flag for the chosen reference pair
        # (swapping to the other substituent on a trigonal carbon negates it)
        c = cis
        if r_p != x_p:
            c = not c
        if r_q != x_q:
            c = not c
        bx = _bond_idx(r_p, p)
        by = _bond_idx(r_q, q)
        if bx in slash_lower:
            sx = -1 if slash_lower[bx] == r_p else 1
        else:
            slash_lower[bx] = r_p
            sx = -1
        sy = sx if c else -sx
        want_lower = r_q if sy == -1 else q
        if by not in slash_lower:
            slash_lower[by] = want_lower
        # else: conjugated conflict — keep the earlier assignment

    def bond_symbol(b: Bond, from_atom: int, bi: Optional[int] = None) -> str:
        if b.aromatic:
            return ""
        if b.order == 2:
            return "="
        if b.order == 3:
            return "#"
        if bi is not None and bi in slash_lower:
            return "/" if slash_lower[bi] == from_atom else "\\"
        a1, a2 = mol.atoms[b.a1], mol.atoms[b.a2]
        if a1.aromatic and a2.aromatic and b.order == 1:
            return "-"  # explicit single between aromatic atoms
        return ""

    def atom_token(i: int, chiral_txt: str = "") -> str:
        a = mol.atoms[i]
        sym = a.symbol.lower() if a.aromatic else a.symbol
        needs_bracket = (
            a.symbol not in ORGANIC_SUBSET
            or a.charge != 0
            or a.isotope != 0
            or bool(chiral_txt)
            # aromatic heteroatoms carrying H must stay bracketed ([nH]):
            # bare 'n' means the pyridine-type zero-H reading on re-parse
            or (a.aromatic and a.symbol != "C" and (a.explicit_h or 0) > 0)
        )
        if a.explicit_h is not None:
            # compare with what the implicit model would give if unbracketed
            save = a.explicit_h
            a.explicit_h = None
            imp = mol.implicit_h(i)
            a.explicit_h = save
            needs_bracket = needs_bracket or (save != imp)
        if not needs_bracket:
            return sym
        h = a.explicit_h if a.explicit_h is not None else mol.implicit_h(i)
        htxt = "" if h == 0 else ("H" if h == 1 else f"H{h}")
        if a.charge == 0:
            ctxt = ""
        elif a.charge == 1:
            ctxt = "+"
        elif a.charge == -1:
            ctxt = "-"
        else:
            ctxt = f"{a.charge:+d}"
        iso = str(a.isotope) if a.isotope else ""
        return f"[{iso}{sym}{chiral_txt}{htxt}{ctxt}]"

    out: List[str] = []

    def dfs(i: int, parent_bond: Optional[int]):
        visited[i] = True
        nbrs = sorted(mol.neighbors(i), key=lambda t: key(t[0]))
        ring_nbrs = [
            (nb, bi)
            for nb, bi in nbrs
            if frozenset((i, nb)) not in tree_edges and bi != parent_bond
        ]
        children = [
            (nb, bi)
            for nb, bi in nbrs
            if frozenset((i, nb)) in tree_edges and not visited[nb]
        ]
        chiral_txt = ""
        a = mol.atoms[i]
        if a.chirality is not None:
            # output-order neighbor list: parent, bracket-H, ring digits,
            # children (mirrors the parse-side convention)
            l_out: List[int] = []
            if parent_bond is not None:
                l_out.append(mol.bonds[parent_bond].other(i))
            h = a.explicit_h if a.explicit_h is not None else mol.implicit_h(i)
            if h == 1:
                l_out.append(-1)
            l_out += [nb for nb, _ in ring_nbrs]
            l_out += [nb for nb, _ in children]
            if len(l_out) == 3:
                l_out.append(-2)
            if len(l_out) == 4 and len(set(l_out)) == 4:
                parity = a.chirality ^ _perm_parity(sorted(l_out), l_out)
                chiral_txt = "@" if parity == 0 else "@@"
        out.append(atom_token(i, chiral_txt))
        # ring closures at this atom
        for nb, bi in ring_nbrs:
            e = frozenset((i, nb))
            b = mol.bonds[bi]
            if e in ring_digit:
                d = ring_digit.pop(e)
                free_digits.insert(0, d)
                free_digits.sort()
                out.append(bond_symbol(b, i, bi) + _digit(d))
            else:
                d = free_digits.pop(0)
                ring_digit[e] = d
                out.append(bond_symbol(b, i, bi) + _digit(d))
        for k, (nb, bi) in enumerate(children):
            b = mol.bonds[bi]
            last = k == len(children) - 1
            if not last:
                out.append("(")
            out.append(bond_symbol(b, i, bi))
            dfs(nb, bi)
            if not last:
                out.append(")")

    first = True
    for root in comps:
        if not first:
            out.append(".")
        dfs(root, None)
        first = False
    return "".join(out)


def _digit(d: int) -> str:
    return str(d) if d < 10 else f"%{d:02d}"


def canonical_smiles(smiles: str) -> Optional[str]:
    """Canonicalize a SMILES string (None if invalid). Idempotent."""
    mol = mol_from_smiles(smiles)
    if mol is None:
        return None
    return write_smiles(mol, canonical=True)


def random_smiles(smiles: str, rng: Optional[_random.Random] = None) -> Optional[str]:
    mol = mol_from_smiles(smiles)
    if mol is None:
        return None
    return write_smiles(mol, canonical=False, rng=rng)
