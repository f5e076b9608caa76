"""Datasets: DiffPhar padded-batch loader + GCPG semi-supervised SMILES set.

DiffPharDataset mirrors ProcessedLigandPharPocketDataset
(DiffPhar/dataset.py:7-64): load the flat npz, split per complex by mask
changes, center each complex on the joint pharmacophore+pocket mean — but
batches come out as fixed-shape padded PointCloud pairs (static shapes keep
XLA from recompiling).

GCPGSmilesDataset mirrors SemiSmilesDataset (GCPG/utils/dataset.py:137-262):
canonical-or-random input/target SMILES, BART-style Poisson span-infilling
corruption, pharmacophore graph from the target SMILES, the
atom↔pharmacophore mapping matrix with -100 ignore fill, and the property
scalars.

A copy of ``cmdgen_tpu/data/dataset.py`` (numpy only).
"""
from __future__ import annotations

import random as _random
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from cmdgen_tpu_torch.chem.mol import canonical_smiles, random_smiles
from cmdgen_tpu_torch.chem.ppgraph import MAX_NUM_PP_GRAPHS, smiles_to_ppgraph
from cmdgen_tpu_torch.chem.tokenizer import Tokenizer


class DiffPharDataset:
    def __init__(self, npz_path, center: bool = True):
        with np.load(npz_path, allow_pickle=True) as f:
            data = {k: v for k, v in f.items()}
        self.names = data["names"]
        phar_sections = np.where(np.diff(data["phar_mask"]))[0] + 1
        pocket_sections = np.where(np.diff(data["pocket_mask"]))[0] + 1
        self.phar_coords = np.split(data["phar_coords"], phar_sections)
        self.phar_one_hot = np.split(data["phar_one_hot"], phar_sections)
        self.pocket_coords = np.split(data["pocket_c_alpha"], pocket_sections)
        self.pocket_one_hot = np.split(data["pocket_one_hot"], pocket_sections)
        if center:
            for i in range(len(self.phar_coords)):
                n = len(self.phar_coords[i]) + len(self.pocket_coords[i])
                mean = (
                    self.phar_coords[i].sum(0) + self.pocket_coords[i].sum(0)
                ) / n
                self.phar_coords[i] = self.phar_coords[i] - mean
                self.pocket_coords[i] = self.pocket_coords[i] - mean
        self.n_phar_max = max(len(x) for x in self.phar_coords)
        self.n_pocket_max = max(len(x) for x in self.pocket_coords)

    def __len__(self):
        return len(self.phar_coords)

    def sizes(self) -> Tuple[np.ndarray, np.ndarray]:
        return (
            np.array([len(x) for x in self.phar_coords]),
            np.array([len(x) for x in self.pocket_coords]),
        )

    def padded_batch(self, idx: Sequence[int],
                     n_phar_max: Optional[int] = None,
                     n_pocket_max: Optional[int] = None):
        """Indices -> dict of padded numpy arrays (feed to PointCloud)."""
        npm = n_phar_max or self.n_phar_max
        nqm = n_pocket_max or self.n_pocket_max
        b = len(idx)
        fp = self.phar_one_hot[0].shape[1]
        fq = self.pocket_one_hot[0].shape[1]
        out = {
            "phar_x": np.zeros((b, npm, 3), np.float32),
            "phar_h": np.zeros((b, npm, fp), np.float32),
            "phar_mask": np.zeros((b, npm), np.float32),
            "pocket_x": np.zeros((b, nqm, 3), np.float32),
            "pocket_h": np.zeros((b, nqm, fq), np.float32),
            "pocket_mask": np.zeros((b, nqm), np.float32),
        }
        for k, i in enumerate(idx):
            np_i = min(len(self.phar_coords[i]), npm)
            nq_i = min(len(self.pocket_coords[i]), nqm)
            out["phar_x"][k, :np_i] = self.phar_coords[i][:np_i]
            out["phar_h"][k, :np_i] = self.phar_one_hot[i][:np_i]
            out["phar_mask"][k, :np_i] = 1.0
            out["pocket_x"][k, :nq_i] = self.pocket_coords[i][:nq_i]
            out["pocket_h"][k, :nq_i] = self.pocket_one_hot[i][:nq_i]
            out["pocket_mask"][k, :nq_i] = 1.0
        return out

    def iter_batches(
        self, batch_size: int, rng: np.random.RandomState, shuffle=True,
        drop_last=True, bucket: Optional[int] = None,
    ) -> Iterator[dict]:
        """``bucket``: round each batch's pocket padding up to a multiple of
        this value instead of the global max — batches of small pockets then
        cost less compute, at a bounded number of XLA shape specializations
        (the padded-batch answer to ragged batching, SURVEY.md §7)."""
        order = np.arange(len(self))
        if shuffle:
            rng.shuffle(order)
        if bucket:
            sizes = np.array([len(x) for x in self.pocket_coords])
            order = order[np.argsort(sizes[order], kind="stable")]
        batches = [
            order[i : i + batch_size]
            for i in range(0, len(order), batch_size)
            if not (drop_last and i + batch_size > len(order))
        ]
        if bucket and shuffle:
            rng.shuffle(batches)
        for idx in batches:
            if bucket:
                nq = max(len(self.pocket_coords[i]) for i in idx)
                nq = min(-(-nq // bucket) * bucket, self.n_pocket_max)
                np_b = max(len(self.phar_coords[i]) for i in idx)
                np_b = min(-(-np_b // 4) * 4, self.n_phar_max)
                yield self.padded_batch(idx, n_phar_max=np_b, n_pocket_max=nq)
            else:
                yield self.padded_batch(idx)


def corrupt_tokens(
    token_seq: List[int], mask_token: int, rng,
    corrupt_percent: float = 0.1, poisson_lambda: float = 2.0,
) -> List[int]:
    """BART-style Poisson span infilling (GCPG/utils/dataset.py:98-121)."""
    seq = list(token_seq)
    l = len(seq)
    n = int(l * corrupt_percent)
    if n == 0 or l <= 2:
        return seq
    c = 0
    idx = sorted(rng.choice(range(1, l - 1), n), reverse=True)
    for i in idx:
        li = rng.poisson(poisson_lambda)
        while li < 1:
            li = rng.poisson(poisson_lambda)
        seq[i] = mask_token
        li -= 1
        p = i + 1
        cur_len = len(seq)
        while p < cur_len and li > 0:
            del seq[p]
            cur_len -= 1
            li -= 1
            c += 1
        if c >= n:
            break
    return seq


PROPERTY_KEYS = ["MW", "logP", "QED", "SAS", "HBA", "HBD",
                 "RotaNumBonds", "Score", "Smi"]


def consensus_style_graph(pp_h, pp_e, pp_mask, py_rng, np_rng):
    """Re-draw an exact training pp-graph the way decode-time hypotheses
    are built (chem/posp.points_to_graph): node sizes resampled from the
    type-conditional size prior (posp._format_type draws them independently
    of the actual feature) and pairwise distances jittered with the
    consensus-geometry error model (GMM cluster centers + the edis2sdis
    linear proxy are ~1 bond-unit noisy vs true bond-path distances).
    Types, mask, and the atom<->node mapping stay exact. Returns new
    (pp_h, pp_e); inputs are not mutated."""
    from cmdgen_tpu_torch.chem.posp import IDX2SIZE

    pp_h = pp_h.copy()
    pp_e = pp_e.copy()
    k = int(pp_mask.sum())
    for i in range(k):
        size = -1.0
        for t in range(7):
            if pp_h[i, t] > 0:
                sizes, probs = IDX2SIZE[t]
                size = max(size, float(
                    py_rng.choices(sizes, weights=probs, k=1)[0]))
        if size > 0:
            pp_h[i, 7] = size
    if k > 1:
        jit = np_rng.normal(0.0, 1.0, size=(k, k)).astype(np.float32)
        jit = np.triu(jit, 1)
        jit = jit + jit.T
        d = np.maximum(pp_e[:k, :k, 0] + jit, 0.5)
        np.fill_diagonal(d, 0.0)
        pp_e[:k, :k, 0] = d
    return pp_h, pp_e


class GCPGSmilesDataset:
    def __init__(
        self,
        smiles_list: Sequence[str],
        properties: Dict[str, Sequence[float]],
        tokenizer: Tokenizer,
        max_len: int = 128,
        use_random_input_smiles: bool = False,
        use_random_target_smiles: bool = False,
        corrupt: bool = True,
        seed: int = 0,
        consensus_noise: float = 0.0,
    ):
        self.smiles_list = list(smiles_list)
        self.properties = {
            k: list(properties.get(k, [0.0] * len(smiles_list)))
            for k in PROPERTY_KEYS
        }
        self.tokenizer = tokenizer
        self.max_len = max_len
        self.use_random_input = use_random_input_smiles
        self.use_random_target = use_random_target_smiles
        self.corrupt = corrupt
        self.consensus_noise = consensus_noise
        self.np_rng = np.random.RandomState(seed)
        self.py_rng = _random.Random(seed)

    def __len__(self):
        return len(self.smiles_list)

    def get_item(self, i: int) -> Optional[dict]:
        smiles = self.smiles_list[i]
        csmiles = canonical_smiles(smiles)
        if csmiles is None:
            return None
        rsmiles = None
        if self.use_random_input or self.use_random_target:
            rsmiles = random_smiles(csmiles, self.py_rng)
        input_smiles = rsmiles if self.use_random_input else csmiles
        target_smiles = rsmiles if self.use_random_target else csmiles

        input_seq = self.tokenizer.parse(input_smiles)
        target_seq, atom_idx = self.tokenizer.parse(
            target_smiles, return_atom_idx=True
        )
        if self.corrupt:
            input_seq = corrupt_tokens(
                input_seq, self.tokenizer.MASK, self.np_rng
            )
        if len(input_seq) > self.max_len or len(target_seq) > self.max_len:
            return None
        pg = smiles_to_ppgraph(target_smiles, self.py_rng)
        if pg is None:
            return None
        pp_h, pp_e, pp_mask, mapping = pg
        if (self.consensus_noise > 0.0
                and self.py_rng.random() < self.consensus_noise):
            pp_h, pp_e = consensus_style_graph(
                pp_h, pp_e, pp_mask, self.py_rng, self.np_rng
            )
        # token-level mapping: -100 ignore everywhere except atom tokens
        mapping_tok = np.full(
            (len(target_seq), MAX_NUM_PP_GRAPHS), -100.0, dtype=np.float32
        )
        k = min(len(atom_idx), mapping.shape[0])
        mapping[:, int(pp_mask.sum()) :] = -100.0
        for a in range(k):
            mapping_tok[atom_idx[a]] = mapping[a]
        props = [self.properties[key][i] for key in PROPERTY_KEYS]
        return {
            "input": input_seq,
            "target": target_seq,
            "pp_h": pp_h,
            "pp_e": pp_e,
            "pp_mask": pp_mask,
            "mapping": mapping_tok,
            "props": np.asarray(props, dtype=np.float32),
        }

    def padded_batch(self, idx: Sequence[int]) -> Optional[dict]:
        items = [self.get_item(i) for i in idx]
        items = [x for x in items if x is not None]
        if not items:
            return None
        # keep the batch dimension static (XLA recompiles on shape changes):
        # fill slots lost to invalid molecules by cycling the valid items
        valid_items = list(items)
        k = 0
        while len(items) < len(idx):
            items.append(valid_items[k % len(valid_items)])
            k += 1
        b = len(items)
        s = self.max_len
        pad = self.tokenizer.PAD
        out = {
            "inputs": np.full((b, s), pad, np.int32),
            "input_valid": np.zeros((b, s), np.float32),
            "targets": np.full((b, s), pad, np.int32),
            "pp_h": np.stack([x["pp_h"] for x in items]),
            "pp_e": np.stack([x["pp_e"] for x in items]),
            "pp_mask": np.stack([x["pp_mask"] for x in items]),
            "mapping": np.full((b, s, MAX_NUM_PP_GRAPHS), -100.0, np.float32),
            "props": np.stack([x["props"] for x in items]),
        }
        for k, x in enumerate(items):
            li, lt = len(x["input"]), len(x["target"])
            out["inputs"][k, :li] = x["input"]
            out["input_valid"][k, :li] = 1.0
            out["targets"][k, :lt] = x["target"]
            out["mapping"][k, :lt] = x["mapping"]
        return out

    def iter_batches(self, batch_size: int, shuffle=True,
                     drop_last=True) -> Iterator[dict]:
        order = np.arange(len(self))
        if shuffle:
            self.np_rng.shuffle(order)
        for i in range(0, len(order), batch_size):
            idx = order[i : i + batch_size]
            if drop_last and len(idx) < batch_size:
                break
            batch = self.padded_batch(idx)
            if batch is not None:
                yield batch

    def stacked_variants(self, n_variants: int, tries: int = 3) -> Optional[dict]:
        """Materialize the whole corpus as ``n_variants`` pre-drawn
        augmentation variants per molecule, stacked for device residency.

        Each variant is one full draw of the per-epoch randomness
        (randomized input SMILES, Poisson span corruption, SUS pp-graph
        subsampling — everything ``get_item`` redraws), so training that
        samples variants uniformly sees the same augmentation *distribution*
        as the host-fed loop, reusing each concrete draw ~n_epochs/R times
        (documented approximation of the reference's fresh per-epoch
        regeneration, train_chembl33_baseline.py dataloader).

        Compact dtypes keep HBM residency cheap: tokens i16 (vocab ≪ 2^15),
        mapping i8 (values in {-100, 0, 1}); ``input_valid`` is dropped and
        reconstructed on device as ``inputs != PAD`` (PAD never appears
        inside a live prefix). Returns a dict of [V, ...] arrays with
        V = n_valid_molecules * n_variants, or None if nothing parses.
        """
        s = self.max_len
        pad = self.tokenizer.PAD
        rows = {"inputs": [], "targets": [], "mapping": [], "pp_h": [],
                "pp_e": [], "pp_mask": [], "props": []}
        for i in range(len(self)):
            variants = []
            for _ in range(n_variants * tries):
                item = self.get_item(i)
                if item is not None:
                    variants.append(item)
                if len(variants) == n_variants:
                    break
            if not variants:
                continue  # molecule never parses/fits: skip (counted by caller)
            n_drawn = len(variants)
            while len(variants) < n_variants:
                variants.append(variants[len(variants) % n_drawn])
            for x in variants:
                inp = np.full((s,), pad, np.int16)
                tgt = np.full((s,), pad, np.int16)
                mp = np.full((s, MAX_NUM_PP_GRAPHS), -100, np.int8)
                inp[: len(x["input"])] = x["input"]
                tgt[: len(x["target"])] = x["target"]
                mp[: len(x["target"])] = x["mapping"].astype(np.int8)
                rows["inputs"].append(inp)
                rows["targets"].append(tgt)
                rows["mapping"].append(mp)
                rows["pp_h"].append(x["pp_h"])
                rows["pp_e"].append(x["pp_e"])
                rows["pp_mask"].append(x["pp_mask"])
                rows["props"].append(x["props"])
        if not rows["inputs"]:
            return None
        return {k: np.stack(v) for k, v in rows.items()}
