"""Dataset-specific encodings (a copy of ``cmdgen_tpu/chem/constants.py``,
which mirrors DiffPhar/constants.py:94-123)."""
from __future__ import annotations

PHAR_ENCODER = {
    "Aromatic": 0, "Hydrophobe": 1, "PosIonizable": 2, "NegIonizable": 3,
    "Acceptor": 4, "Donor": 5, "LumpedHydrophobe": 6, "others": 7,
}
PHAR_DECODER = [
    "Aromatic", "Hydrophobe", "PosIonizable", "NegIonizable",
    "Acceptor", "Donor", "LumpedHydrophobe", "others",
]

# empirical training histograms (constants.py:105-106, 120-123) — used as
# reference distributions for eval-time KL metrics
PHAR_HIST = {
    "Aromatic": 176393, "Hydrophobe": 329938, "PosIonizable": 38876,
    "NegIonizable": 28234, "Acceptor": 485363, "Donor": 303290,
    "LumpedHydrophobe": 124515, "others": 30892,
}

DATASET_PARAMS = {
    "crossdock_full": {
        # full-atom pocket: element classes
        "atom_encoder": {
            "C": 0, "N": 1, "O": 2, "S": 3, "B": 4, "Br": 5, "Cl": 6,
            "P": 7, "I": 8, "F": 9, "others": 10,
        },
        "atom_decoder": [
            "C", "N", "O", "S", "B", "Br", "Cl", "P", "I", "F", "others"
        ],
        "phar_encoder": PHAR_ENCODER,
        "phar_decoder": PHAR_DECODER,
        "aa_encoder": {
            "C": 0, "N": 1, "O": 2, "S": 3, "B": 4, "Br": 5, "Cl": 6,
            "P": 7, "I": 8, "F": 9, "others": 10,
        },
        "phar_hist": PHAR_HIST,
    },
    "crossdock": {
        # CA-only pocket: amino-acid classes
        "atom_encoder": {
            "C": 0, "N": 1, "O": 2, "S": 3, "B": 4, "Br": 5, "Cl": 6,
            "P": 7, "I": 8, "F": 9,
        },
        "atom_decoder": ["C", "N", "O", "S", "B", "Br", "Cl", "P", "I", "F"],
        "phar_encoder": PHAR_ENCODER,
        "phar_decoder": PHAR_DECODER,
        "aa_encoder": {
            "A": 0, "C": 1, "D": 2, "E": 3, "F": 4, "G": 5, "H": 6, "I": 7,
            "K": 8, "L": 9, "M": 10, "N": 11, "P": 12, "Q": 13, "R": 14,
            "S": 15, "T": 16, "V": 17, "W": 18, "Y": 19,
        },
        "aa_decoder": list("ACDEFGHIKLMNPQRSTVWY"),
        "phar_hist": PHAR_HIST,
    },
}

# three-letter -> one-letter amino acid codes (for PDB parsing)
AA_3TO1 = {
    "ALA": "A", "CYS": "C", "ASP": "D", "GLU": "E", "PHE": "F",
    "GLY": "G", "HIS": "H", "ILE": "I", "LYS": "K", "LEU": "L",
    "MET": "M", "ASN": "N", "PRO": "P", "GLN": "Q", "ARG": "R",
    "SER": "S", "THR": "T", "VAL": "V", "TRP": "W", "TYR": "Y",
}
