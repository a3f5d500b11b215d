"""Categorical feature vocabularies (copied from ``diffdock_tpu/data/featurize.py``).

The vocabularies replicate the reference's ``allowable_features`` tables
(``datasets/process_mols.py:24-87``) — feature indices are part of any
trained checkpoint's contract. Only the constants are ported; featurizing
files (RDKit) waits for a later slice.
"""

from __future__ import annotations

ALLOWABLE_FEATURES = {
    "possible_atomic_num_list": list(range(1, 119)) + ["misc"],
    "possible_chirality_list": [
        "CHI_UNSPECIFIED",
        "CHI_TETRAHEDRAL_CW",
        "CHI_TETRAHEDRAL_CCW",
        "CHI_OTHER",
    ],
    "possible_degree_list": [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, "misc"],
    "possible_numring_list": [0, 1, 2, 3, 4, 5, 6, "misc"],
    "possible_implicit_valence_list": [0, 1, 2, 3, 4, 5, 6, "misc"],
    "possible_formal_charge_list": [-5, -4, -3, -2, -1, 0, 1, 2, 3, 4, 5, "misc"],
    "possible_numH_list": [0, 1, 2, 3, 4, 5, 6, 7, 8, "misc"],
    "possible_number_radical_e_list": [0, 1, 2, 3, 4, "misc"],
    "possible_hybridization_list": ["SP", "SP2", "SP3", "SP3D", "SP3D2", "misc"],
    "possible_is_aromatic_list": [False, True],
    "possible_is_in_ring3_list": [False, True],
    "possible_is_in_ring4_list": [False, True],
    "possible_is_in_ring5_list": [False, True],
    "possible_is_in_ring6_list": [False, True],
    "possible_is_in_ring7_list": [False, True],
    "possible_is_in_ring8_list": [False, True],
    "possible_amino_acids": [
        "ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE",
        "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL",
        "HIP", "HIE", "TPO", "HID", "LEV", "MEU", "PTR", "GLV", "CYT", "SEP",
        "HIZ", "CYM", "GLM", "ASQ", "TYS", "CYX", "GLZ", "misc",
    ],
    "possible_atom_type_2": [
        "C*", "CA", "CB", "CD", "CE", "CG", "CH", "CZ", "N*", "ND", "NE",
        "NH", "NZ", "O*", "OD", "OE", "OG", "OH", "OX", "S*", "SD", "SG",
        "misc",
    ],
    "possible_atom_type_3": [
        "C", "CA", "CB", "CD", "CD1", "CD2", "CE", "CE1", "CE2", "CE3", "CG",
        "CG1", "CG2", "CH2", "CZ", "CZ2", "CZ3", "N", "ND1", "ND2", "NE",
        "NE1", "NE2", "NH1", "NH2", "NZ", "O", "OD1", "OD2", "OE1", "OE2",
        "OG", "OG1", "OH", "OXT", "SD", "SG", "misc",
    ],
}

_LIG_FEATURE_KEYS = [
    "possible_atomic_num_list",
    "possible_chirality_list",
    "possible_degree_list",
    "possible_formal_charge_list",
    "possible_implicit_valence_list",
    "possible_numH_list",
    "possible_number_radical_e_list",
    "possible_hybridization_list",
    "possible_is_aromatic_list",
    "possible_numring_list",
    "possible_is_in_ring3_list",
    "possible_is_in_ring4_list",
    "possible_is_in_ring5_list",
    "possible_is_in_ring6_list",
    "possible_is_in_ring7_list",
    "possible_is_in_ring8_list",
]

LIG_CATEGORICAL_DIMS = tuple(len(ALLOWABLE_FEATURES[k]) for k in _LIG_FEATURE_KEYS)
REC_CATEGORICAL_DIMS = (len(ALLOWABLE_FEATURES["possible_amino_acids"]),)
REC_ATOM_CATEGORICAL_DIMS = tuple(
    len(ALLOWABLE_FEATURES[k])
    for k in [
        "possible_amino_acids",
        "possible_atomic_num_list",
        "possible_atom_type_2",
        "possible_atom_type_3",
    ]
)


