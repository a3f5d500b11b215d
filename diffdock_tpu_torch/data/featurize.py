"""Feature vocabularies and host-side featurizers (port of
``diffdock_tpu/data/featurize.py``).

The categorical vocabularies replicate the reference's ``allowable_features``
tables (``datasets/process_mols.py:24-87``) — feature indices are part of
any trained checkpoint's contract. The featurizers turn a parsed
:class:`~diffdock_tpu_torch.data.chem.Molecule` and
:class:`~diffdock_tpu_torch.data.chem.ProteinStructure` into a
:class:`~diffdock_tpu_torch.data.complexes.ComplexData` (and the all-atom
:class:`~diffdock_tpu_torch.data.complexes.AAComplexData`) with the JAX
package's numpy arithmetic, so the arrays are equal bit for bit, and
crops a training complex's receptor to a pocket (:func:`pocket_crop_complex`).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from diffdock_tpu_torch.data.chem import ATOMIC_NUM, implicit_h_counts, ring_membership
from diffdock_tpu_torch.data.chi import side_chain_vecs
from diffdock_tpu_torch.geometry.torsion import rotatable_bond_mask

# data/complexes.py imports this module's vocabularies, so the featurizers
# import it inside the functions

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


def safe_index(lst: Sequence, e) -> int:
    """Index of e in lst, or the last ('misc') index (reference
    ``process_mols.py:122-127``)."""
    try:
        return lst.index(e)
    except ValueError:
        return len(lst) - 1


THREE_TO_ONE = {
    "ALA": "A", "ARG": "R", "ASN": "N", "ASP": "D", "CYS": "C", "GLN": "Q",
    "GLU": "E", "GLY": "G", "HIS": "H", "ILE": "I", "LEU": "L", "LYS": "K",
    "MET": "M", "PHE": "F", "PRO": "P", "SER": "S", "THR": "T", "TRP": "W",
    "TYR": "Y", "VAL": "V",
}

# SDF bond order -> reference bond one-hot index
# (reference ``process_mols.py:57``: {SINGLE: 0, DOUBLE: 1, TRIPLE: 2,
# AROMATIC: 3})
BOND_ORDER_INDEX = {1: 0, 2: 1, 3: 2, 4: 3}


def featurize_ligand(mol) -> np.ndarray:
    """Categorical atom features for a (H-stripped) native Molecule.

    Mirrors the reference featurizer (``process_mols.py:90-117``). The
    native perception pass approximates three RDKit-derived fields
    (chirality -> unspecified, hybridization and implicit valence from bond
    orders); everything else is exact. The RDKit path, when available,
    reproduces all fields exactly.
    """
    num_rings, ring_sizes = ring_membership(mol)
    numh = implicit_h_counts(mol)
    heavy_deg = np.zeros(mol.num_atoms, np.int32)
    aromatic = np.zeros(mol.num_atoms, bool)
    double_cnt = np.zeros(mol.num_atoms, np.int32)
    triple_cnt = np.zeros(mol.num_atoms, np.int32)
    for i, j, o in mol.bonds:
        heavy_deg[i] += 1
        heavy_deg[j] += 1
        if o == 4:
            aromatic[i] = aromatic[j] = True
        elif o == 2:
            double_cnt[i] += 1
            double_cnt[j] += 1
        elif o == 3:
            triple_cnt[i] += 1
            triple_cnt[j] += 1

    feats = []
    f = ALLOWABLE_FEATURES
    for i, el in enumerate(mol.elements):
        if triple_cnt[i] or double_cnt[i] >= 2:
            hyb = "SP"
        elif double_cnt[i] or aromatic[i]:
            hyb = "SP2"
        else:
            hyb = "SP3"
        feats.append([
            safe_index(f["possible_atomic_num_list"], ATOMIC_NUM.get(el, 0)),
            0,  # chirality: unspecified in the native path
            safe_index(f["possible_degree_list"], int(heavy_deg[i] + numh[i])),
            safe_index(f["possible_formal_charge_list"], mol.charges[i]),
            safe_index(f["possible_implicit_valence_list"], int(numh[i])),
            safe_index(f["possible_numH_list"], int(numh[i])),
            0,  # radical electrons
            safe_index(f["possible_hybridization_list"], hyb),
            int(aromatic[i]),
            safe_index(f["possible_numring_list"], int(num_rings[i])),
            int(ring_sizes[3][i]),
            int(ring_sizes[4][i]),
            int(ring_sizes[5][i]),
            int(ring_sizes[6][i]),
            int(ring_sizes[7][i]),
            int(ring_sizes[8][i]),
        ])
    return np.asarray(feats, np.int32)


def build_ligand_arrays(mol, remove_hs: bool = True):
    """Ligand-side featurization (categoricals, bonded neighbor lists,
    rotatable-bond machinery) as a dict of arrays, plus the (H-stripped)
    Molecule. Ligand coords stay in their original frame — the receptor
    center is subtracted at join time (like the reference's separate
    ligand/receptor caches, ``datasets/moad.py:433-468``)."""
    if remove_hs:
        mol = mol.remove_hs()
    n = mol.num_atoms
    lig_cat = featurize_ligand(mol)

    # bonded neighbor lists with one-hot bond types
    deg = np.zeros(n, np.int32)
    for i, j, _ in mol.bonds:
        deg[i] += 1
        deg[j] += 1
    kb = max(int(deg.max()) if n else 1, 1)
    bond_nbr = np.zeros((n, kb), np.int32)
    bond_mask = np.zeros((n, kb), bool)
    bond_attr = np.zeros((n, kb, 4), np.float32)
    fill = np.zeros(n, np.int32)
    for i, j, o in mol.bonds:
        oh = BOND_ORDER_INDEX.get(o, 0)
        for a, b in ((i, j), (j, i)):
            bond_nbr[a, fill[a]] = b
            bond_mask[a, fill[a]] = True
            bond_attr[a, fill[a], oh] = 1.0
            fill[a] += 1

    edge_mask, mask_rotate = rotatable_bond_mask(
        n, [(i, j) for i, j, _ in mol.bonds]
    )
    directed = []
    for i, j, _ in mol.bonds:
        directed += [(i, j), (j, i)]
    rot_edges = [directed[k] for k in np.flatnonzero(edge_mask)]
    nb = len(rot_edges)

    arrays = dict(
        lig_cat=lig_cat,
        lig_mask=np.ones(n, bool),
        lig_coords=np.asarray(mol.coords, np.float32),
        lig_bond_nbr=bond_nbr,
        lig_bond_mask=bond_mask,
        lig_bond_attr=bond_attr,
        rot_u=np.asarray([e[0] for e in rot_edges], np.int32).reshape(nb),
        rot_v=np.asarray([e[1] for e in rot_edges], np.int32).reshape(nb),
        rot_mask=np.ones(nb, bool),
        mask_rotate=mask_rotate.astype(bool).reshape(nb, n),
    )
    return arrays, mol


def build_receptor_arrays(
    protein, lm_embeddings=None, c_alpha_max_neighbors: int = 10,
    receptor_radius=None,
):
    """Receptor-side featurization: residue categoricals, centered CA
    coords, precomputed kNN lists (optionally radius-capped with the
    reference's keep-nearest fallback, ``process_mols.py:170-190``), chain
    ids (for chain-cutoff cropping, reference ``datasets/moad.py:204-248``),
    and the centering offset."""
    from diffdock_tpu_torch.data.complexes import build_knn_neighbors

    residues = protein.residues_with_ca()
    rec_pos = np.asarray([r.ca for r in residues], np.float32)
    center = rec_pos.mean(0)
    rec_pos = rec_pos - center
    rec_cat = np.asarray(
        [[safe_index(ALLOWABLE_FEATURES["possible_amino_acids"], r.name)]
         for r in residues],
        np.int32,
    )
    rec_nbr, rec_nbr_mask = build_knn_neighbors(
        rec_pos, c_alpha_max_neighbors, max_radius=receptor_radius
    )

    if lm_embeddings is None:
        rec_lm = np.zeros((len(residues), 0), np.float32)
    else:
        rec_lm = np.asarray(lm_embeddings, np.float32)
        assert rec_lm.shape[0] == len(residues), (
            f"LM embeddings rows {rec_lm.shape[0]} != residues {len(residues)}"
        )

    chain_order = {c: i for i, c in enumerate(protein.chains())}
    chain_ids = np.asarray([chain_order[r.chain] for r in residues], np.int32)

    return dict(
        side_chain_vecs=side_chain_vecs(protein),
        rec_cat=rec_cat,
        rec_lm=rec_lm,
        rec_mask=np.ones(len(residues), bool),
        rec_pos=rec_pos,
        rec_nbr=rec_nbr,
        rec_nbr_mask=rec_nbr_mask,
        chain_ids=chain_ids,
        original_center=center.astype(np.float32),
    )


def join_complex_arrays(lig: dict, rec: dict):
    """Assemble ligand + receptor array dicts into a ``ComplexData``
    (ligand coords shifted into the receptor-centered frame)."""
    from diffdock_tpu_torch.data.complexes import ComplexData

    return ComplexData(
        lig_cat=lig["lig_cat"],
        lig_mask=lig["lig_mask"],
        lig_pos=lig["lig_coords"] - rec["original_center"],
        lig_bond_nbr=lig["lig_bond_nbr"],
        lig_bond_mask=lig["lig_bond_mask"],
        lig_bond_attr=lig["lig_bond_attr"],
        rot_u=lig["rot_u"],
        rot_v=lig["rot_v"],
        rot_mask=lig["rot_mask"],
        mask_rotate=lig["mask_rotate"],
        rec_cat=rec["rec_cat"],
        rec_lm=rec["rec_lm"],
        rec_mask=rec["rec_mask"],
        rec_pos=rec["rec_pos"],
        rec_nbr=rec["rec_nbr"],
        rec_nbr_mask=rec["rec_nbr_mask"],
        original_center=rec["original_center"],
        rec_scv=rec.get("side_chain_vecs"),
    )


def build_complex_data(
    mol,
    protein,
    lm_embeddings=None,
    c_alpha_max_neighbors: int = 10,
    remove_hs: bool = True,
    receptor_radius=None,
):
    """Assemble a ``ComplexData`` from a ligand Molecule and a
    ProteinStructure (the host-side replacement for the reference's
    HeteroData construction, ``process_mols.py:128-276,426-466``).

    Coordinates are receptor-centered (reference stores
    ``original_center`` and shifts both molecules by it).
    """
    lig, mol = build_ligand_arrays(mol, remove_hs=remove_hs)
    rec = build_receptor_arrays(
        protein, lm_embeddings, c_alpha_max_neighbors=c_alpha_max_neighbors,
        receptor_radius=receptor_radius,
    )
    return join_complex_arrays(lig, rec), mol


def pocket_crop_complex(data, capacity: int, k_rec: int = 10):
    """Host-side pocket crop: keep the ``capacity`` residues nearest the
    (crystal) ligand centroid, in their order, and rebuild the receptor kNN
    graph (the JAX package's training-time analogue of the model's
    ``crop_beyond`` and pocket compaction, to fit large receptors into small
    training buckets; the reference crops by ligand distance when it
    preprocesses)."""
    from diffdock_tpu_torch.data.complexes import build_knn_neighbors

    if data.n_rec <= capacity:
        return data
    lig_c = np.asarray(data.lig_pos)[np.asarray(data.lig_mask)].mean(0)
    d = np.linalg.norm(np.asarray(data.rec_pos) - lig_c, axis=1)
    keep = np.argsort(d)[:capacity]
    keep.sort()
    rec_pos = np.asarray(data.rec_pos)[keep]
    rec_nbr, rec_nbr_mask = build_knn_neighbors(rec_pos, k_rec)
    return data._replace(
        rec_cat=np.asarray(data.rec_cat)[keep],
        rec_lm=np.asarray(data.rec_lm)[keep],
        rec_mask=np.asarray(data.rec_mask)[keep],
        rec_pos=rec_pos,
        rec_nbr=rec_nbr,
        rec_nbr_mask=rec_nbr_mask,
        rec_scv=None if data.rec_scv is None else np.asarray(data.rec_scv)[keep],
    )


def _atom_type2(name: str) -> str:
    """Collapse an atom name to the reference's type-2 vocabulary
    ('CA', 'ND', ... else 'C*'-style wildcards)."""
    f = ALLOWABLE_FEATURES["possible_atom_type_2"]
    if name[:2] in f:
        return name[:2]
    wild = name[:1] + "*"
    return wild if wild in f else "misc"


def build_aa_complex_data(
    mol,
    protein,
    lm_embeddings=None,
    c_alpha_max_neighbors: int = 10,
    atom_max_neighbors: int = 8,
    remove_hs: bool = True,
    max_atoms_per_residue: int = 14,
    receptor_radius=None,
):
    """Assemble an all-atom complex (ligand + residues + receptor heavy
    atoms) for the AA model (reference atom featurization
    ``process_mols.py:244-276``, atom graphs ``models/aa_model.py:573-640``).
    """
    from diffdock_tpu_torch.data.complexes import AAComplexData, build_knn_neighbors

    base, heavy = build_complex_data(
        mol, protein, lm_embeddings,
        c_alpha_max_neighbors=c_alpha_max_neighbors, remove_hs=remove_hs,
        receptor_radius=receptor_radius,
    )
    center = np.asarray(base.original_center)

    residues = protein.residues_with_ca()
    f = ALLOWABLE_FEATURES
    atom_cat, atom_pos, atom_res = [], [], []
    res_atoms: list = [[] for _ in residues]
    for ri, res in enumerate(residues):
        aa_idx = safe_index(f["possible_amino_acids"], res.name)
        for name, xyz in res.atoms.items():
            el = res.elements.get(name) or name[:1]
            if el == "H":
                continue
            atom_idx = len(atom_pos)
            atom_cat.append([
                aa_idx,
                safe_index(f["possible_atomic_num_list"], ATOMIC_NUM.get(el, 0)),
                safe_index(f["possible_atom_type_2"], _atom_type2(name)),
                safe_index(f["possible_atom_type_3"], name),
            ])
            atom_pos.append(np.asarray(xyz, np.float32) - center)
            atom_res.append(ri)
            if len(res_atoms[ri]) < max_atoms_per_residue:
                res_atoms[ri].append(atom_idx)

    atom_pos = np.asarray(atom_pos, np.float32).reshape(-1, 3)
    na = atom_pos.shape[0]
    atom_nbr, atom_nbr_mask = build_knn_neighbors(atom_pos, atom_max_neighbors)

    nr = len(residues)
    res_atom_idx = np.zeros((nr, max_atoms_per_residue), np.int32)
    res_atom_mask = np.zeros((nr, max_atoms_per_residue), bool)
    for ri, atoms in enumerate(res_atoms):
        res_atom_idx[ri, : len(atoms)] = atoms
        res_atom_mask[ri, : len(atoms)] = True

    return AAComplexData(
        base=base,
        atom_cat=np.asarray(atom_cat, np.int32).reshape(na, 4),
        atom_mask=np.ones(na, bool),
        atom_pos=atom_pos,
        atom_nbr=atom_nbr,
        atom_nbr_mask=atom_nbr_mask,
        atom_res=np.asarray(atom_res, np.int32),
        res_atom_idx=res_atom_idx,
        res_atom_mask=res_atom_mask,
    ), heavy
