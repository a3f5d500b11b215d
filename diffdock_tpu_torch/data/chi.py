"""Sidechain chi angles and backbone relative vectors (copied from
``diffdock_tpu/data/chi.py``; reference
``datasets/parse_chi.py:10-123`` + ``process_mols.py:163-165``).

Host-side featurization: per residue up to four chi dihedrals (degrees,
0-360) from the standard atom quadruples, plus N-CA and C-CA relative
vectors. The reference packs ``[chi/360, n_rel_pos, c_rel_pos]`` as
``side_chain_vecs`` used by the optional sidechain/backbone auxiliary
losses (``utils/training.py:62-88``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# standard chi1-chi4 atom quadruples per amino acid
CHI_ATOMS: Dict[str, List[Tuple[str, str, str, str]]] = {
    "ARG": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "CD"),
            ("CB", "CG", "CD", "NE"), ("CG", "CD", "NE", "CZ")],
    "ASN": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "OD1")],
    "ASP": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "OD1")],
    "CYS": [("N", "CA", "CB", "SG")],
    "GLN": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "CD"),
            ("CB", "CG", "CD", "OE1")],
    "GLU": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "CD"),
            ("CB", "CG", "CD", "OE1")],
    "HIS": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "ND1")],
    "ILE": [("N", "CA", "CB", "CG1"), ("CA", "CB", "CG1", "CD1")],
    "LEU": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "CD1")],
    "LYS": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "CD"),
            ("CB", "CG", "CD", "CE"), ("CG", "CD", "CE", "NZ")],
    "MET": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "SD"),
            ("CB", "CG", "SD", "CE")],
    "PHE": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "CD1")],
    "PRO": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "CD")],
    "SER": [("N", "CA", "CB", "OG")],
    "THR": [("N", "CA", "CB", "OG1")],
    "TRP": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "CD1")],
    "TYR": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "CD1")],
    "VAL": [("N", "CA", "CB", "CG1")],
    # ALA / GLY have no chi angles
}

MAX_CHI = 4


def dihedral(p0, p1, p2, p3) -> float:
    """Dihedral angle in degrees in [0, 360) (praxeolitic formula)."""
    b0 = np.asarray(p0) - np.asarray(p1)
    b1 = np.asarray(p2) - np.asarray(p1)
    b2 = np.asarray(p3) - np.asarray(p2)
    b1 = b1 / np.linalg.norm(b1)
    v = b0 - np.dot(b0, b1) * b1
    w = b2 - np.dot(b2, b1) * b1
    x = np.dot(v, w)
    y = np.dot(np.cross(b1, v), w)
    ang = np.degrees(np.arctan2(y, x))
    return float(ang % 360.0)


def residue_chi_angles(residue) -> Tuple[np.ndarray, np.ndarray]:
    """(MAX_CHI,) chi angles in degrees and a validity mask for one
    Residue (missing atoms -> 0 with mask False, like the reference's
    nan-to-zero handling)."""
    angles = np.zeros(MAX_CHI, np.float32)
    mask = np.zeros(MAX_CHI, bool)
    for ci, quad in enumerate(CHI_ATOMS.get(residue.name, [])):
        coords = [residue.atoms.get(a) for a in quad]
        if any(c is None for c in coords):
            continue
        angles[ci] = dihedral(*coords)
        mask[ci] = True
    return angles, mask


def side_chain_vecs(protein) -> np.ndarray:
    """(R, 4 + 3 + 3): [chi/360, N - CA, C - CA] per CA-bearing residue
    (reference ``process_mols.py:163-165``). Undefined chi angles are NaN —
    the auxiliary losses zero them out exactly like the reference
    (``utils/training.py:95-97`` where-isnan masking); missing backbone
    atoms contribute 0."""
    rows = []
    for res in protein.residues_with_ca():
        chi, chi_mask = residue_chi_angles(res)
        chi = np.where(chi_mask, chi, np.nan).astype(np.float32)
        ca = np.asarray(res.ca, np.float32)
        n = res.atoms.get("N")
        c = res.atoms.get("C")
        n_rel = (np.asarray(n, np.float32) - ca) if n is not None else np.zeros(3, np.float32)
        c_rel = (np.asarray(c, np.float32) - ca) if c is not None else np.zeros(3, np.float32)
        rows.append(np.concatenate([chi / 360.0, n_rel, c_rel]))
    return np.asarray(rows, np.float32).reshape(-1, 10)
