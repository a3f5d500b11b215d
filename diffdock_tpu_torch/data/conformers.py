"""Conformer generation and matching (port of ``diffdock_tpu/data/conformers.py``;
reference ``datasets/conformer_matching.py:16-85``, ``process_mols.py:304-384``).

Training data prep: the model learns from *generated* conformers whose
torsions are optimized to match the crystal pose ("conformer matching" from
Torsional Diffusion). Host-side numpy/scipy, as in the JAX package:

* conformer generation: torsion randomization of the input conformer (the
  degrees of freedom the diffusion acts on). The JAX package embeds with
  RDKit's ETKDG where RDKit imports; the port, which never imports RDKit,
  always takes the JAX package's other branch,
* torsion optimization: scipy differential evolution over rotatable-bond
  angles minimizing the aligned RMSD to the crystal pose, like the
  reference's ``OptimizeConformer``.

Where RDKit is absent both packages give the same results bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from diffdock_tpu_torch.data.chem import Molecule
from diffdock_tpu_torch.geometry.torsion import rotatable_bond_mask


def apply_torsion_np(
    pos: np.ndarray,
    edges: np.ndarray,
    mask_rotate: np.ndarray,
    updates: np.ndarray,
) -> np.ndarray:
    """Numpy twin of the device torsion update (reference
    ``utils/torsion.py:48-72``) for host-side optimization loops."""
    from scipy.spatial.transform import Rotation as R

    pos = pos.copy()
    for idx, (u, v) in enumerate(edges):
        theta = updates[idx]
        if theta == 0:
            continue
        axis = pos[u] - pos[v]
        axis = axis / np.linalg.norm(axis) * theta
        rot = R.from_rotvec(axis).as_matrix()
        sel = mask_rotate[idx]
        pos[sel] = (pos[sel] - pos[v]) @ rot.T + pos[v]
    return pos


def rotatable_edges(mol: Molecule) -> Tuple[np.ndarray, np.ndarray]:
    """(edges (n_rot, 2) directed rotatable bonds, mask_rotate (n_rot, N))."""
    bonds = [(i, j) for i, j, _ in mol.bonds]
    edge_mask, mask_rotate = rotatable_bond_mask(mol.num_atoms, bonds)
    directed = []
    for i, j in bonds:
        directed += [(i, j), (j, i)]
    edges = np.asarray(
        [directed[k] for k in np.flatnonzero(edge_mask)], np.int64
    ).reshape(-1, 2)
    return edges, mask_rotate


def generate_conformer(
    mol: Molecule, seed: int = 0, randomize_torsions: bool = True
) -> Molecule:
    """A fresh conformer by torsion randomization of the given geometry (the
    JAX package's branch without RDKit; the port does not use RDKit)."""
    edges, mask_rotate = rotatable_edges(mol)
    rng = np.random.RandomState(seed)
    pos = np.asarray(mol.coords, np.float64)
    if randomize_torsions and len(edges):
        updates = rng.uniform(-np.pi, np.pi, size=len(edges))
        pos = apply_torsion_np(pos, edges, mask_rotate, updates)
    return Molecule(
        elements=list(mol.elements), coords=pos.astype(np.float32),
        bonds=list(mol.bonds), charges=list(mol.charges), name=mol.name,
    )


def _aligned_rmsd(a: np.ndarray, b: np.ndarray) -> float:
    """RMSD after optimal rigid alignment (the matching objective aligns
    before scoring, reference ``conformer_matching.py:39-52``)."""
    ca, cb = a.mean(0), b.mean(0)
    am, bm = a - ca, b - cb
    h = am.T @ bm
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    rot = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
    return float(np.sqrt(np.mean(np.sum((am @ rot.T - bm) ** 2, axis=1))))


def optimize_rotatable_bonds(
    conf_pos: np.ndarray,
    ref_pos: np.ndarray,
    edges: np.ndarray,
    mask_rotate: np.ndarray,
    popsize: int = 20,
    maxiter: int = 20,
    seed: int = 0,
) -> Tuple[np.ndarray, float]:
    """Differential evolution over torsions to best match the reference pose
    (reference ``optimize_rotatable_bonds``, ``conformer_matching.py:16-38``).

    Returns (optimized positions, aligned RMSD)."""
    from scipy.optimize import differential_evolution

    if len(edges) == 0:
        return conf_pos.copy(), _aligned_rmsd(conf_pos, ref_pos)

    def objective(x):
        moved = apply_torsion_np(conf_pos, edges, mask_rotate, x)
        return _aligned_rmsd(moved, ref_pos)

    bounds = [(-np.pi, np.pi)] * len(edges)
    res = differential_evolution(
        objective, bounds, popsize=popsize, maxiter=maxiter, seed=seed,
        polish=False,
    )
    out = apply_torsion_np(conf_pos, edges, mask_rotate, res.x)
    return out, float(res.fun)


def conformer_match(
    mol: Molecule, tries: int = 1, popsize: int = 20, maxiter: int = 20,
    seed: int = 0,
) -> Tuple[Molecule, float]:
    """Full matching flow: generate conformer(s), optimize torsions to the
    crystal pose, keep the best (reference ``get_lig_graph_with_matching``,
    ``process_mols.py:304-384``)."""
    edges, mask_rotate = rotatable_edges(mol)
    ref = np.asarray(mol.coords, np.float64)
    best_pos, best_rmsd = None, np.inf
    for k in range(tries):
        conf = generate_conformer(mol, seed=seed + k)
        pos, rmsd = optimize_rotatable_bonds(
            np.asarray(conf.coords, np.float64), ref, edges, mask_rotate,
            popsize=popsize, maxiter=maxiter, seed=seed + k,
        )
        if rmsd < best_rmsd:
            best_pos, best_rmsd = pos, rmsd
    matched = Molecule(
        elements=list(mol.elements), coords=best_pos.astype(np.float32),
        bonds=list(mol.bonds), charges=list(mol.charges), name=mol.name,
    )
    return matched, best_rmsd
