"""The benchmark's complexes, made from the seed.

A frozen copy of the port's synthetic generator
(``data/complexes.py:synthetic_complex`` and ``synthetic_aa_complex``, and
the rotatable-bond rule of ``geometry/torsion.py``): a ligand chain of
``n_lig`` atoms with ``n_lig // 4`` rotatable bonds (by default), a receptor
of ``n_rec`` residues with ``lm_dim`` language-model features each and
``atoms_per_residue`` heavy atoms around each C-alpha, and the receptor's
residue and atom graphs at the configuration's widths (``graph``: the
published ``c_alpha_max_neighbors`` within ``receptor_radius``,
``atom_max_neighbors`` within ``atom_radius``). Two changes from the port's
generator: the language-model features are drawn (standard normal) rather
than zero, and the neighbour lists come from a k-d tree (``scipy``) rather
than the port's native library; both sides of every comparison get the
same arrays.

Everything is plain numpy; the fields are returned as dicts, which the
harness turns into the port's types and the reference into its own.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.spatial import cKDTree

from benchmark.reference.data.features import LIG_CATEGORICAL_DIMS, REC_ATOM_CATEGORICAL_DIMS


def _components(num_atoms: int, adj: List[List[int]], skip: Tuple[int, int]) -> List[List[int]]:
    """Connected components (sorted atom lists) with one undirected edge
    removed, discovered from the lowest unvisited atom upwards."""
    seen = [False] * num_atoms
    comps = []
    a_skip, b_skip = skip
    for start in range(num_atoms):
        if seen[start]:
            continue
        seen[start] = True
        comp, queue = [start], [start]
        while queue:
            node = queue.pop()
            for nb in adj[node]:
                if (node, nb) in ((a_skip, b_skip), (b_skip, a_skip)) or seen[nb]:
                    continue
                seen[nb] = True
                comp.append(nb)
                queue.append(nb)
        comps.append(sorted(comp))
    return comps


def rotatable_bond_mask(num_atoms: int, bonds: Sequence[Tuple[int, int]]):
    """(edge_mask (2 * n_bonds,), mask_rotate (n_rotatable, num_atoms)): a
    bond is rotatable iff removing it disconnects the graph and the smaller
    side has more than one atom, which is the side it moves."""
    adj: List[List[int]] = [[] for _ in range(num_atoms)]
    for i, j in bonds:
        adj[i].append(j)
        adj[j].append(i)
    to_rotate: List[List[int]] = []
    for i, j in bonds:
        comps = _components(num_atoms, adj, (i, j))
        rotated0: List[int] = []
        rotated1: List[int] = []
        if len(comps) > 1:
            smaller = sorted(comps, key=len)[0]
            if len(smaller) > 1:
                if i in smaller:
                    rotated1 = smaller
                else:
                    rotated0 = smaller
        to_rotate.append(rotated0)
        to_rotate.append(rotated1)
    edge_mask = np.array([len(r) > 0 for r in to_rotate], dtype=bool)
    mask_rotate = np.zeros((int(edge_mask.sum()), num_atoms), dtype=bool)
    for row, r in enumerate([r for r in to_rotate if r]):
        mask_rotate[row, np.asarray(r, dtype=int)] = True
    return edge_mask, mask_rotate


def knn(pos: np.ndarray, k: int, max_radius: Optional[float] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Each point's k nearest other points: (idx (n, k) int32, mask (n, k)).
    With ``max_radius`` the mask drops neighbours farther than it, but keeps
    each point's nearest, so that none is isolated (the rule of the
    published featurisation, ``process_mols.py``, and of the port's
    ``build_knn_neighbors``)."""
    n = pos.shape[0]
    k = min(k, max(n - 1, 1))
    p64 = pos.astype(np.float64)
    dist, idx = cKDTree(p64).query(p64, k=k + 1)
    idx, dist = np.asarray(idx).reshape(n, k + 1), np.asarray(dist).reshape(n, k + 1)
    # drop each point itself (the nearest, at distance 0)
    keep = idx != np.arange(n)[:, None]
    out = np.stack([row[m][:k] for row, m in zip(idx, keep)])
    d = np.stack([row[m][:k] for row, m in zip(dist, keep)])
    mask = np.ones((n, k), bool)
    if max_radius is not None:
        mask = d <= max_radius
        if n > 1:
            mask[:, 0] |= ~mask.any(axis=1)
    return out.astype(np.int32), mask


def synthetic_complex(rng: np.random.RandomState, n_lig: int, n_rec: int, n_bonds: int,
                      lm_dim: int, rec_knn: int, rec_radius: Optional[float]) -> Dict[str, np.ndarray]:
    """The coarse-grained fields of one complex (``ComplexData``'s names)."""
    lig_pos = np.cumsum(rng.randn(n_lig, 3).astype(np.float32) * 0.8, axis=0)
    lig_pos = lig_pos - lig_pos.mean(0)
    bonds = [(i, i + 1) for i in range(n_lig - 1)]

    edge_mask, mask_rotate = rotatable_bond_mask(n_lig, bonds)
    directed = [e for ij in bonds for e in (ij, ij[::-1])]
    rot_edges = [directed[i] for i in np.flatnonzero(edge_mask)]
    rot_edges, mask_rotate = rot_edges[:n_bonds], mask_rotate[:n_bonds]

    kb = 4
    bond_nbr = np.zeros((n_lig, kb), np.int32)
    bond_mask = np.zeros((n_lig, kb), bool)
    bond_attr = np.zeros((n_lig, kb, 4), np.float32)
    deg = np.zeros(n_lig, int)
    for (i, j) in bonds:
        for a, b in ((i, j), (j, i)):
            bond_nbr[a, deg[a]] = b
            bond_mask[a, deg[a]] = True
            bond_attr[a, deg[a], rng.randint(4)] = 1.0
            deg[a] += 1

    rec_pos = (rng.randn(n_rec, 3) * 8.0).astype(np.float32)
    rec_pos = rec_pos - rec_pos.mean(0)
    rec_nbr, rec_nbr_mask = knn(rec_pos, rec_knn, rec_radius)
    lig_cat = np.stack([rng.randint(0, d, size=n_lig) for d in LIG_CATEGORICAL_DIMS],
                       axis=1).astype(np.int32)
    nb = len(rot_edges)
    return dict(
        lig_cat=lig_cat,
        lig_mask=np.ones(n_lig, bool),
        lig_pos=lig_pos,
        lig_bond_nbr=bond_nbr,
        lig_bond_mask=bond_mask,
        lig_bond_attr=bond_attr,
        rot_u=np.array([e[0] for e in rot_edges], np.int32),
        rot_v=np.array([e[1] for e in rot_edges], np.int32),
        rot_mask=np.ones(nb, bool),
        mask_rotate=mask_rotate.astype(bool),
        rec_cat=rng.randint(0, 20, size=(n_rec, 1)).astype(np.int32),
        rec_lm=rng.randn(n_rec, lm_dim).astype(np.float32),
        rec_mask=np.ones(n_rec, bool),
        rec_pos=rec_pos,
        rec_nbr=rec_nbr,
        rec_nbr_mask=rec_nbr_mask,
        original_center=np.zeros(3, np.float32),
    )


def synthetic_aa_fields(rng: np.random.RandomState, base: Dict[str, np.ndarray],
                        atoms_per_residue: int, atom_knn: int,
                        atom_radius: Optional[float]) -> Dict[str, np.ndarray]:
    """The all-atom fields (``AAComplexData``'s, without ``base``): each
    residue's heavy atoms near its C-alpha, and the atom kNN graph."""
    n_rec = base["rec_pos"].shape[0]
    na = n_rec * atoms_per_residue
    atom_res = np.repeat(np.arange(n_rec), atoms_per_residue).astype(np.int32)
    atom_pos = base["rec_pos"][atom_res] + rng.randn(na, 3).astype(np.float32) * 1.5
    atom_cat = np.stack([rng.randint(0, d, size=na) for d in REC_ATOM_CATEGORICAL_DIMS],
                        axis=1).astype(np.int32)
    atom_nbr, atom_nbr_mask = knn(atom_pos, atom_knn, atom_radius)
    return dict(
        atom_cat=atom_cat,
        atom_mask=np.ones(na, bool),
        atom_pos=atom_pos,
        atom_nbr=atom_nbr,
        atom_nbr_mask=atom_nbr_mask,
        atom_res=atom_res,
        res_atom_idx=np.arange(na).reshape(n_rec, atoms_per_residue).astype(np.int32),
        res_atom_mask=np.ones((n_rec, atoms_per_residue), bool),
    )


def sub_seed(seed: int, *path: int) -> int:
    """A 32-bit seed for one part of a run (``path``), from the run's seed
    (any whole number; negative ones are taken modulo 2**64)."""
    return int(np.random.SeedSequence([int(seed) % 2**64, *path]).generate_state(1)[0])


def make_cycle(seed: int, traffic: dict, config: dict) -> List[Tuple[dict, dict]]:
    """The cell's complexes in cycle order: (fields, all-atom fields) of
    each (n_lig, n_rec) of ``traffic["cycle"]``, complex ``i`` drawn from
    ``sub_seed(seed, 1, i)``, with the language-model width and the graphs
    of ``config`` (a configuration file's content). The sizes are the
    cell's; the seed draws only the coordinates and features."""
    lm_dim, g = config["score_model"]["lm_embedding_dim"], config["graph"]
    out = []
    for i, (n_lig, n_rec) in enumerate(traffic["cycle"]):
        rng = np.random.RandomState(sub_seed(seed, 1, i))
        n_bonds = max(1, n_lig // traffic["ligand_atoms_per_rotatable_bond"])
        base = synthetic_complex(rng, n_lig, n_rec, n_bonds, lm_dim, g["c_alpha_max_neighbors"],
                                 g["receptor_radius"])
        aa = synthetic_aa_fields(rng, base, traffic["atoms_per_residue"], g["atom_max_neighbors"],
                                 g["atom_radius"])
        out.append((base, aa))
    return out
