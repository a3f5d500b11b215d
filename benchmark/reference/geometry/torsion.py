"""Torsion-angle updates about rotatable bonds.

Port of ``diffdock_tpu/geometry/torsion.py``. ``apply_torsion_updates``
rotates atom subsets bond after bond in the reference's sequential order
(later bonds rotate about axes already moved by earlier ones), batched over
poses. ``rotatable_bond_mask`` finds bridge bonds on the host with a plain
breadth-first search over the bond list instead of networkx.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference.geometry.rotations import axis_angle_to_matrix


def apply_torsion_updates(
    pos: torch.Tensor,
    bond_u: torch.Tensor,
    bond_v: torch.Tensor,
    mask_rotate: torch.Tensor,
    torsion_updates: torch.Tensor,
    bond_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sequentially rotate atom subsets about rotatable bonds.

    pos: (P, N, 3) poses; bond_u / bond_v: (B,) fixed-side and rotated-side
    atoms; mask_rotate: (B, N) bool atoms moved per bond; torsion_updates:
    (P, B) angles; bond_mask: optional (B,) validity of bond slots.
    Axis = pos[u] - pos[v]; positive angles follow the reference convention.
    """
    if bond_mask is None:
        bond_mask = torch.ones(bond_u.shape, dtype=torch.bool, device=pos.device)
    keep_all = mask_rotate & bond_mask[:, None]  # (B, N)
    p = pos
    for b in range(bond_u.shape[0]):
        u = bond_u[b : b + 1]
        v = bond_v[b : b + 1]
        pu = p.index_select(1, u)[:, 0]  # (P, 3)
        pivot = p.index_select(1, v)[:, 0]
        axis = pu - pivot
        norm = torch.linalg.norm(axis, dim=-1, keepdim=True)
        unit = axis / torch.clamp(norm, min=1e-12)
        rot = axis_angle_to_matrix(unit * torsion_updates[:, b : b + 1])  # (P, 3, 3)
        rotated = torch.einsum("pni,pji->pnj", p - pivot[:, None], rot) + pivot[:, None]
        p = torch.where(keep_all[b][None, :, None], rotated, p)
    return p


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


def rotatable_bond_mask(
    num_atoms: int, bonds: Sequence[Tuple[int, int]]
) -> Tuple[np.ndarray, np.ndarray]:
    """Find rotatable bonds on the host (reference ``utils/torsion.py:15-45``).

    A bond is rotatable iff removing it disconnects the molecular graph and
    the smallest resulting component has more than one atom; the moved side
    is that component. Returns ``edge_mask`` (2 * n_bonds,) over the
    interleaved directed edges [(i->j), (j->i), ...] and ``mask_rotate``
    (n_rotatable, num_atoms), rows in directed-edge order.
    """
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
            smaller = sorted(comps, key=len)[0]  # stable: first-found on ties
            if len(smaller) > 1:
                if i in smaller:
                    rotated1 = smaller  # directed edge (j -> i) moves i's side
                else:
                    rotated0 = smaller  # directed edge (i -> j) moves j's side
        to_rotate.append(rotated0)
        to_rotate.append(rotated1)

    edge_mask = np.array([len(l) > 0 for l in to_rotate], dtype=bool)
    mask_rotate = np.zeros((int(edge_mask.sum()), num_atoms), dtype=bool)
    idx = 0
    for l in to_rotate:
        if l:
            mask_rotate[idx, np.asarray(l, dtype=int)] = True
            idx += 1
    return edge_mask, mask_rotate
