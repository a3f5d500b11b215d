"""Symmetry-corrected heavy-atom RMSD (port of ``diffdock_tpu/eval/rmsd.py``).

As in the JAX package, the RMSD of a pose is the least RMSD over the
element-preserving automorphisms of the molecule's bond graph (the
reference's spyrmsd), with at most 10,000 automorphisms and 10 s of
search. The JAX package enumerates them with networkx's VF2
``GraphMatcher``; networkx is not on the card's machine, so
:func:`molecular_automorphisms` is a backtracking search of its own. It
finds the same set of permutations, in another order: where a cap cuts the
search short, the two packages keep different subsets.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np


def simple_rmsd(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.sum((a - b) ** 2, axis=1))))


class _Stop(Exception):
    pass


def _refined_colors(elements: Sequence[str], adj: List[set], loops: set) -> List[int]:
    """Colour refinement of the bond graph: start from (element, degree,
    self-loop) and split by the multiset of neighbour colours until stable.
    The colours depend on the graph only, not on the atom numbering, so
    every automorphism maps an atom to one of its own colour."""
    sig = [(el, len(adj[v]), v in loops) for v, el in enumerate(elements)]
    n_classes = -1
    while True:
        labels = {s: i for i, s in enumerate(sorted(set(sig)))}
        col = [labels[s] for s in sig]
        if len(labels) == n_classes:
            return col
        n_classes = len(labels)
        sig = [(col[v], tuple(sorted(col[u] for u in adj[v]))) for v in range(len(col))]


def _search_order(adj: List[set], col: List[int]) -> List[int]:
    """Atoms in breadth-first order, each component from an atom of its
    rarest colour, so that every atom but a component's first has a
    neighbour placed before it."""
    n = len(adj)
    size = {}
    for c in col:
        size[c] = size.get(c, 0) + 1
    seen, order = [False] * n, []
    for start in sorted(range(n), key=lambda v: (size[col[v]], v)):
        if seen[start]:
            continue
        seen[start] = True
        queue = [start]
        while queue:
            v = queue.pop(0)
            order.append(v)
            for u in sorted(adj[v]):
                if not seen[u]:
                    seen[u] = True
                    queue.append(u)
    return order


def molecular_automorphisms(
    elements: Sequence[str],
    bonds: Sequence[Tuple[int, int]],
    max_isomorphisms: int = 10000,
    time_budget_s: float = 10.0,
) -> List[np.ndarray]:
    """Element-preserving graph automorphisms as index permutations
    (``perm[src] = dst``), at most ``max_isomorphisms`` of them, searched
    for at most ``time_budget_s`` seconds; the identity when none is found."""
    n = len(elements)
    adj: List[set] = [set() for _ in range(n)]
    loops = set()
    for i, j in bonds:
        if i == j:
            loops.add(i)
        else:
            adj[i].add(j)
            adj[j].add(i)
    col = _refined_colors(elements, adj, loops)
    order = _search_order(adj, col)
    pos = {v: k for k, v in enumerate(order)}
    back = [[u for u in adj[v] if pos[u] < pos[v]] for v in order]
    by_colour: dict = {}
    for v in range(n):
        by_colour.setdefault(col[v], []).append(v)

    mapping, used = [-1] * n, [False] * n
    perms: List[np.ndarray] = []
    t0 = time.time()

    def extend(k: int) -> None:
        if k == n:
            perms.append(np.asarray(mapping, dtype=np.int64))
            if len(perms) >= max_isomorphisms or time.time() - t0 > time_budget_s:
                raise _Stop
            return
        v, prev = order[k], back[k]
        cands = (sorted(adj[mapping[prev[0]]]) if prev else by_colour[col[v]])
        for c in cands:
            if used[c] or col[c] != col[v]:
                continue
            # the images of v's placed neighbours are exactly c's placed neighbours
            if not all(mapping[u] in adj[c] for u in prev):
                continue
            if sum(used[x] for x in adj[c]) != len(prev):
                continue
            mapping[v], used[c] = c, True
            extend(k + 1)
            mapping[v], used[c] = -1, False

    try:
        extend(0)
    except _Stop:
        pass
    if not perms:
        perms = [np.arange(n)]
    return perms


def qcp_rmsd(a: np.ndarray, b: np.ndarray) -> float:
    """Least RMSD after optimal superposition, from the largest eigenvalue
    of the quaternion characteristic polynomial's key matrix (Theobald
    2005; the reference vendors spyrmsd's ``qcp.py``)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    n = a.shape[0]
    ac = a - a.mean(0)
    bc = b - b.mean(0)
    ga = (ac * ac).sum()
    gb = (bc * bc).sum()
    M = ac.T @ bc  # (3, 3)
    Sxx, Sxy, Sxz = M[0]
    Syx, Syy, Syz = M[1]
    Szx, Szy, Szz = M[2]
    K = np.array([
        [Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx],
        [Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz],
        [Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy],
        [Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz],
    ])
    lam = float(np.linalg.eigvalsh(K)[-1])
    msd = max((ga + gb - 2.0 * lam) / n, 0.0)
    return float(np.sqrt(msd))


def hungarian_rmsd(a: np.ndarray, b: np.ndarray, elements: Sequence[str]) -> float:
    """RMSD after re-assigning, within each element, the atoms of ``b`` to
    those of ``a`` by a linear sum assignment over squared distances (the
    reference vendors spyrmsd's ``hungarian.py``)."""
    from scipy.optimize import linear_sum_assignment

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    elements = np.asarray(elements)
    total, n = 0.0, a.shape[0]
    for el in np.unique(elements):
        idx = np.flatnonzero(elements == el)
        cost = ((a[idx][:, None] - b[idx][None]) ** 2).sum(-1)
        ri, ci = linear_sum_assignment(cost)
        total += cost[ri, ci].sum()
    return float(np.sqrt(total / n))


def symmetry_rmsd(
    ref_coords: np.ndarray,
    pose_coords: np.ndarray,
    elements: Sequence[str],
    bonds: Sequence[Tuple[int, int]],
    perms: Optional[List[np.ndarray]] = None,
    time_budget_s: float = 10.0,
):
    """Least RMSD of each pose to the reference over the molecule's
    automorphisms; ``perms`` reuses them across poses of one molecule.
    ``pose_coords`` (N, 3) gives a float, (P, N, 3) a (P,) array."""
    if perms is None:
        perms = molecular_automorphisms(elements, bonds, time_budget_s=time_budget_s)
    single = pose_coords.ndim == 2
    poses = pose_coords[None] if single else pose_coords
    ref_perm = ref_coords[np.stack(perms)]  # (M, N, 3)
    diff = poses[:, None, :, :] - ref_perm[None, :, :, :]
    rmsds = np.sqrt(np.mean(np.sum(diff**2, axis=-1), axis=-1))  # (P, M)
    best = rmsds.min(axis=1)
    return float(best[0]) if single else best
