"""Symmetry-corrected heavy-atom RMSD (port of ``diffdock_tpu/eval/rmsd.py``).

As in the JAX package, the RMSD of a pose is the least RMSD over the
element-preserving automorphisms of the molecule's bond graph (the
reference's spyrmsd), with at most 10,000 automorphisms and 10 s of
search. The JAX package enumerates them with networkx's VF2
``GraphMatcher``; networkx is not on the card's machine, so
:func:`molecular_automorphisms` replays that matcher in plain Python and
yields the same permutations in the same order: where the 10,000 cap cuts
the search short, the two packages keep the same ones.
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np


def simple_rmsd(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.sum((a - b) ** 2, axis=1))))


class _Stop(Exception):
    pass


class _VF2:
    """A replay of networkx's VF2 ``GraphMatcher`` (``isomorphvf2.py``) for
    the automorphisms of one graph with categorical node labels, as
    ``GraphMatcher(g, g, node_match=categorical_node_match("element",
    None)).isomorphisms_iter()`` runs it. The state is networkx's own:
    the insertion-ordered ``core`` and ``inout`` dicts, the terminal-set
    updates through a ``set`` built in the same order (so it iterates in the
    same order), the candidate pairs ``T1 x {min T2}`` (or every unmapped
    node against the least unmapped one) in node order, and the same
    feasibility rules. So the mappings come in networkx's order."""

    def __init__(self, labels: Sequence, adj: List[dict], loops: List[int]):
        self.labels, self.adj, self.loops = labels, adj, loops
        self.n = len(adj)
        self.core_1: dict = {}
        self.core_2: dict = {}
        self.inout_1: dict = {}
        self.inout_2: dict = {}

    def _candidates(self):
        core_1, core_2 = self.core_1, self.core_2
        t1 = [v for v in self.inout_1 if v not in core_1]
        t2 = [v for v in self.inout_2 if v not in core_2]
        if t1 and t2:
            other = min(t2)
            return [(v, other) for v in t1]
        other = min(v for v in range(self.n) if v not in core_2)
        return [(v, other) for v in range(self.n) if v not in core_1]

    def _feasible(self, n1: int, n2: int) -> bool:
        if self.loops[n1] != self.loops[n2]:
            return False
        core_1, core_2 = self.core_1, self.core_2
        a1, a2 = self.adj[n1], self.adj[n2]
        for u in a1:
            if u in core_1 and core_1[u] not in a2:
                return False
        for u in a2:
            if u in core_2 and core_2[u] not in a1:
                return False
        in1, in2 = self.inout_1, self.inout_2
        if (sum(1 for u in a1 if u in in1 and u not in core_1)
                != sum(1 for u in a2 if u in in2 and u not in core_2)):
            return False
        if sum(1 for u in a1 if u not in in1) != sum(1 for u in a2 if u not in in2):
            return False
        return self.labels[n1] == self.labels[n2]

    @staticmethod
    def _grow(inout: dict, core: dict, adj: List[dict], node: int, depth: int) -> None:
        if node not in inout:
            inout[node] = depth
        new_nodes = set()
        for v in core:
            new_nodes.update([u for u in adj[v] if u not in core])
        for v in new_nodes:
            if v not in inout:
                inout[v] = depth

    def run(self, found) -> None:
        """Calls ``found(core_1)`` for every automorphism, in networkx's
        order, until ``found`` raises ``_Stop``."""
        core_1, core_2 = self.core_1, self.core_2
        if len(core_1) == self.n:
            found(core_1)
            return
        for n1, n2 in self._candidates():
            if not self._feasible(n1, n2):
                continue
            core_1[n1], core_2[n2] = n2, n1
            depth = len(core_1)
            self._grow(self.inout_1, core_1, self.adj, n1, depth)
            self._grow(self.inout_2, core_2, self.adj, n2, depth)
            self.run(found)
            del core_1[n1], core_2[n2]
            for inout in (self.inout_1, self.inout_2):
                for v in [v for v, d in inout.items() if d == depth]:
                    del inout[v]


def molecular_automorphisms(
    elements: Sequence[str],
    bonds: Sequence[Tuple[int, int]],
    max_isomorphisms: int = 10000,
    time_budget_s: float = 10.0,
) -> List[np.ndarray]:
    """Element-preserving graph automorphisms as index permutations
    (``perm[src] = dst``), in the order networkx's VF2 matcher yields them
    for the graph built by adding nodes ``0..n-1`` and then ``bonds``. As in
    the JAX package, each is appended and the search stops once
    ``max_isomorphisms`` are kept or, after a permutation, once more than
    ``time_budget_s`` seconds have passed; the identity when none is found.
    The wall-clock budget is the one place where the two packages can
    differ: each spends it at its own speed, so a search that the budget
    cuts keeps a different prefix of the same sequence."""
    n = len(elements)
    adj: List[dict] = [{} for _ in range(n)]
    loops = [0] * n
    for i, j in bonds:
        adj[i][j] = adj[j][i] = True
        if i == j:
            loops[i] = 1
    perms: List[np.ndarray] = []
    t0 = time.time()

    def found(core: dict) -> None:
        perm = np.empty(n, dtype=np.int64)
        for src, dst in core.items():
            perm[src] = dst
        perms.append(perm)
        if len(perms) >= max_isomorphisms or time.time() - t0 > time_budget_s:
            raise _Stop

    limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(limit, 2 * n + 100))
    try:
        _VF2(list(elements), adj, loops).run(found)
    except _Stop:
        pass
    finally:
        sys.setrecursionlimit(limit)
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
