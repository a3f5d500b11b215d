"""The port's automorphism search replays networkx's VF2 order, so where
the 10,000 cap cuts the search both packages keep the same permutations
and give the same symmetry RMSD.

The graphs have more automorphisms than the cap: a chain of five carbons
with a CF3 on each (25 atoms, 2 x 6^5 = 15,552) and the complete bipartite
graph K5,5 of carbons (10 atoms, 2 x 5! x 5! = 28,800). The first 10,000
permutations must equal networkx's list in order, and ``symmetry_rmsd``
must equal the JAX package's to 1e-9 A in float64 over 20 poses drawn from
``numpy.random.default_rng(0)`` (the reference coordinates N(0, 3 A), each
pose the reference under a random automorphism plus N(0, 0.3 A) noise).
Both searches get an unbounded time budget: the 10 s budget is spent at
each package's own speed, the one place where the two may differ.
"""

import itertools

import networkx as nx
import numpy as np
import pytest
from networkx.algorithms.isomorphism import GraphMatcher, categorical_node_match

from diffdock_tpu.eval import rmsd as jrmsd
from diffdock_tpu_torch.eval import rmsd

NO_BUDGET = 1e9


def cf3_chain():
    elements, bonds = ["C"] * 5, [(i, i + 1) for i in range(4)]
    for c in range(5):
        b = len(elements)
        elements += ["C", "F", "F", "F"]
        bonds += [(c, b), (b, b + 1), (b, b + 2), (b, b + 3)]
    return elements, bonds


def k55():
    return ["C"] * 10, [(i, 5 + j) for i in range(5) for j in range(5)]


def random_automorphism(name, rng):
    """A uniformly drawn automorphism of the graph, built from its group."""
    if name == "cf3_chain":
        perm = np.arange(25)
        if rng.random() < 0.5:  # reverse the chain and its groups with it
            for c in range(5):
                perm[c] = 4 - c
                perm[5 + 4 * c : 9 + 4 * c] = np.arange(5 + 4 * (4 - c), 9 + 4 * (4 - c))
        for c in range(5):
            fs = 6 + 4 * c + np.arange(3)
            perm[fs] = perm[fs][rng.permutation(3)]
        return perm
    left, right = rng.permutation(5), 5 + rng.permutation(5)
    return np.concatenate([right, left]) if rng.random() < 0.5 else np.concatenate([left, right])


GRAPHS = {"cf3_chain": cf3_chain, "k55": k55}


def networkx_order(elements, bonds, n):
    g = nx.Graph()
    for i, el in enumerate(elements):
        g.add_node(i, element=el)
    g.add_edges_from(bonds)
    out = []
    for mapping in GraphMatcher(g, g, node_match=categorical_node_match("element", None)).isomorphisms_iter():
        out.append([mapping[i] for i in range(len(elements))])
        if len(out) == n:
            break
    return out


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_first_10000_automorphisms_are_networkx_order(name):
    elements, bonds = GRAPHS[name]()
    ours = rmsd.molecular_automorphisms(elements, bonds, time_budget_s=NO_BUDGET)
    assert len(ours) == 10000
    assert [p.tolist() for p in ours] == networkx_order(elements, bonds, 10000)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_symmetry_rmsd_equals_jax_past_the_cap(name):
    elements, bonds = GRAPHS[name]()
    edges = {frozenset(b) for b in bonds}
    rng = np.random.default_rng(0)
    ref = rng.normal(0.0, 3.0, (len(elements), 3))
    poses = []
    for _ in range(20):
        perm = random_automorphism(name, rng)
        assert {frozenset((perm[i], perm[j])) for i, j in bonds} == edges
        poses.append(ref[perm] + rng.normal(0.0, 0.3, ref.shape))
    poses = np.stack(poses)
    ours = rmsd.symmetry_rmsd(ref, poses, elements, bonds, time_budget_s=NO_BUDGET)
    theirs = jrmsd.symmetry_rmsd(ref, poses, elements, bonds, time_budget_s=NO_BUDGET)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-9)


def _random_graph(rng, n):
    bonds = [tuple(int(x) for x in rng.integers(0, n, 2)) for _ in range(rng.integers(0, 2 * n + 1))]
    return list(rng.choice(["C", "N", "O"], n, p=[0.6, 0.3, 0.1])), bonds


@pytest.mark.parametrize("seed", range(4))
def test_order_on_random_graphs_with_loops_and_repeats(seed):
    """Small random graphs, with self-loops, repeated and reversed bonds and
    isolated atoms: the whole sequence in networkx's order."""
    rng = np.random.default_rng(100 + seed)
    for n in itertools.chain(range(0, 9), range(9, 13)):
        elements, bonds = _random_graph(rng, n)
        ours = rmsd.molecular_automorphisms(elements, bonds, max_isomorphisms=2000, time_budget_s=NO_BUDGET)
        ref = networkx_order(elements, bonds, 2000) or [list(range(n))]
        assert [p.tolist() for p in ours] == ref
