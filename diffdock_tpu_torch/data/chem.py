"""Chemistry I/O without RDKit (port of ``diffdock_tpu/data/chem.py``).

* SDF/MOL reader and writer (atoms, bonds, charges, 3D coords): V2000, and
  V3000 where a molecule does not fit V2000's fixed-width fields (a
  coordinate outside -9999.9999..99999.9999 A, more than 999 atoms or
  bonds); and a small-molecule PDB reader and writer;
* a light perception pass (rings up to size 8, aromaticity from bond
  blocks, implicit H counts from standard valences) feeding the
  featurizer's categorical vocabularies;
* a PDB reader giving per-residue atoms for the receptor graph.

The ring basis is computed here in plain Python (networkx is not a
dependency of the port), choosing the same basis networkx does. RDKit is
not used: other ligand formats raise as they do in the JAX package without
RDKit.
"""

from __future__ import annotations

import dataclasses
import os
from heapq import heappop, heappush
from itertools import count
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# standard valences for implicit-H estimation (neutral atoms)
_DEFAULT_VALENCE = {
    "H": 1, "B": 3, "C": 4, "N": 3, "O": 2, "F": 1, "Si": 4, "P": 3,
    "S": 2, "Cl": 1, "Br": 1, "I": 1,
}

_ELEMENTS = [
    "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne", "Na", "Mg", "Al",
    "Si", "P", "S", "Cl", "Ar", "K", "Ca", "Sc", "Ti", "V", "Cr", "Mn",
    "Fe", "Co", "Ni", "Cu", "Zn", "Ga", "Ge", "As", "Se", "Br", "Kr",
    "Rb", "Sr", "Y", "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd",
    "In", "Sn", "Sb", "Te", "I", "Xe",
]
ATOMIC_NUM = {el: i + 1 for i, el in enumerate(_ELEMENTS)}


@dataclasses.dataclass
class Molecule:
    """A small molecule with explicit topology and one conformer."""

    elements: List[str]
    coords: np.ndarray  # (N, 3) float32
    bonds: List[Tuple[int, int, int]]  # (i, j, order); order 4 = aromatic
    charges: List[int]
    name: str = ""

    @property
    def num_atoms(self) -> int:
        return len(self.elements)

    def heavy_atom_indices(self) -> List[int]:
        return [i for i, e in enumerate(self.elements) if e != "H"]

    def remove_hs(self) -> "Molecule":
        """Drop explicit hydrogens (reference remove_hs default True,
        ``utils/parsing.py:336``)."""
        keep = self.heavy_atom_indices()
        remap = {old: new for new, old in enumerate(keep)}
        bonds = [
            (remap[i], remap[j], o)
            for i, j, o in self.bonds
            if i in remap and j in remap
        ]
        return Molecule(
            elements=[self.elements[i] for i in keep],
            coords=self.coords[keep],
            bonds=bonds,
            charges=[self.charges[i] for i in keep],
            name=self.name,
        )


def _parse_v3000(lines: List[str], name: str) -> Optional[Molecule]:
    """One V3000 record from its counts line on: the ``M  V30`` lines (a
    line ending in ``-`` continues on the next) of the atom and bond blocks,
    with ``CHG=`` on the atoms."""
    v30, part = [], ""
    for ln in lines[1:]:
        if ln.startswith("M  END"):
            break
        if not ln.startswith("M  V30 "):
            continue
        part += ln[7:]
        if part.endswith("-"):
            part = part[:-1]
            continue
        v30.append(part)
        part = ""
    elements, coords, charges, bonds, block = [], [], [], [], None
    for ln in v30:
        fields = ln.split()
        if fields[:1] in (["BEGIN"], ["END"]):
            block = fields[1] if fields[0] == "BEGIN" else None
        elif block == "ATOM":
            elements.append(fields[1])
            coords.append(tuple(float(v) for v in fields[2:5]))
            chg = [int(f[4:]) for f in fields[6:] if f.startswith("CHG=")]
            charges.append(chg[0] if chg else 0)
        elif block == "BOND":
            bonds.append((int(fields[2]) - 1, int(fields[3]) - 1, int(fields[1])))
    if not elements:
        return None
    return Molecule(elements=elements, coords=np.asarray(coords, np.float32).reshape(-1, 3),
                    bonds=bonds, charges=charges, name=name)


def parse_sdf(text: str) -> List[Molecule]:
    """Parse an SDF/MOL file (V2000 or V3000). Multiple records separated by
    $$$$."""
    mols = []
    for record in text.split("$$$$"):
        lines = record.splitlines()
        # locate the counts line explicitly — the title line of the 3-line
        # header is legitimately blank in many SDFs (e.g. RDKit output), so
        # stripping leading blanks would misalign the block
        ci = next(
            (i for i, ln in enumerate(lines[:12])
             if ln.rstrip().endswith(("V2000", "V3000"))),
            None,
        )
        if ci is None:
            # counts line without the V2000 tag: fall back to the fixed
            # 3-line header after dropping record-separator blanks
            while lines and not lines[0].strip() and len(lines) > 4:
                lines = lines[1:]
        elif ci >= 3:
            lines = lines[ci - 3 :]
        else:  # header truncated by the $$$$ split; re-pad it
            lines = [""] * (3 - ci) + lines
        if len(lines) < 4:
            continue
        counts = lines[3]
        if counts.rstrip().endswith("V3000"):
            mol = _parse_v3000(lines[3:], lines[0].strip())
            if mol is not None:
                mols.append(mol)
            continue
        try:
            n_atoms = int(counts[0:3])
            n_bonds = int(counts[3:6])
        except (ValueError, IndexError):
            continue
        name = lines[0].strip()
        elements, coords, charges = [], [], []
        for i in range(n_atoms):
            ln = lines[4 + i]
            x, y, z = float(ln[0:10]), float(ln[10:20]), float(ln[20:30])
            el = ln[31:34].strip()
            coords.append((x, y, z))
            elements.append(el)
            charges.append(0)
        bonds = []
        for i in range(n_bonds):
            ln = lines[4 + n_atoms + i]
            a = int(ln[0:3]) - 1
            b = int(ln[3:6]) - 1
            order = int(ln[6:9])
            bonds.append((a, b, order))
        # properties block: charges
        for ln in lines[4 + n_atoms + n_bonds :]:
            if ln.startswith("M  CHG"):
                fields = ln.split()
                n = int(fields[2])
                for k in range(n):
                    idx = int(fields[3 + 2 * k]) - 1
                    chg = int(fields[4 + 2 * k])
                    charges[idx] = chg
            elif ln.startswith("M  END"):
                break
        mols.append(
            Molecule(
                elements=elements,
                coords=np.asarray(coords, np.float32),
                bonds=bonds,
                charges=charges,
                name=name,
            )
        )
    return mols


def write_sdf(
    mol: Molecule,
    coords: Optional[np.ndarray] = None,
    props: Optional[Dict[str, str]] = None,
) -> str:
    """Serialize one molecule with optional replacement coords: V2000, or
    V3000 where a coordinate or a count does not fit V2000's fields."""
    coords = mol.coords if coords is None else np.asarray(coords)
    lines = [mol.name, "  diffdock_tpu", ""]
    if (mol.num_atoms > 999 or len(mol.bonds) > 999
            or any(len(f"{v:10.4f}") > 10 for v in np.asarray(coords).ravel().tolist())):
        return _write_v3000(mol, coords, props, lines)
    lines.append(
        f"{mol.num_atoms:3d}{len(mol.bonds):3d}  0  0  0  0  0  0  0  0999 V2000"
    )
    for el, (x, y, z) in zip(mol.elements, coords):
        lines.append(
            f"{x:10.4f}{y:10.4f}{z:10.4f} {el:<3s} 0  0  0  0  0  0  0  0  0  0  0  0"
        )
    for i, j, o in mol.bonds:
        lines.append(f"{i + 1:3d}{j + 1:3d}{o:3d}  0")
    chg = [(i, c) for i, c in enumerate(mol.charges) if c != 0]
    for start in range(0, len(chg), 8):
        batch = chg[start : start + 8]
        lines.append(
            "M  CHG"
            + f"{len(batch):3d}"
            + "".join(f"{i + 1:4d}{c:4d}" for i, c in batch)
        )
    return _close_record(lines, props)


def _close_record(lines: List[str], props: Optional[Dict[str, str]]) -> str:
    lines.append("M  END")
    for k, v in (props or {}).items():
        lines.append(f"> <{k}>")
        lines.append(str(v))
        lines.append("")
    lines.append("$$$$")
    return "\n".join(lines) + "\n"


def _write_v3000(mol: Molecule, coords: np.ndarray, props, lines: List[str]) -> str:
    """The V3000 record of :func:`write_sdf`: free-format fields, lines of
    at most 80 characters (a longer one continues after a ``-``)."""
    body = ["BEGIN CTAB", f"COUNTS {mol.num_atoms} {len(mol.bonds)} 0 0 0", "BEGIN ATOM"]
    for k, (el, (x, y, z), c) in enumerate(zip(mol.elements, np.asarray(coords).tolist(), mol.charges)):
        body.append(f"{k + 1} {el} {x:.4f} {y:.4f} {z:.4f} 0" + (f" CHG={c}" if c else ""))
    body.append("END ATOM")
    if mol.bonds:
        body += ["BEGIN BOND"] + [f"{k + 1} {o} {i + 1} {j + 1}" for k, (i, j, o) in enumerate(mol.bonds)]
        body.append("END BOND")
    body.append("END CTAB")
    lines.append("  0  0  0     0  0            999 V3000")
    for text in body:
        while len(text) > 72:
            lines.append(f"M  V30 {text[:72]}-")
            text = text[72:]
        lines.append(f"M  V30 {text}")
    return _close_record(lines, props)


# single-bond covalent radii (A) for distance-based bond perception when a
# ligand PDB carries no CONECT records (RDKit's MolFromPDBFile does the same
# proximity perception; reference reads MOAD ligands this way,
# datasets/moad.py:464-468)
_COVALENT_RADIUS = {
    "H": 0.31, "B": 0.84, "C": 0.76, "N": 0.71, "O": 0.66, "F": 0.57,
    "Si": 1.11, "P": 1.07, "S": 1.05, "Cl": 1.02, "As": 1.19, "Se": 1.20,
    "Br": 1.20, "I": 1.39,
}


def parse_pdb_ligand(text: str, name: str = "") -> Molecule:
    """Parse a small-molecule PDB file (HETATM/ATOM + CONECT).

    Bonds come from CONECT records when present; otherwise they are
    perceived by covalent-radius proximity (|d| < r_i + r_j + 0.4 A). Bond
    orders are unknown in PDB — all single (order 1), matching what the
    reference's RDKit PDB reader yields before bond-order assignment.
    """
    elements: List[str] = []
    coords: List[Tuple[float, float, float]] = []
    serial_to_idx: Dict[int, int] = {}
    bonds_set = set()
    for ln in text.splitlines():
        rec = ln[:6]
        if rec in ("ATOM  ", "HETATM"):
            serial = int(ln[6:11])
            el = ln[76:78].strip().capitalize() if len(ln) >= 78 else ""
            if not el:
                atom_name = ln[12:16].strip()
                el = atom_name[:2].capitalize() if atom_name[:2].capitalize() in ATOMIC_NUM else atom_name[:1].upper()
            serial_to_idx[serial] = len(elements)
            elements.append(el)
            coords.append(
                (float(ln[30:38]), float(ln[38:46]), float(ln[46:54]))
            )
        elif rec == "CONECT":
            fields = [ln[i : i + 5].strip() for i in range(6, min(len(ln), 31), 5)]
            fields = [int(x) for x in fields if x]
            if len(fields) >= 2:
                a = fields[0]
                for b in fields[1:]:
                    bonds_set.add((min(a, b), max(a, b)))
    if not elements:
        raise ValueError("no atoms parsed from ligand PDB")
    xyz = np.asarray(coords, np.float32)

    bonds: List[Tuple[int, int, int]] = []
    if bonds_set:
        for a, b in sorted(bonds_set):
            if a in serial_to_idx and b in serial_to_idx:
                bonds.append((serial_to_idx[a], serial_to_idx[b], 1))
    else:
        d = np.linalg.norm(xyz[:, None] - xyz[None, :], axis=-1)
        r = np.asarray([_COVALENT_RADIUS.get(e, 0.76) for e in elements])
        cut = r[:, None] + r[None, :] + 0.4
        ii, jj = np.nonzero((d < cut) & (d > 0.4))
        bonds = [(int(i), int(j), 1) for i, j in zip(ii, jj) if i < j]
    return Molecule(
        elements=elements,
        coords=xyz,
        bonds=bonds,
        charges=[0] * len(elements),
        name=name,
    )


def read_molecule_file(path: str) -> Molecule:
    """Read .sdf/.mol/.pdb (native); other formats require RDKit."""
    path_l = path.lower()
    if path_l.endswith((".sdf", ".mol")):
        with open(path) as f:
            mols = parse_sdf(f.read())
        if not mols:
            raise ValueError(f"no molecule parsed from {path}")
        return mols[0]
    if path_l.endswith(".pdb"):
        with open(path) as f:
            return parse_pdb_ligand(
                f.read(), name=os.path.basename(path).rsplit(".", 1)[0]
            )
    raise ValueError(
        f"unsupported molecule format for native parser: {path} "
        "(install rdkit for mol2/pdbqt)"
    )


def write_pdb_ligand(mol: Molecule, coords: Optional[np.ndarray] = None) -> str:
    """Serialize a small molecule as HETATM + CONECT records."""
    coords = mol.coords if coords is None else np.asarray(coords)
    lines = []
    counts: Dict[str, int] = {}
    for i, (el, (x, y, z)) in enumerate(zip(mol.elements, coords)):
        counts[el] = counts.get(el, 0) + 1
        atom_name = f"{el}{counts[el]}"[:4]
        lines.append(
            f"HETATM{i + 1:5d} {atom_name:<4s}{'LIG':>4s} A   1    "
            f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00          {el:>2s}"
        )
    nbrs: Dict[int, List[int]] = {}
    for i, j, _ in mol.bonds:
        nbrs.setdefault(i, []).append(j)
        nbrs.setdefault(j, []).append(i)
    for i in sorted(nbrs):
        for start in range(0, len(nbrs[i]), 4):
            chunk = nbrs[i][start : start + 4]
            lines.append(
                "CONECT" + f"{i + 1:5d}" + "".join(f"{j + 1:5d}" for j in chunk)
            )
    lines.append("END")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# perception (native path)
# ---------------------------------------------------------------------------


def ring_membership(mol: Molecule) -> Tuple[np.ndarray, Dict[int, np.ndarray]]:
    """Per-atom ring counts and ring-size membership flags via the smallest
    set of smallest rings (:func:`minimum_cycle_basis`)."""
    rings = minimum_cycle_basis(mol.num_atoms, [(i, j) for i, j, _ in mol.bonds])
    n = mol.num_atoms
    num_rings = np.zeros(n, np.int32)
    in_ring_of_size = {s: np.zeros(n, bool) for s in range(3, 9)}
    for ring in rings:
        size = len(ring)
        for a in ring:
            num_rings[a] += 1
            if 3 <= size <= 8:
                in_ring_of_size[size][a] = True
    return num_rings, in_ring_of_size


# A minimum cycle basis is not unique for some ring systems (cubane, fused
# rings of equal size), and the featurizer's ring counts follow the basis
# chosen. The functions below therefore make networkx's choice, not just a
# minimum basis: de Pina's algorithm as ``networkx.minimum_cycle_basis``
# runs it, with the same node, edge and set iteration orders (graphs are
# dicts of dicts in insertion order, as networkx's are) and the same
# bidirectional Dijkstra for the lifted-graph path.


def _add_edge(adj: dict, u, v) -> None:
    adj.setdefault(u, {})
    adj.setdefault(v, {})
    adj[u][v] = adj[v][u] = True


def minimum_cycle_basis(n_nodes: int, edges: Sequence[Tuple[int, int]]) -> List[List[int]]:
    """Cycles (node lists) of a minimum cycle basis of the graph on nodes
    ``0..n_nodes-1``; the basis ``networkx.minimum_cycle_basis`` returns
    for the graph built by ``add_nodes_from(range(n))`` and
    ``add_edges_from(edges)``."""
    adj: Dict[int, dict] = {v: {} for v in range(n_nodes)}
    for u, v in edges:
        _add_edge(adj, u, v)
    out: List[List[int]] = []
    for comp in _connected_components(adj):
        # the node order of networkx's subgraph view of ``comp``
        nodes = set(x for x in comp if x in adj)
        if 2 * len(nodes) < len(adj):
            order = list(nodes)
        else:
            order = [v for v in adj if v in nodes]
        out += _min_cycle_basis(adj, order, nodes)
    return out


def _connected_components(adj: dict):
    seen: set = set()
    n = len(adj)
    for v in adj:
        if v not in seen:
            c = _plain_bfs(adj, n - len(seen), v)
            seen.update(c)
            yield c


def _plain_bfs(adj: dict, n: int, source) -> set:
    seen = {source}
    nextlevel = [source]
    while nextlevel:
        thislevel = nextlevel
        nextlevel = []
        for v in thislevel:
            for w in adj[v]:
                if w not in seen:
                    seen.add(w)
                    nextlevel.append(w)
            if len(seen) == n:
                return seen
    return seen


def _sub_edges(adj: dict, order: list, nodes: set) -> list:
    """The subgraph's edges in networkx's ``G.edges`` order."""
    seen, out = set(), []
    for n in order:
        for nbr in adj[n]:
            if nbr in nodes and nbr not in seen:
                out.append((n, nbr))
        seen.add(n)
    return out


def _min_cycle_basis(adj: dict, order: list, nodes: set) -> List[List[int]]:
    edges = _sub_edges(adj, order, nodes)
    # spanning forest: Kruskal over unit weights keeps the edge order
    parent = {v: v for v in order}

    def root(v):
        while parent[v] != v:
            parent[v] = parent[parent[v]]
            v = parent[v]
        return v

    tree_edges = []
    for u, v in edges:
        ru, rv = root(u), root(v)
        if ru != rv:
            tree_edges.append((u, v))
            parent[ru] = rv
    tree_set = set(tree_edges)
    chords = set(e for e in edges if e not in tree_set) - {(v, u) for u, v in tree_edges}

    cb = []
    set_orth = [{edge} for edge in chords]
    while set_orth:
        base = set_orth.pop()
        cycle_edges = _min_cycle(adj, order, edges, base)
        cb.append([v for u, v in cycle_edges])
        set_orth = [
            (
                {e for e in orth if e not in base if e[::-1] not in base}
                | {e for e in base if e not in orth if e[::-1] not in orth}
            )
            if sum((e in orth or e[::-1] in orth) for e in cycle_edges) % 2
            else orth
            for orth in set_orth
        ]
    return cb


def _min_cycle(adj: dict, order: list, edges: list, orth: set) -> list:
    """The shortest cycle with an odd intersection with ``orth``, from the
    lifted graph (node ``u`` and its copy ``(u, 1)``)."""
    gi: dict = {}
    for u, v in edges:
        if (u, v) in orth or (v, u) in orth:
            _add_edge(gi, u, (v, 1))
            _add_edge(gi, (u, 1), v)
        else:
            _add_edge(gi, u, v)
            _add_edge(gi, (u, 1), (v, 1))
    lift = {n: _bfs_length(gi, n, (n, 1)) for n in order}
    start = min(lift, key=lift.get)
    min_path_i = _bidirectional_dijkstra(gi, start, (start, 1))
    min_path = [p if not isinstance(p, tuple) else p[0] for p in min_path_i]

    edgelist = list(zip(min_path[:-1], min_path[1:]))
    edgeset: set = set()
    for e in edgelist:
        if e in edgeset:
            edgeset.remove(e)
        elif e[::-1] in edgeset:
            edgeset.remove(e[::-1])
        else:
            edgeset.add(e)
    min_edgelist = []
    for e in edgelist:
        if e in edgeset:
            min_edgelist.append(e)
            edgeset.remove(e)
        elif e[::-1] in edgeset:
            min_edgelist.append(e[::-1])
            edgeset.remove(e[::-1])
    return min_edgelist


def _bfs_length(adj: dict, source, target) -> int:
    dist = {source: 0}
    frontier = [source]
    while frontier:
        nxt = []
        for v in frontier:
            if v == target:
                return dist[v]
            for w in adj[v]:
                if w not in dist:
                    dist[w] = dist[v] + 1
                    nxt.append(w)
        frontier = nxt
    raise ValueError(f"no path from {source} to {target}")


def _bidirectional_dijkstra(adj: dict, source, target) -> list:
    """networkx's ``bidirectional_dijkstra`` path on unit weights (its tie
    breaks decide which of several shortest cycles is returned)."""
    if source == target:
        return [source]
    dists: list = [{}, {}]
    preds: list = [{source: None}, {target: None}]

    def path(curr, direction):
        ret = []
        while curr is not None:
            ret.append(curr)
            curr = preds[direction][curr]
        return list(reversed(ret)) if direction == 0 else ret

    fringe: list = [[], []]
    seen: list = [{source: 0}, {target: 0}]
    c = count()
    heappush(fringe[0], (0, next(c), source))
    heappush(fringe[1], (0, next(c), target))
    finaldist = meetnode = None
    direction = 1
    while fringe[0] and fringe[1]:
        direction = 1 - direction
        dist, _, v = heappop(fringe[direction])
        if v in dists[direction]:
            continue
        dists[direction][v] = dist
        if v in dists[1 - direction]:
            return path(meetnode, 0) + path(preds[1][meetnode], 1)
        for w in adj[v]:
            vw_length = dist + 1
            if w in dists[direction]:
                continue
            if w not in seen[direction] or vw_length < seen[direction][w]:
                seen[direction][w] = vw_length
                heappush(fringe[direction], (vw_length, next(c), w))
                preds[direction][w] = v
                if w in seen[1 - direction]:
                    finaldist_w = vw_length + seen[1 - direction][w]
                    if finaldist is None or finaldist > finaldist_w:
                        finaldist, meetnode = finaldist_w, w
    raise ValueError(f"no path from {source} to {target}")


def implicit_h_counts(mol: Molecule) -> np.ndarray:
    """Estimate implicit+explicit H counts from standard valences."""
    n = mol.num_atoms
    bond_order_sum = np.zeros(n, np.float64)
    explicit_h = np.zeros(n, np.int32)
    aromatic_deg = np.zeros(n, np.int32)
    for i, j, o in mol.bonds:
        order = 1.5 if o == 4 else float(o)
        bond_order_sum[i] += order
        bond_order_sum[j] += order
        if o == 4:
            aromatic_deg[i] += 1
            aromatic_deg[j] += 1
        if mol.elements[j] == "H":
            explicit_h[i] += 1
        if mol.elements[i] == "H":
            explicit_h[j] += 1
    out = np.zeros(n, np.int32)
    for i, el in enumerate(mol.elements):
        val = _DEFAULT_VALENCE.get(el)
        if val is None:
            out[i] = explicit_h[i]
            continue
        # aromatic ring atoms with two aromatic bonds carry 1.5+1.5 order
        eff = int(np.ceil(bond_order_sum[i] - 1e-6))
        target = val + (mol.charges[i] if el in ("N", "P") else -mol.charges[i] if el in ("O", "S") else 0)
        out[i] = max(int(target) - eff, 0) + explicit_h[i]
    return out


# ---------------------------------------------------------------------------
# PDB receptor parsing (native ProDy replacement)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Residue:
    name: str
    chain: str
    resseq: int
    icode: str
    atoms: Dict[str, np.ndarray]  # atom name -> xyz
    elements: Dict[str, str]

    @property
    def ca(self) -> Optional[np.ndarray]:
        return self.atoms.get("CA")


@dataclasses.dataclass
class ProteinStructure:
    residues: List[Residue]

    def ca_coords(self) -> np.ndarray:
        return np.asarray(
            [r.ca for r in self.residues if r.ca is not None], np.float32
        )

    def residues_with_ca(self) -> List[Residue]:
        return [r for r in self.residues if r.ca is not None]

    def chains(self) -> List[str]:
        seen: List[str] = []
        for r in self.residues:
            if r.chain not in seen:
                seen.append(r.chain)
        return seen

    def sequence(self, chain: Optional[str] = None) -> str:
        from diffdock_tpu_torch.data.featurize import THREE_TO_ONE

        return "".join(
            THREE_TO_ONE.get(r.name, "X")
            for r in self.residues_with_ca()
            if chain is None or r.chain == chain
        )


def parse_pdb(text: str, model: int = 1) -> ProteinStructure:
    """Parse ATOM records of a PDB file into residues (first altloc wins)."""
    residues: List[Residue] = []
    index: Dict[Tuple[str, int, str], Residue] = {}
    current_model = 1
    for ln in text.splitlines():
        rec = ln[:6]
        if rec == "MODEL ":
            current_model = int(ln[10:14])
            continue
        if rec == "ENDMDL":
            current_model = current_model + 1
            continue
        if rec != "ATOM  " and rec != "HETATM":
            continue
        if current_model != model:
            continue
        if rec == "HETATM" and ln[17:20].strip() != "MSE":
            continue  # skip waters/ligands; selenomethionine treated as MET
        altloc = ln[16]
        if altloc not in (" ", "A"):
            continue
        name = ln[12:16].strip()
        resname = ln[17:20].strip()
        if resname == "MSE":
            resname = "MET"
            if name == "SE":
                name = "SD"
        chain = ln[21]
        resseq = int(ln[22:26])
        icode = ln[26]
        x, y, z = float(ln[30:38]), float(ln[38:46]), float(ln[46:54])
        element = ln[76:78].strip() if len(ln) >= 78 else name[:1]
        key = (chain, resseq, icode)
        res = index.get(key)
        if res is None or res.name != resname:
            res = Residue(resname, chain, resseq, icode, {}, {})
            index[key] = res
            residues.append(res)
        if name not in res.atoms:
            res.atoms[name] = np.asarray([x, y, z], np.float32)
            res.elements[name] = element
    return ProteinStructure(residues)


def read_pdb_file(path: str) -> ProteinStructure:
    with open(path) as f:
        return parse_pdb(f.read())
