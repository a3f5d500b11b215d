"""The port's chemistry I/O (``diffdock_tpu_torch/data/chem.py``) vs the JAX
package's on the CPU.

Every ligand SDF of ``data/e2e_synth/`` and a fixed sample of 20 receptor
PDBs go through both parsers: the same fields, coordinates equal bit for
bit. The port's ring basis (plain Python) is held against networkx's on
those ligands and on hand-built ring systems: per-atom ring counts and
ring-size flags equal wherever networkx's minimum cycle basis is unique,
the multiset of ring sizes wherever it is not (cubane, bicyclo[2.2.2]octane).
Implicit H counts are equal exactly.
"""

from pathlib import Path

import networkx as nx
import numpy as np
import pytest
import torch

from diffdock_tpu.data import chem as jchem
from diffdock_tpu_torch.data import chem

REPO = Path(__file__).resolve().parent.parent
SYNTH = REPO / "data" / "e2e_synth"
NAMES = sorted(p.name for p in SYNTH.glob("syn*"))
# every eighth receptor and the largest (1547 residues): 20 PDBs
PDB_SAMPLE = sorted(set(NAMES[::8]) | {"syn045_l8r1547"})


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ligand(name):
    return SYNTH / name / f"{name}_ligand.sdf"


def _protein(name):
    return SYNTH / name / f"{name}_protein_processed.pdb"


def _same_molecule(a, b):
    assert a.elements == b.elements and a.bonds == b.bonds and a.charges == b.charges
    assert a.name == b.name
    assert a.coords.dtype == b.coords.dtype and np.array_equal(a.coords, b.coords)


def test_e2e_synth_has_the_expected_complexes():
    assert len(NAMES) == 150 and len(PDB_SAMPLE) == 20


def test_sdf_parse_and_write_match_jax_on_every_ligand():
    for name in NAMES:
        text = _ligand(name).read_text()
        ours, ref = chem.parse_sdf(text), jchem.parse_sdf(text)
        assert len(ours) == len(ref) == 1
        _same_molecule(ours[0], ref[0])
        _same_molecule(chem.read_molecule_file(str(_ligand(name))),
                       jchem.read_molecule_file(str(_ligand(name))))
        heavy, jheavy = ours[0].remove_hs(), ref[0].remove_hs()
        _same_molecule(heavy, jheavy)
        coords = heavy.coords + np.float32(0.123)
        props = {"confidence": "-1.2345"}
        assert chem.write_sdf(heavy, coords, props) == jchem.write_sdf(jheavy, coords, props)
        # a written SDF parses back to the same topology
        back = chem.parse_sdf(chem.write_sdf(heavy, coords, props))[0]
        assert back.elements == heavy.elements and back.bonds == heavy.bonds
        np.testing.assert_allclose(back.coords, coords, rtol=0, atol=5e-5)


def test_sdf_records_with_blank_headers_and_charges():
    mol = chem.Molecule(["C", "N", "O"], np.array([[0, 0, 0], [1.4, 0, 0], [2.1, 1.1, 0]], np.float32),
                        [(0, 1, 1), (1, 2, 2)], [0, 1, -1], name="")
    text = chem.write_sdf(mol) * 2
    ours, ref = chem.parse_sdf(text), jchem.parse_sdf(text)
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref):
        _same_molecule(a, b)
        assert a.charges == [0, 1, -1]


@pytest.mark.parametrize("name", PDB_SAMPLE)
def test_pdb_parse_matches_jax(name):
    ours = chem.read_pdb_file(str(_protein(name)))
    ref = jchem.read_pdb_file(str(_protein(name)))
    assert len(ours.residues) == len(ref.residues) > 0
    for a, b in zip(ours.residues, ref.residues):
        assert (a.name, a.chain, a.resseq, a.icode) == (b.name, b.chain, b.resseq, b.icode)
        assert list(a.atoms) == list(b.atoms) and a.elements == b.elements
        for k in a.atoms:
            assert np.array_equal(a.atoms[k], b.atoms[k]) and a.atoms[k].dtype == b.atoms[k].dtype
    assert ours.chains() == ref.chains()
    assert ours.sequence() == ref.sequence()
    assert np.array_equal(ours.ca_coords(), ref.ca_coords())


def test_pdb_models_altlocs_and_selenomethionine():
    lines = [
        "MODEL        1",
        "ATOM      1  N   ALA A   1       0.000   0.000   0.000  1.00  0.00           N",
        "ATOM      2  CA AALA A   1       1.000   0.000   0.000  1.00  0.00           C",
        "ATOM      3  CA BALA A   1       9.000   0.000   0.000  1.00  0.00           C",
        "HETATM    4 SE   MSE A   2       2.000   1.000   0.000  1.00  0.00          SE",
        "HETATM    5  CA  MSE A   2       3.000   1.000   0.000  1.00  0.00           C",
        "HETATM    6  O   HOH A   3       5.000   1.000   0.000  1.00  0.00           O",
        "ENDMDL",
        "MODEL        2",
        "ATOM      7  CA  GLY B   1       7.000   0.000   0.000  1.00  0.00           C",
        "ENDMDL",
    ]
    text = "\n".join(lines) + "\n"
    for model in (1, 2):
        ours, ref = chem.parse_pdb(text, model=model), jchem.parse_pdb(text, model=model)
        assert [(r.name, r.chain, list(r.atoms)) for r in ours.residues] == \
            [(r.name, r.chain, list(r.atoms)) for r in ref.residues]
        assert ours.sequence() == ref.sequence()


def test_ligand_pdb_read_and_write_match_jax(tmp_path):
    mol = chem.parse_sdf(_ligand(NAMES[3]).read_text())[0].remove_hs()
    jmol = jchem.parse_sdf(_ligand(NAMES[3]).read_text())[0].remove_hs()
    text = chem.write_pdb_ligand(mol)
    assert text == jchem.write_pdb_ligand(jmol)
    # with CONECT records, and without them (bonds perceived by distance)
    no_conect = "\n".join(ln for ln in text.splitlines() if not ln.startswith("CONECT")) + "\n"
    for t in (text, no_conect):
        _same_molecule(chem.parse_pdb_ligand(t, name="x"), jchem.parse_pdb_ligand(t, name="x"))
    path = tmp_path / "lig.pdb"
    path.write_text(text)
    _same_molecule(chem.read_molecule_file(str(path)), jchem.read_molecule_file(str(path)))
    with pytest.raises(ValueError, match="unsupported molecule format"):
        chem.read_molecule_file(str(tmp_path / "lig.mol2"))


def _relevant_cycle_count(n, edges, max_len):
    """How many relevant cycles (those not a GF(2) sum of shorter cycles)
    the graph has up to ``max_len`` atoms; the minimum cycle basis is
    unique exactly when this equals its size."""
    g = nx.Graph()
    g.add_nodes_from(range(n))
    g.add_edges_from(edges)
    index = {frozenset(e): i for i, e in enumerate(g.edges)}

    def vec(cycle):
        v = 0
        for a, b in zip(cycle, cycle[1:] + cycle[:1]):
            v ^= 1 << index[frozenset((a, b))]
        return v

    cycles = sorted((vec(c), len(c)) for c in nx.simple_cycles(g, length_bound=max_len))
    by_len = {}
    for v, ln in cycles:
        by_len.setdefault(ln, []).append(v)
    basis = {}  # GF(2) row echelon of the cycles shorter than the current length
    relevant = 0
    for ln in sorted(by_len):
        for v in by_len[ln]:
            r = v
            while r:
                top = r.bit_length() - 1
                if top not in basis:
                    break
                r ^= basis[top]
            relevant += r != 0
        for v in by_len[ln]:
            r = v
            while r:
                top = r.bit_length() - 1
                if top not in basis:
                    basis[top] = r
                    break
                r ^= basis[top]
    return relevant


def _networkx_rings(n, edges):
    g = nx.Graph()
    g.add_nodes_from(range(n))
    g.add_edges_from(edges)
    return nx.minimum_cycle_basis(g)


def _check_rings(n, bonds):
    mol = chem.Molecule(["C"] * n, np.zeros((n, 3), np.float32), [(i, j, 1) for i, j in bonds], [0] * n)
    rings = _networkx_rings(n, bonds)
    ours_rings = chem.minimum_cycle_basis(n, bonds)
    assert sorted(len(r) for r in ours_rings) == sorted(len(r) for r in rings)
    num, sizes = chem.ring_membership(mol)
    max_len = max((len(r) for r in rings), default=0)
    unique = _relevant_cycle_count(n, bonds, max_len) == len(rings) if rings else True
    if unique:
        jnum, jsizes = jchem.ring_membership(mol)
        np.testing.assert_array_equal(num, jnum)
        for s in range(3, 9):
            np.testing.assert_array_equal(sizes[s], jsizes[s])
    return unique


def _ring(atoms):
    return [(atoms[i], atoms[(i + 1) % len(atoms)]) for i in range(len(atoms))]


HAND_BUILT = {
    "benzene": (6, _ring(list(range(6)))),
    "naphthalene": (10, _ring(list(range(6))) + [(5, 6), (6, 7), (7, 8), (8, 9), (9, 4)]),
    "spiro[4.5]decane": (10, _ring([0, 1, 2, 3, 4]) + _ring([0, 5, 6, 7, 8, 9])),
    "norbornane": (7, [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 0), (0, 6), (6, 3)]),
    "bicyclo[2.2.2]octane": (8, [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 0), (0, 6), (6, 7),
                                 (7, 3)]),
    "cubane": (8, _ring([0, 1, 2, 3]) + _ring([4, 5, 6, 7]) + [(i, i + 4) for i in range(4)]),
}


@pytest.mark.parametrize("name", sorted(HAND_BUILT))
def test_ring_membership_on_hand_built_ring_systems(name):
    n, bonds = HAND_BUILT[name]
    unique = _check_rings(n, bonds)
    # the bases of cubane and bicyclo[2.2.2]octane are not unique ...
    assert unique == (name not in ("cubane", "bicyclo[2.2.2]octane"))
    # ... and the port still picks networkx's, ring by ring
    assert sorted(map(sorted, chem.minimum_cycle_basis(n, bonds))) == \
        sorted(map(sorted, _networkx_rings(n, bonds)))


def test_ring_basis_matches_networkx_on_every_ligand():
    """On the e2e_synth ligands (three- and four-membered ring systems,
    many of them fused; the basis of each is unique) the port's basis is
    networkx's, ring by ring: the featurizer's ring features depend on
    it."""
    n_unique = 0
    for name in NAMES:
        mol = chem.parse_sdf(_ligand(name).read_text())[0].remove_hs()
        jmol = jchem.parse_sdf(_ligand(name).read_text())[0].remove_hs()
        num, sizes = chem.ring_membership(mol)
        jnum, jsizes = jchem.ring_membership(jmol)
        np.testing.assert_array_equal(num, jnum)
        for s in range(3, 9):
            np.testing.assert_array_equal(sizes[s], jsizes[s])
        assert sorted(map(sorted, chem.minimum_cycle_basis(mol.num_atoms, [b[:2] for b in mol.bonds]))) \
            == sorted(map(sorted, _networkx_rings(mol.num_atoms, [b[:2] for b in mol.bonds])))
        np.testing.assert_array_equal(chem.implicit_h_counts(mol), jchem.implicit_h_counts(jmol))
        n_unique += _check_rings(mol.num_atoms, [b[:2] for b in mol.bonds])
    assert n_unique == len(NAMES)


def test_implicit_h_counts_with_charges_and_aromatic_bonds():
    mol = chem.Molecule(["N", "C", "O", "S", "C", "C", "P", "Cl"],
                        np.zeros((8, 3), np.float32),
                        [(0, 1, 4), (1, 4, 4), (4, 5, 4), (5, 0, 4), (1, 2, 2), (2, 3, 1), (5, 6, 1),
                         (6, 7, 1)],
                        [1, 0, -1, 1, 0, 0, -1, 0])
    jmol = jchem.Molecule(mol.elements, mol.coords, mol.bonds, mol.charges)
    np.testing.assert_array_equal(chem.implicit_h_counts(mol), jchem.implicit_h_counts(jmol))


def test_sdf_coordinates_wider_than_v2000_fields_go_to_v3000_and_parse_back():
    """A pose far out (a coordinate that %10.4f cannot hold in ten columns)
    is written as V3000, continuation lines included, and parses back to
    the same atoms, bonds, charges and coordinates; a pose that fits stays
    V2000."""
    mol = chem.Molecule(["C", "N", "O", "Cl"],
                        np.array([[0, 0, 0], [1.4, 0, 0], [2.1, 1.1, 0], [-1.7, 0.2, 0.1]], np.float32),
                        [(0, 1, 1), (1, 2, 2), (0, 3, 1)], [0, 1, -1, 0], name="far")
    assert "V2000" in chem.write_sdf(mol, mol.coords + np.float32(9999.0))
    for far in ([1519147.625, 13991.0, 5.1], [2894615.5, -10046652.0, -28075.2], [1e30, -3e38, 0.5]):
        coords = mol.coords + np.asarray(far, np.float32)
        text = chem.write_sdf(mol, coords, {"confidence": "-64.68"})
        assert "V3000" in text and "V2000" not in text
        assert max(len(ln) for ln in text.splitlines()) <= 80
        back = chem.parse_sdf(text + text)
        assert len(back) == 2
        for b in back:
            assert b.name == "far" and b.elements == mol.elements and b.bonds == mol.bonds
            assert b.charges == mol.charges
            np.testing.assert_allclose(b.coords, coords, rtol=1e-6, atol=5e-5)
        assert text.split("> <confidence>\n", 1)[1].split("\n", 1)[0] == "-64.68"
