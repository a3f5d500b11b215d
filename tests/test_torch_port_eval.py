"""The port's evaluation plane vs the JAX package's on the CPU: graph
automorphisms, symmetry-corrected RMSD, metric tables, the evaluate CLI's
artifact writer and the gnina hook.

The JAX package enumerates automorphisms with networkx's VF2 matcher; the
port replays that matcher in plain Python (networkx is not on the card's
machine), so the permutations are equal in order on every e2e_synth ligand,
on symmetric molecules, and where the cap cuts a search short
(``tests/test_torch_port_vf2.py`` holds the same past the 10,000 cap). The
RMSDs are float64 numpy in both packages and agree to 1e-10.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest

from diffdock_tpu.cli import evaluate as jevaluate
from diffdock_tpu.data.chem import read_molecule_file as jread
from diffdock_tpu.eval import gnina as jgnina
from diffdock_tpu.eval import metrics as jmetrics
from diffdock_tpu.eval import rmsd as jrmsd
from diffdock_tpu_torch.cli import evaluate
from diffdock_tpu_torch.data.chem import Molecule, read_molecule_file, write_sdf
from diffdock_tpu_torch.eval import gnina, metrics, rmsd

REPO = Path(__file__).resolve().parent.parent
SYNTH = REPO / "data" / "e2e_synth"
LIGANDS = sorted(p.name for p in SYNTH.glob("syn*"))


def _heavy(name):
    mol = read_molecule_file(str(SYNTH / name / f"{name}_ligand.sdf")).remove_hs()
    return mol, [(i, j) for i, j, _ in mol.bonds]


def _as_set(perms):
    out = {tuple(int(x) for x in p) for p in perms}
    assert len(out) == len(perms), "a permutation was found twice"
    return out


def _is_automorphism(perm, elements, bonds):
    edges = {frozenset(b) for b in bonds}
    return (sorted(perm) == list(range(len(elements)))
            and all(elements[i] == elements[perm[i]] for i in range(len(elements)))
            and {frozenset((perm[i], perm[j])) for i, j in bonds} == edges)


def _ring(n, start=0):
    return [(start + i, start + (i + 1) % n) for i in range(n)]


# symmetric graphs with known automorphism counts, all under the cap
SYMMETRIC = {
    "benzene": (["C"] * 6, _ring(6), 12),
    "pyridine": (["N"] + ["C"] * 5, _ring(6), 2),
    "cubane": (["C"] * 8, [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
                           (0, 4), (1, 5), (2, 6), (3, 7)], 48),
    # two benzenes joined by a bond (biphenyl): 2 x 2 x 2
    "biphenyl": (["C"] * 12, _ring(6) + _ring(6, 6) + [(0, 6)], 8),
    # two separate benzenes (a salt-like record): 12 x 12 x 2
    "two_benzenes": (["C"] * 12, _ring(6) + _ring(6, 6), 288),
    # neopentane heavy atoms: a carbon with four methyls
    "neopentane": (["C"] * 5, [(0, 1), (0, 2), (0, 3), (0, 4)], 24),
    # tert-butyl benzoate-like: a ring with a carboxyl and a tert-butyl
    "tbutyl_ring": (["C"] * 6 + ["C", "O", "O"] + ["C"] * 4,
                    _ring(6) + [(0, 6), (6, 7), (6, 8), (3, 9), (9, 10), (9, 11), (9, 12)], 24),
}


@pytest.mark.parametrize("name", LIGANDS)
def test_automorphisms_equal_networkx_on_every_e2e_synth_ligand(name):
    mol, bonds = _heavy(name)
    ours = rmsd.molecular_automorphisms(mol.elements, bonds)
    ref = jrmsd.molecular_automorphisms(mol.elements, bonds)
    assert len(ref) < 10000
    assert _as_set(ours) == _as_set(ref)
    assert [p.tolist() for p in ours] == [p.tolist() for p in ref]


@pytest.mark.parametrize("name", sorted(SYMMETRIC))
def test_automorphisms_equal_networkx_on_symmetric_molecules(name):
    elements, bonds, count = SYMMETRIC[name]
    ours = rmsd.molecular_automorphisms(elements, bonds)
    ref = jrmsd.molecular_automorphisms(elements, bonds)
    assert len(ref) == count
    assert _as_set(ours) == _as_set(ref)
    assert [p.tolist() for p in ours] == [p.tolist() for p in ref]
    # the same set whatever the atom numbering: relabel the graph at random
    rng = np.random.RandomState(len(name))
    perm = rng.permutation(len(elements))
    el2 = [None] * len(elements)
    for i, e in enumerate(elements):
        el2[perm[i]] = e
    b2 = [(int(perm[i]), int(perm[j])) for i, j in bonds]
    assert _as_set(rmsd.molecular_automorphisms(el2, b2)) == _as_set(jrmsd.molecular_automorphisms(el2, b2))


def test_automorphism_caps():
    """A star of 8 leaves has 40,320 automorphisms: past the cap the search
    stops with networkx's first 100, in its order; with no time left it
    stops after the first."""
    elements, bonds = ["C"] * 9, [(0, i) for i in range(1, 9)]
    capped = rmsd.molecular_automorphisms(elements, bonds, max_isomorphisms=100)
    ref = jrmsd.molecular_automorphisms(elements, bonds, max_isomorphisms=100, time_budget_s=1e9)
    assert len(_as_set(capped)) == 100
    assert [p.tolist() for p in capped] == [p.tolist() for p in ref]
    assert all(_is_automorphism(p.tolist(), elements, bonds) for p in capped)
    first = rmsd.molecular_automorphisms(elements, bonds, time_budget_s=0.0)
    assert len(first) == 1 and _is_automorphism(first[0].tolist(), elements, bonds)
    # no bonds, one atom, and no atoms at all
    assert _as_set(rmsd.molecular_automorphisms(["C", "N"], [])) == {(0, 1)}
    assert _as_set(rmsd.molecular_automorphisms(["C", "C"], [])) == {(0, 1), (1, 0)}
    assert [p.tolist() for p in rmsd.molecular_automorphisms([], [])] == [[]]


@pytest.mark.parametrize("name", LIGANDS[::10] + ["benzene"])
def test_rmsds_equal_jax_in_float64(name):
    if name == "benzene":
        elements, bonds, _ = SYMMETRIC["benzene"]
        ang = np.arange(6) * np.pi / 3
        ref = np.stack([1.39 * np.cos(ang), 1.39 * np.sin(ang), np.zeros(6)], 1)
    else:
        mol, bonds = _heavy(name)
        elements, ref = mol.elements, np.asarray(mol.coords, np.float64)
    rng = np.random.RandomState(3)
    poses = ref[None] + rng.randn(5, len(elements), 3)
    # a pose that is the reference with its atoms permuted by a symmetry
    perms = rmsd.molecular_automorphisms(elements, bonds)
    poses[0] = ref[perms[-1]]
    ours = rmsd.symmetry_rmsd(ref, poses, elements, bonds)
    theirs = jrmsd.symmetry_rmsd(ref, poses, elements, bonds)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-10)
    assert ours[0] < 1e-12
    assert rmsd.symmetry_rmsd(ref, poses[1], elements, bonds, perms=perms) == pytest.approx(ours[1], abs=1e-12)
    for p in poses:
        assert abs(rmsd.qcp_rmsd(ref, p) - jrmsd.qcp_rmsd(ref, p)) <= 1e-10
        assert abs(rmsd.hungarian_rmsd(ref, p, elements) - jrmsd.hungarian_rmsd(ref, p, elements)) <= 1e-10
        assert rmsd.simple_rmsd(ref, p) == jrmsd.simple_rmsd(ref, p)
    # qcp is invariant under a rigid motion of the pose
    q, _ = np.linalg.qr(rng.randn(3, 3))
    assert rmsd.qcp_rmsd(ref, poses[1] @ q.T + 4.0) == pytest.approx(rmsd.qcp_rmsd(ref, poses[1]), abs=1e-9)


def _rows(seed, n=5, p=10, nan_at=(), penalty_at=()):
    rng = np.random.RandomState(seed)
    rmsds = np.abs(rng.randn(n, p)) * 3
    cents = np.abs(rng.randn(n, p)) * 2
    run_times = rng.rand(n) * 10
    conf = rng.randn(n, p)
    clash = rng.rand(n, p)
    for i in nan_at:
        run_times[i] = np.nan
    for i in penalty_at:
        rmsds[i] = cents[i] = clash[i] = 10000.0
        conf[i] = -10000.0
    return rmsds, cents, run_times, conf, clash


@pytest.mark.parametrize("p", [1, 5, 10])
def test_metric_tables_equal_jax(p):
    rmsds, cents, run_times, _, clash = _rows(p, p=p, nan_at=(1,), penalty_at=(2,))
    assert metrics.compute_metric_table(rmsds, cents, run_times) == \
        jmetrics.compute_metric_table(rmsds, cents, run_times)
    assert metrics.compute_metric_table(rmsds) == jmetrics.compute_metric_table(rmsds)
    assert metrics.DockingMetrics(rmsds, cents, run_times).table() == \
        jmetrics.DockingMetrics(rmsds, cents, run_times).table()
    nan_rt = np.full(len(rmsds), np.nan)
    ours, ref = (m.compute_metric_table(rmsds, cents, nan_rt) for m in (metrics, jmetrics))
    assert ours.keys() == ref.keys() and np.isnan(ours["run_times_mean"]) and np.isnan(ref["run_times_mean"])
    g_rmsds, g_scores = np.abs(np.random.RandomState(p).randn(2, len(rmsds), 3)) * 3
    assert metrics.gnina_metric_table(g_rmsds, g_scores) == jmetrics.gnina_metric_table(g_rmsds, g_scores)
    mol, bonds = _heavy(LIGANDS[p])
    pose = np.asarray(mol.coords) + np.random.RandomState(p).randn(*np.asarray(mol.coords).shape)
    assert metrics.min_self_distances(pose, mol.bonds) == jmetrics.min_self_distances(pose, mol.bonds)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("with_gnina", [False, True])
def test_emit_metric_tables_writes_the_jax_files(tmp_path, split, with_gnina):
    """The same rows (with a NaN run time and a penalty row) through both
    writers: the same files, byte for byte, and the same metrics.json."""
    rmsds, cents, run_times, conf, clash = _rows(7, nan_at=(3,), penalty_at=(4,))
    names = [f"c{i}" for i in range(len(rmsds))]
    overlap = None
    if split:
        overlap = tmp_path / "no_overlap.txt"
        overlap.write_text("c1\nc3\nunknown\n")
    g = dict(gnina_rmsd_rows=list(np.abs(rmsds[:, :2])), gnina_score_rows=list(conf[:, :2])) if with_gnina else {}
    outs = {}
    for tag, fn in (("jax", jevaluate.emit_metric_tables), ("port", evaluate.emit_metric_tables)):
        out = tmp_path / tag
        table = fn(str(out), names, list(rmsds), list(cents), list(run_times), list(conf), list(clash), 1,
                   no_rec_overlap_names=str(overlap) if overlap else None, **g)
        outs[tag] = (out, table)
    (jout, jtable), (out, table) = outs["jax"], outs["port"]
    assert json.dumps(table, sort_keys=True) == json.dumps(jtable, sort_keys=True)
    files = sorted(os.listdir(jout))
    assert sorted(os.listdir(out)) == files
    assert ("no_overlap_rmsds.npy" in files) == split and ("gnina_rmsds.npy" in files) == with_gnina
    for f in files:
        assert (out / f).read_bytes() == (jout / f).read_bytes(), f


def test_emit_metric_tables_without_overlap_names_in_the_set(tmp_path, capsys):
    rmsds, cents, run_times, conf, clash = _rows(9)
    names = [f"c{i}" for i in range(len(rmsds))]
    overlap = tmp_path / "none.txt"
    overlap.write_text("zz\n")
    table = evaluate.emit_metric_tables(str(tmp_path / "o"), names, rmsds, cents, run_times, conf, clash, 0,
                                        no_rec_overlap_names=str(overlap))
    assert "skipping split" in capsys.readouterr().out
    assert not any(k.startswith("no_overlap_") for k in table)


FAKE_GNINA = """#!/bin/bash
lig=""; out=""
while [ $# -gt 0 ]; do
  case $1 in --ligand|-l) lig=$2; shift;; -o) out=$2; shift;;
  esac; shift
done
echo "CNNscore 0.61"
if [ -n "$out" ]; then
  awk '/^\\$\\$\\$\\$/{print "> <minimizedAffinity>"; print "-7.25"; print "";
                     print "> <CNNscore>"; print "0.73"; print ""} {print}' "$lig" > "$out"
fi
"""


def test_gnina_hooks_with_a_fake_binary_equal_jax(tmp_path, monkeypatch):
    """The subprocess protocol of the JAX package: the fake gnina prints a
    CNNscore line and writes the pose back with CNNscore and
    minimizedAffinity fields; both packages read the same score and
    coordinates. Without the binary both fall back to the input pose."""
    fake = tmp_path / "bin" / "gnina"
    fake.parent.mkdir()
    fake.write_text(FAKE_GNINA)
    fake.chmod(0o755)
    name = LIGANDS[0]
    mol = read_molecule_file(str(SYNTH / name / f"{name}_ligand.sdf"))
    jm = jread(str(SYNTH / name / f"{name}_ligand.sdf"))
    pdb = str(SYNTH / name / f"{name}_protein_processed.pdb")
    pose = np.asarray(mol.coords) + 0.5
    monkeypatch.setenv("PATH", f"{fake.parent}{os.pathsep}{os.environ['PATH']}")
    assert gnina.gnina_available() and jgnina.gnina_available()
    assert gnina.gnina_score(mol, pose, pdb) == jgnina.gnina_score(jm, pose, pdb) == 0.61
    for full in (False, True):
        ours = gnina.gnina_minimize_pose(mol, pose, pdb, full_dock=full)
        ref = jgnina.gnina_minimize_pose(jm, pose, pdb, full_dock=full)
        assert ours[2] == ref[2] == 0.73
        np.testing.assert_array_equal(ours[0], ref[0])
        assert ours[1].elements == ref[1].elements == mol.remove_hs().elements
    sdf = tmp_path / "scored.sdf"
    sdf.write_text(write_sdf(mol, pose, {"CNNscore": "0.42"}))
    assert gnina.read_gnina_score_sdf(str(sdf)) == jgnina.read_gnina_score_sdf(str(sdf)) == 0.42
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    assert not gnina.gnina_available()
    assert gnina.gnina_score(mol, pose, pdb) is None
    coords, heavy, score = gnina.gnina_minimize_pose(mol, pose, pdb)
    assert score == 0.0 and heavy.elements == mol.remove_hs().elements
    np.testing.assert_array_equal(coords, pose)
    assert isinstance(heavy, Molecule)
