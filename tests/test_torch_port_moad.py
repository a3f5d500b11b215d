"""The port's MOAD / DockGen dataset vs the JAX package's on the CPU.

A MOAD layout is built from e2e_synth files: two receptors under
``pdb_protein/``, and under ``pdb_ligand/`` two poses of one ligand and
one other ligand on the first receptor, and one ligand on the second. Both
packages preprocess it; the names, the joined complexes, the chain cutoff
and the alternative ground truths must be equal, with and without the
cluster pickles, and so must the training split's cluster-balanced draws
(``get``, ``__len__``, ``epoch_iterator``).
"""

import pickle
from pathlib import Path

import numpy as np
import pytest

from diffdock_tpu.data import chem as jchem
from diffdock_tpu.data import moad as jmoad
from diffdock_tpu_torch.data import moad
from diffdock_tpu_torch.data.chem import read_molecule_file, write_pdb_ligand

REPO = Path(__file__).resolve().parent.parent
SYNTH = REPO / "data" / "e2e_synth"
REC_A, REC_B = "syn001_l24r104", "syn006_l29r122"


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    root = tmp_path_factory.mktemp("moad")
    (root / "pdb_protein").mkdir()
    (root / "pdb_ligand").mkdir()
    for rec, src in (("s001_1", REC_A), ("s006_1", REC_B)):
        (root / "pdb_protein" / f"{rec}_protein.pdb").write_text(
            (SYNTH / src / f"{src}_protein_processed.pdb").read_text())
    mol_a = read_molecule_file(str(SYNTH / REC_A / f"{REC_A}_ligand.sdf")).remove_hs()
    mol_b = read_molecule_file(str(SYNTH / REC_B / f"{REC_B}_ligand.sdf")).remove_hs()
    rng = np.random.RandomState(0)
    ligands = {
        "s001_1_A_0": (mol_a, mol_a.coords),
        "s001_1_A_1": (mol_a, mol_a.coords + rng.randn(3)),  # a second pose of the same ligand
        "s001_1_C_2": (mol_b, mol_a.coords.mean(0) + mol_b.coords - mol_b.coords.mean(0)),
        "s006_1_B_0": (mol_b, mol_b.coords),
    }
    for name, (mol, xyz) in ligands.items():
        (root / "pdb_ligand" / f"{name}.pdb").write_text(write_pdb_ligand(mol, np.asarray(xyz, np.float32)))
    splits, clusters = root / "splits.pkl", root / "clusters.pkl"
    with open(splits, "wb") as f:
        pickle.dump({"test": ["c1", "c2"], "val": ["c2"], "PDBBind": []}, f)
    with open(clusters, "wb") as f:
        pickle.dump({"c1": ["s001_1_A_0", "s001_1_A_1", "s001_1_C_2"], "c2": ["s006_1_B_0"]}, f)
    return root, splits, clusters


def _pair(root, tmp_path, **kw):
    ours = moad.MOADDataset(moad.MOADConfig(moad_dir=str(root), cache_dir=str(tmp_path / "port"), split="test", **kw))
    ref = jmoad.MOADDataset(jmoad.MOADConfig(moad_dir=str(root), cache_dir=str(tmp_path / "jax"), split="test", **kw))
    ours.preprocess(verbose=False)
    ref.preprocess(verbose=False)
    return ours, ref


def _same(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), f


@pytest.mark.parametrize("pickles", [False, True])
def test_moad_names_complexes_and_ground_truths_equal_jax(layout, tmp_path, pickles):
    root, splits, clusters = layout
    kw = dict(splits_pickle=str(splits), clusters_pickle=str(clusters)) if pickles else {}
    ours, ref = _pair(root, tmp_path, **kw)
    cfg = dict(moad_dir=str(root), split="test", chain_cutoff=4.0, **kw)
    assert repr(moad.MOADConfig(**cfg)) == repr(jmoad.MOADConfig(**cfg))
    assert moad.MOADConfig(**cfg).cache_key() == jmoad.MOADConfig(**cfg).cache_key()
    assert ours.names == ref.names == ["s001_1_A_0", "s001_1_A_1", "s001_1_C_2", "s006_1_B_0"]
    assert ours.cluster_to_ligands == ref.cluster_to_ligands and ours.clusters == ref.clusters
    for name in ours.names:
        _same(ours.get_by_name(name), ref.get_by_name(name))
        alts, jalts = ours.alternative_ground_truths(name), ref.alternative_ground_truths(name)
        assert len(alts) == len(jalts)
        for a, b in zip(alts, jalts):
            np.testing.assert_array_equal(a, b)
    # the two poses of one ligand are each other's alternatives; the other
    # ligand of that receptor is not
    assert len(ours.alternative_ground_truths("s001_1_A_0")) == 2
    assert len(ours.alternative_ground_truths("s001_1_C_2")) == 1
    assert ours._receptor_path("s001_1") == ref._receptor_path("s001_1")
    assert ours._ligand_dir() == ref._ligand_dir()


def test_moad_filters_and_limits_equal_jax(layout, tmp_path):
    root, _, _ = layout
    for i, kw in enumerate((dict(limit_complexes=2), dict(remove_promiscuous_targets=1),
                            dict(max_ligand_size=25), dict(chain_cutoff=10.0))):
        ours, ref = _pair(root, tmp_path / str(i), **kw)
        assert ours.names == ref.names, kw
        for name in ours.names:
            _same(ours.get_by_name(name), ref.get_by_name(name))


def test_apply_chain_cutoff_equals_jax(layout, tmp_path):
    """Two made-up chains on one receptor: the chain far from the ligand is
    dropped and the complex recentered on what is kept."""
    root, _, _ = layout
    ours, ref = _pair(root, tmp_path)
    data, jdata = ours.get_by_name("s001_1_A_0"), ref.get_by_name("s001_1_A_0")
    lig = np.asarray(data.lig_pos)
    d = np.linalg.norm(np.asarray(data.rec_pos)[:, None] - lig[None], axis=-1).min(1)
    chain_ids = (d > np.median(d)).astype(np.int64)
    for cutoff in (0.01, np.median(d), 1e4):
        a = moad.apply_chain_cutoff(data, chain_ids, cutoff)
        b = jmoad.apply_chain_cutoff(jdata, chain_ids, cutoff)
        assert (a is None) == (b is None)
        if a is not None:
            _same(a, b)
    kept = moad.apply_chain_cutoff(data, chain_ids, float(np.median(d)))
    assert kept.n_rec == int((chain_ids == 0).sum())
    np.testing.assert_allclose(np.asarray(kept.rec_pos).mean(0), 0.0, atol=1e-4)
    # the ligand files parse the same in both packages
    path = str(root / "pdb_ligand" / "s001_1_A_1.pdb")
    np.testing.assert_array_equal(read_molecule_file(path).coords, jchem.read_molecule_file(path).coords)


@pytest.mark.parametrize("kw", [{}, dict(multiplicity=3), dict(no_randomness=True),
                                dict(chain_cutoff=4.0, multiplicity=2)])
def test_moad_training_sampler_equals_jax(layout, tmp_path, kw):
    """The cluster-balanced sampler (``get``, ``__len__``,
    ``epoch_iterator``) of the training split against JAX's: the same
    ligands drawn in the same order from the same seeds, the same joined
    complexes. Without the pickles every receptor's ligands form a cluster
    (two here: three ligands and one)."""
    root, _, _ = layout
    ours = moad.MOADDataset(moad.MOADConfig(moad_dir=str(root), cache_dir=str(tmp_path / "port"), **kw))
    ref = jmoad.MOADDataset(jmoad.MOADConfig(moad_dir=str(root), cache_dir=str(tmp_path / "jax"), **kw))
    ours.preprocess(verbose=False)
    ref.preprocess(verbose=False)
    assert len(ours) == len(ref) == 2 * kw.get("multiplicity", 1)
    r1, r2 = np.random.RandomState(3), np.random.RandomState(3)
    for idx in (0, 1, 2, 0, 0, 1):
        (na, da), (nb, db) = ours.get(idx, r1), ref.get(idx, r2)
        assert na == nb
        _same(da, db)
        assert ours.get(idx)[0] == ref.get(idx)[0] == sorted(ours.cluster_to_ligands[ours.clusters[idx % 2]])[0]
    names = set()
    for seed in (0, 1, 7):
        a, b = list(ours.epoch_iterator(seed)), list(ref.epoch_iterator(seed))
        assert [n for n, _ in a] == [n for n, _ in b]
        assert len(a) == len(ours)
        for (_, x), (_, y) in zip(a, b):
            _same(x, y)
        names.update(n for n, _ in a)
    # the draws reach past the first ligand of the three-ligand cluster,
    # unless the sampler is told not to draw
    assert len(names) == 2 if kw.get("no_randomness") else len(names) >= 3
