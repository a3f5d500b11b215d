"""The port's dataset cache vs the JAX package's on the CPU.

``DatasetConfig`` must ``repr`` as the JAX package's does, so that
``cache_key`` (an md5 of the repr) names the same cache directory, and the
``.npz`` shards written by either package must load in the other with
bit-equal arrays: coarse-grained and all-atom, with and without LM
embeddings. ``print_statistics`` gives the same dict, and a cache built by
one package is served to the other without featurizing again.
"""

import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest

from diffdock_tpu.data import datasets as jds
from diffdock_tpu_torch.data import datasets as ds
from diffdock_tpu_torch.data.complexes import AAComplexData

REPO = Path(__file__).resolve().parent.parent
SYNTH = REPO / "data" / "e2e_synth"
NAMES = ("syn001_l24r104", "syn006_l29r122", "syn044_l9r90")


def _leaves(d):
    if isinstance(d, (AAComplexData, jds.AAComplexData)):
        return [("base." + f, a) for f, a in _leaves(d.base)] + \
            [(f, getattr(d, f)) for f in d._fields if f != "base"]
    return [(f, getattr(d, f)) for f in d._fields]


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [f for f, _ in la] == [f for f, _ in lb]
    for (f, x), (_, y) in zip(la, lb):
        if x is None or y is None:
            assert x is None and y is None, f
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f


def _split(tmp_path, names=NAMES):
    path = tmp_path / "split.txt"
    path.write_text("\n".join(names) + "\n")
    return str(path)


@pytest.mark.parametrize("kw", [{}, dict(all_atoms=True), dict(cache_dir="x/y", receptor_radius=15.0),
                                dict(max_lig_size=40, min_ligand_size=3, atom_max_neighbors=6)])
def test_dataset_config_repr_and_cache_key_are_the_jax_packages(kw):
    ours, ref = ds.DatasetConfig(**kw), jds.DatasetConfig(**kw)
    assert repr(ours) == repr(ref)
    assert ours.cache_key() == ref.cache_key()
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(ref)]


def test_pdbbind_specs_equal_jax(tmp_path):
    esm = tmp_path / "esm"
    esm.mkdir()
    np.save(esm / f"{NAMES[0]}.npy", np.zeros((3, 4), np.float32))
    for split in (None, _split(tmp_path, NAMES + ("absent",))):
        for esm_dir in (None, str(esm)):
            ours = ds.pdbbind_specs(str(SYNTH), split, esm_embeddings_dir=esm_dir)
            ref = jds.pdbbind_specs(str(SYNTH), split, esm_embeddings_dir=esm_dir)
            assert [dataclasses.astuple(s) for s in ours] == [dataclasses.astuple(s) for s in ref]
    specs = ds.pdbbind_specs(str(SYNTH), None, protein_suffix="_protein.pdb")
    assert specs == []


@pytest.mark.parametrize("all_atoms", [False, True])
@pytest.mark.parametrize("with_lm", [False, True])
def test_shards_load_in_the_other_package(tmp_path, all_atoms, with_lm):
    """Each package featurizes into its own cache; every shard loads in the
    other package with bit-equal arrays, and the two caches hold the same
    files."""
    esm = str(SYNTH / "_esm") if with_lm else None
    split = _split(tmp_path)
    ours = ds.ComplexDataset(ds.pdbbind_specs(str(SYNTH), split, esm_embeddings_dir=esm),
                             ds.DatasetConfig(cache_dir=str(tmp_path / "port"), all_atoms=all_atoms))
    ref = jds.ComplexDataset(jds.pdbbind_specs(str(SYNTH), split, esm_embeddings_dir=esm),
                             jds.DatasetConfig(cache_dir=str(tmp_path / "jax"), all_atoms=all_atoms))
    ours.preprocess(verbose=False)
    ref.preprocess(verbose=False)
    assert ours.names == ref.names == list(NAMES) and len(ours) == 3
    assert sorted(os.listdir(ours.cache)) == sorted(os.listdir(ref.cache))
    for name in NAMES:
        a, b = ours.get(name), ref.get(name)
        assert isinstance(a, AAComplexData) == all_atoms
        _assert_same(a, b)
        lm = (a.base if all_atoms else a).rec_lm
        assert lm.shape[1] == (1280 if with_lm else 0)
        _assert_same(ds.load_complex_npz(str(ref._path(ref._by_name[name]))), b)
        _assert_same(jds.load_complex_npz(str(ours._path(ours._by_name[name]))), a)


def test_a_cache_built_by_jax_is_served_to_the_port(tmp_path, capsys):
    """The port on the JAX package's cache directory featurizes nothing and
    reads the same statistics, from the sidecar JAX wrote; a failed
    complex is skipped by both."""
    bad = tmp_path / "data" / "broken"
    bad.mkdir(parents=True)
    (bad / "broken_protein_processed.pdb").write_text("not a pdb\n")
    (bad / "broken_ligand.sdf").write_text("not an sdf\n")
    for name in NAMES[:2]:
        os.symlink(SYNTH / name, tmp_path / "data" / name)
    cfg = dict(cache_dir=str(tmp_path / "cache"))
    ref = jds.ComplexDataset(jds.pdbbind_specs(str(tmp_path / "data")), jds.DatasetConfig(**cfg))
    ref.preprocess(verbose=False)
    assert "broken" in ref._failures and ref.names == list(NAMES[:2])
    stats_ref = ref.print_statistics()
    mtimes = {p: p.stat().st_mtime_ns for p in ref.cache.iterdir()}
    ours = ds.ComplexDataset(ds.pdbbind_specs(str(tmp_path / "data")), ds.DatasetConfig(**cfg))
    ours.preprocess(verbose=False)
    assert ours.cache == ref.cache and ours.names == ref.names and "broken" in ours._failures
    assert {p: p.stat().st_mtime_ns for p in ours.cache.iterdir()} == mtimes
    capsys.readouterr()
    assert ours.print_statistics() == stats_ref
    printed = capsys.readouterr().out
    assert printed.startswith("Number of complexes: 2\n") and "receptor residues: mean" in printed


def test_print_statistics_equal_jax(tmp_path):
    split = _split(tmp_path)
    stats = []
    for mod, tag in ((ds, "port"), (jds, "jax")):
        d = mod.ComplexDataset(mod.pdbbind_specs(str(SYNTH), split), mod.DatasetConfig(cache_dir=str(tmp_path / tag)))
        d.preprocess(verbose=False)
        stats.append(d.print_statistics())
    assert stats[0] == stats[1]
    assert stats[0]["ligand atoms"]["max"] == 29.0
    # the port's all-atom shards give their coarse-grained tree's statistics
    d = ds.ComplexDataset(ds.pdbbind_specs(str(SYNTH), split),
                          ds.DatasetConfig(cache_dir=str(tmp_path / "aa"), all_atoms=True))
    d.preprocess(verbose=False)
    assert d.print_statistics() == stats[1]
