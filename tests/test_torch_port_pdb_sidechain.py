"""The port's PDB sidechain ("van der Mers") dataset vs the JAX package's on
the CPU.

The proteins are e2e_synth receptors given full sidechains from a numpy
seed (``chip_smoke.sidechain_pdb``: their own sidechains stop at CB, so no
residue would reach the three sidechain atoms a pseudo-ligand needs). Both
packages preprocess the same directory into caches of their own; the
contact counts, the pseudo-ligand molecules, the cached arrays, each
sampled pseudo-complex (with and without the second segment's removal) and
whole epochs must be equal, names and arrays bit for bit.
"""

import numpy as np
import pytest
import torch

from chip_smoke import sidechain_pdb
from diffdock_tpu.data import chem as jchem
from diffdock_tpu.data import pdb_sidechain as jsc
from diffdock_tpu_torch.data import chem
from diffdock_tpu_torch.data import pdb_sidechain as sc
from tests.test_torch_port_datasets import SYNTH
from tests.test_torch_port_moad import _same

@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# a small protein whose best sidechain reaches 11 contacts, a larger one,
# and one whose sidechains all stay under 10 (retried past)
PROTEINS = ("syn006_l29r122", "syn002_l30r318", "syn013_l26r127")


def write_sidechain_dir(root, proteins=PROTEINS, seed: int = 0):
    """One full-sidechain PDB per e2e_synth receptor under ``root``, named
    ``sc<nnn>`` after its complex."""
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    for name in proteins:
        text = (SYNTH / name / f"{name}_protein_processed.pdb").read_text()
        (root / f"sc{name[3:6]}.pdb").write_text(sidechain_pdb(text, rng))
    return root


@pytest.fixture(scope="module")
def sc_dir(tmp_path_factory):
    return write_sidechain_dir(tmp_path_factory.mktemp("pdb_sc") / "pdbs")


def _pair(sc_dir, tmp_path, **kw):
    ours = sc.PDBSidechainDataset(sc.PDBSidechainConfig(data_dir=str(sc_dir),
                                                        cache_dir=str(tmp_path / "port"), **kw))
    ref = jsc.PDBSidechainDataset(jsc.PDBSidechainConfig(data_dir=str(sc_dir),
                                                         cache_dir=str(tmp_path / "jax"), **kw))
    ours.preprocess(verbose=False)
    ref.preprocess(verbose=False)
    return ours, ref


def _same_item(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        assert a[0] == b[0]
        _same(a[1], b[1])


def test_contact_counts_equal_jax():
    rng = np.random.RandomState(0)
    coords = (rng.randn(700, 3) * 9).astype(np.float32)
    res = np.sort(rng.randint(0, 90, 700)).astype(np.int32)
    for max_dist, buf in ((5.0, 7), (3.5, 2)):
        ours = sc.contact_counts(coords, res, 90, max_dist=max_dist, buffer_residue_num=buf)
        ref = jsc.contact_counts(coords, res, 90, max_dist=max_dist, buffer_residue_num=buf)
        assert ours.dtype == ref.dtype and np.array_equal(ours, ref)
    # more atoms than one chunk of 2048
    coords = (rng.randn(2100, 3) * 15).astype(np.float32)
    res = np.sort(rng.randint(0, 300, 2100)).astype(np.int32)
    assert np.array_equal(sc.contact_counts(coords, res, 300), jsc.contact_counts(coords, res, 300))


def test_sidechain_molecules_equal_jax(sc_dir):
    """Every residue of a generated protein: the same atoms, elements,
    coordinates and perceived bonds (None alike below two atoms)."""
    text = (sc_dir / "sc006.pdb").read_text()
    ours, ref = chem.parse_pdb(text).residues_with_ca(), jchem.parse_pdb(text).residues_with_ca()
    sizes = []
    for a, b in zip(ours, ref):
        ma, mb = sc.sidechain_molecule(a), jsc.sidechain_molecule(b)
        assert (ma is None) == (mb is None)
        if ma is None:
            continue
        assert ma.elements == mb.elements and ma.bonds == mb.bonds and ma.name == mb.name
        assert ma.coords.dtype == mb.coords.dtype and np.array_equal(ma.coords, mb.coords)
        sizes.append(ma.num_atoms)
    # the generator gave most residues a sidechain of three or more atoms
    assert len(sizes) > 80 and sum(n >= 3 for n in sizes) > 60


def test_config_and_preprocess_equal_jax(sc_dir, tmp_path):
    cfg = dict(data_dir=str(sc_dir), max_dist=4.5)
    assert repr(sc.PDBSidechainConfig(**cfg)) == repr(jsc.PDBSidechainConfig(**cfg))
    assert sc.PDBSidechainConfig(**cfg).cache_key() == jsc.PDBSidechainConfig(**cfg).cache_key()
    ours, ref = _pair(sc_dir, tmp_path)
    assert ours.names == ref.names == ["sc002", "sc006", "sc013"]
    assert len(ours) == len(ref) == 3
    for name in ours.names:
        with np.load(ours.cache / f"{name}.npz") as z, np.load(ref.cache / f"{name}.npz") as y:
            assert sorted(z.files) == sorted(y.files)
            for k in z.files:
                assert z[k].dtype == y[k].dtype and z[k].tobytes() == y[k].tobytes(), k
        with np.load(ours.cache / f"{name}.npz") as z:
            probs = ours.sampling_probabilities(z["contacts"])
            assert np.array_equal(probs, ref.sampling_probabilities(z["contacts"]))
    # too short a protein is skipped by both
    ours, ref = _pair(sc_dir, tmp_path / "short", min_protein_length=200)
    assert ours.names == ref.names == ["sc002"]


@pytest.mark.parametrize("second", [False, True])
def test_get_equals_jax(sc_dir, tmp_path, second):
    """Draws from each protein, with a shared RandomState and with the
    default one of the index, with and without removing a second segment:
    the same residue, the same pseudo-complex (the cut receptor recentred,
    its kNN graph rebuilt) or the same None."""
    ours, ref = _pair(sc_dir, tmp_path, remove_second_segment=second)
    r1, r2 = np.random.RandomState(5), np.random.RandomState(5)
    got = []
    for idx in (0, 1, 2, 1, 0, 2):
        a, b = ours.get(idx, r1), ref.get(idx, r2)
        _same_item(a, b)
        got.append(a)
        _same_item(ours.get(idx), ref.get(idx))
    assert all(g is not None for g in got)
    # sc013's sidechains stay under min_best_contacts: its draws pass to
    # another protein
    assert not any(g[0].startswith("sc013") for g in got)
    # the pseudo-ligand has its three or more atoms; the receptor lost the
    # window around its residue and is centred on what is kept
    n_res = {n: len(chem.read_pdb_file(str(sc_dir / f"{n}.pdb")).residues_with_ca()) for n in ours.names}
    for name, data in got:
        assert data.lig_cat.shape[0] >= 3
        assert data.rec_pos.shape[0] <= n_res[name.split("_sc")[0]] - (8 if not second else 16)
        assert np.abs(np.asarray(data.rec_pos).mean(0)).max() < 1e-3


@pytest.mark.parametrize("kw", [{}, {"multiplicity": 2, "remove_second_segment": True}])
def test_epoch_iterator_equals_jax(sc_dir, tmp_path, kw):
    ours, ref = _pair(sc_dir, tmp_path, **kw)
    for seed in (0, 3):
        a, b = list(ours.epoch_iterator(seed)), list(ref.epoch_iterator(seed))
        assert [n for n, _ in a] == [n for n, _ in b] and a
        for x, y in zip(a, b):
            _same_item(x, y)
