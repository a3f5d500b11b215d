"""The port's host data path vs the JAX package's on the CPU.

``build_complex_data`` and ``build_aa_complex_data`` of both packages on a
fixed sample of ``data/e2e_synth/`` complexes with their ESM ``.npy``: the
same arrays, dtype, shape and values, exactly. The port's kNN (its own
build of ``native/graphops.cpp``, and its numpy path) against the JAX
package's native kNN, with and without the radius cap. The ESM table, the
inference dataset builder and the CSV reader against the JAX ones.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from diffdock_tpu.data import chem as jchem
from diffdock_tpu.data import complexes as j_complexes
from diffdock_tpu.data import esm as jesm
from diffdock_tpu.data import featurize as jfeat
from diffdock_tpu.data import inference_dataset as jds
from diffdock_tpu.native import knn_cross_native as j_knn_cross, knn_graph_native as j_knn_graph
from diffdock_tpu_torch import native
from diffdock_tpu_torch.data import chem, complexes, esm, featurize
from diffdock_tpu_torch.data import inference_dataset as ds

REPO = Path(__file__).resolve().parent.parent
SYNTH = REPO / "data" / "e2e_synth"
NAMES = sorted(p.name for p in SYNTH.glob("syn*"))
# every tenth complex and the largest receptor (1547 residues)
SAMPLE = sorted(set(NAMES[::10]) | {"syn045_l8r1547"})


@pytest.fixture(scope="module", autouse=True)
def _jax_native_library():
    """The JAX package's native library, loaded before any comparison.

    ``diffdock_tpu.native`` runs ``make`` when ``native/libgraphops.so`` is
    missing, g++ writes that file in place, and a failed load is remembered
    for the life of the process: a test process that loads while another
    is still writing the file would compare against the numpy path for the
    whole run. So, under a file lock shared by all test processes, the
    library is built (with the Makefile's own flags, to a temporary name
    moved into place) if it is missing or does not load, and the JAX
    package's loader is asked again after a failure it recorded. If it
    still cannot load, every test of this file fails with the reason."""
    import ctypes
    import fcntl
    import os
    import subprocess

    from diffdock_tpu import native as jnative

    lib = jnative._LIB_PATH
    lock_dir = REPO / "diffdock_tpu_torch" / "_build"
    lock_dir.mkdir(parents=True, exist_ok=True)
    with open(lock_dir / "jax_graphops.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if jnative._lib is None:
                try:
                    ctypes.CDLL(str(lib))
                except OSError:
                    tmp = lock_dir / f"libgraphops.{os.getpid()}.so"
                    proc = subprocess.run(["make", "-C", str(lib.parent), f"OUT={tmp}"],
                                          capture_output=True, text=True, timeout=300)
                    if proc.returncode != 0:
                        pytest.fail(f"building {lib} failed:\n{proc.stdout}{proc.stderr}")
                    os.replace(tmp, lib)
                jnative._tried = False
                if jnative._load() is None:
                    pytest.fail(f"the JAX package's native library {lib} does not load")
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    yield


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _paths(name):
    d = SYNTH / name
    return str(d / f"{name}_ligand.sdf"), str(d / f"{name}_protein_processed.pdb")


def _assert_same_tree(ours, ref, where):
    assert type(ours).__name__ == type(ref).__name__ and ours._fields == ref._fields
    for field in ref._fields:
        a, b = getattr(ours, field), getattr(ref, field)
        if field == "base":
            _assert_same_tree(a, b, where)
            continue
        if b is None:
            assert a is None, (where, field)
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, field, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b, equal_nan=True), (where, field)


def test_native_library_builds_and_loads():
    assert native.have_native(), native.load_error
    assert native.library_path().parent.name == "_build"


@pytest.mark.parametrize("name", SAMPLE)
def test_complex_arrays_equal_jax(name):
    lig, pdb = _paths(name)
    lm = np.load(SYNTH / "_esm" / f"{name}.npy")
    mol, jmol = chem.read_molecule_file(lig), jchem.read_molecule_file(lig)
    prot, jprot = chem.read_pdb_file(pdb), jchem.read_pdb_file(pdb)
    data, heavy = featurize.build_complex_data(mol, prot, lm)
    jdata, jheavy = jfeat.build_complex_data(jmol, jprot, lm)
    _assert_same_tree(data, jdata, name)
    assert heavy.elements == jheavy.elements and heavy.bonds == jheavy.bonds
    assert data.rec_scv is not None and data.rec_lm.shape[1] == 1280
    aa, _ = featurize.build_aa_complex_data(mol, prot, lm)
    jaa, _ = jfeat.build_aa_complex_data(jmol, jprot, lm)
    _assert_same_tree(aa, jaa, name)
    # without LM embeddings, and with the receptor radius cap
    _assert_same_tree(featurize.build_complex_data(mol, prot, None, receptor_radius=8.0)[0],
                      jfeat.build_complex_data(jmol, jprot, None, receptor_radius=8.0)[0], name)


def test_receptor_arrays_side_chain_vecs_and_chains():
    lig, pdb = _paths(SAMPLE[1])
    prot, jprot = chem.read_pdb_file(pdb), jchem.read_pdb_file(pdb)
    rec, jrec = featurize.build_receptor_arrays(prot), jfeat.build_receptor_arrays(jprot)
    assert list(rec) == list(jrec)
    for k in rec:
        assert np.array_equal(rec[k], jrec[k], equal_nan=True) and rec[k].dtype == jrec[k].dtype, k
    lig_arrays, _ = featurize.build_ligand_arrays(chem.read_molecule_file(lig))
    jlig_arrays, _ = jfeat.build_ligand_arrays(jchem.read_molecule_file(lig))
    for k in jlig_arrays:
        assert np.array_equal(lig_arrays[k], jlig_arrays[k]), k
    for name in ("CA", "CB", "OXT", "NZ", "SE", "HB2", "X"):
        assert featurize._atom_type2(name) == jfeat._atom_type2(name)
        assert featurize.safe_index(featurize.ALLOWABLE_FEATURES["possible_atom_type_3"], name) == \
            jfeat.safe_index(jfeat.ALLOWABLE_FEATURES["possible_atom_type_3"], name)


@pytest.mark.parametrize("max_radius", [None, 6.0, 1.0])
def test_knn_paths_agree(monkeypatch, max_radius):
    """Native (the port's build) and the JAX package's native kNN give the
    same lists and masks on random points (no distance ties); the numpy
    path gives the same masks and the same neighbours where the mask is
    set (the native code writes 0 where it is not, numpy keeps the
    neighbour, in both packages). With a cap below every distance only the
    nearest neighbour stays."""
    rng = np.random.RandomState(0)
    pos = (rng.randn(300, 3) * 6.0).astype(np.float32)
    ref = j_knn_graph(pos, 10, max_radius)
    assert ref is not None
    ours = complexes.build_knn_neighbors(pos, 10, max_radius)
    monkeypatch.setattr(complexes, "knn_graph_native", lambda *a: None)
    plain = complexes.build_knn_neighbors(pos, 10, max_radius)
    np.testing.assert_array_equal(ours[0], ref[0])
    np.testing.assert_array_equal(ours[1], ref[1])
    np.testing.assert_array_equal(plain[1], ref[1])
    np.testing.assert_array_equal(np.where(ref[1], plain[0], 0), ref[0])
    if max_radius == 1.0:
        assert ref[1][:, 0].all() and ref[1].sum() < 300 * 10
    q = (rng.randn(40, 3) * 6.0).astype(np.float32)
    for a, b in zip(native.knn_cross_native(q, pos, 7, max_radius), j_knn_cross(q, pos, 7, max_radius)):
        np.testing.assert_array_equal(a, b)


def test_knn_graph_of_tiny_inputs():
    for n in (1, 2, 5):
        pos = np.arange(3 * n, dtype=np.float32).reshape(n, 3) ** 1.5
        for a, b in zip(complexes.build_knn_neighbors(pos, 4), j_complexes.build_knn_neighbors(pos, 4)):
            np.testing.assert_array_equal(a, b)


def test_esm_table_and_chain_sequences():
    table, jtable = esm.LazyNpyTable(str(SYNTH / "_esm")), jesm.LazyNpyTable(str(SYNTH / "_esm"))
    name = SAMPLE[2]
    assert name in table and "missing" not in table and table.get("missing") is None
    with pytest.raises(KeyError):
        table["missing"]
    prot, jprot = chem.read_pdb_file(_paths(name)[1]), jchem.read_pdb_file(_paths(name)[1])
    assert esm.chain_sequences(prot) == jesm.chain_sequences(jprot)
    emb = esm.embeddings_for_protein(prot, table, name)
    np.testing.assert_array_equal(emb, jesm.embeddings_for_protein(jprot, jtable, name))
    assert emb.shape == (len(prot.residues_with_ca()), esm.ESM_DIM) and emb.dtype == np.float32
    assert esm.embeddings_for_protein(prot, table, "missing") is None

    class Embedder:
        def embed_protein(self, protein):
            return np.ones((3, 2), np.float32)

    assert esm.embeddings_for_protein(prot, None, None, Embedder()).shape == (3, 2)


def test_inference_dataset_builder_matches_jax(tmp_path):
    csv = tmp_path / "pairs.csv"
    rows = ["complex_name,protein_path,ligand_description"]
    for name in SAMPLE[:2]:
        lig, pdb = _paths(name)
        rows.append(f"{name},{pdb},{lig}")
    rows.append("bad,,CCO")
    csv.write_text("\n".join(rows) + "\n")
    specs, jspecs = ds.specs_from_csv(str(csv)), jds.specs_from_csv(str(csv))
    assert [vars(s) for s in specs] == [vars(s) for s in jspecs]
    table = esm.LazyNpyTable(str(SYNTH / "_esm"))
    builder = ds.InferenceDatasetBuilder(esm_table=table, workdir=str(tmp_path))
    jbuilder = jds.InferenceDatasetBuilder(esm_table=jesm.LazyNpyTable(str(SYNTH / "_esm")),
                                           workdir=str(tmp_path))
    built = builder.build_all(specs, verbose=False)
    jbuilt = jbuilder.build_all(jspecs, verbose=False)
    for c, jc in zip(built[:2], jbuilt[:2]):
        assert c.success and jc.success and c.name == jc.name
        _assert_same_tree(c.data, jc.data, c.name)
    assert not built[2].success and "need protein_path or protein_sequence" in built[2].error

    # SMILES needs RDKit; a bare sequence needs the folder hook
    with pytest.raises(RuntimeError, match="SMILES ligand input requires RDKit"):
        ds.read_ligand_description("CCO")
    lig, pdb = _paths(SAMPLE[0])
    seq_spec = ds.InferenceSpec("seq", protein_sequence="MKV", ligand_description=lig)
    failed = builder.build(seq_spec)
    assert not failed.success and "ESMFold" in failed.error
    folded = []

    def folder(sequence, out_path):
        folded.append((sequence, out_path))
        return pdb

    mol, prot, lm = ds.InferenceDatasetBuilder(folder=folder, workdir=str(tmp_path)).load(seq_spec)
    assert folded == [("MKV", str(tmp_path / "seq_esmfold.pdb"))] and lm is None
    assert len(prot.residues) == len(chem.read_pdb_file(pdb).residues)
