"""Protein inputs and tools of the port against the JAX package's on the CPU.

``esm-prep``'s three subcommands (files and arrays equal to the JAX CLI's),
``fold_sequence``'s OOM halving with a fake ESMFold, the conformer functions
bit for bit on e2e_synth ligands without RDKit, the three rotation
conversions (within 2e-6: the same float32 formulas, different sqrt/atan2
last bits) with rotations near and at 180 degrees, the logging
helpers, ``prewarm --device cpu`` with a narrow preset, and one
small dock whose receptor is embedded live by the port's ESM2 (tiny
config) through ``InferenceDatasetBuilder(esm_embedder=...)``: the same
poses, bit for bit, as the dock from a ``LazyNpyTable`` of those
embeddings, and, against the JAX pipeline fed the same embeddings with its
own draws, the start poses within 1e-4 A and the poses after the first step
within 1e-3 A (the bounds of ``tests/test_torch_port_dock_files.py``).
"""

import contextlib
import io
import logging
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from diffdock_tpu.cli import esm_prep as jesm_prep
from diffdock_tpu.data import chem as jchem
from diffdock_tpu.data import conformers as jconf
from diffdock_tpu.data import featurize as jfeat
from diffdock_tpu.data import inference_dataset as jinf
from diffdock_tpu.geometry import rotations as jrot
from diffdock_tpu.inference.ladder import COVER_LADDER as J_COVER_LADDER
from diffdock_tpu.inference.pipeline import DockingPipeline as JDockingPipeline
from diffdock_tpu.inference.sampler import SamplerConfig as JSamplerConfig
from diffdock_tpu.models.config import ScoreModelConfig as JScoreModelConfig
from diffdock_tpu.models.score_model import CGScoreModel as JCGScoreModel
from diffdock_tpu_torch.cli import main as cli_main
from diffdock_tpu_torch.cli import prewarm
from diffdock_tpu_torch.data import chem, conformers, esm, inference_dataset
from diffdock_tpu_torch.data.complexes import bucket_sizes
from diffdock_tpu_torch.geometry import rotations
from diffdock_tpu_torch.inference.ladder import COVER_LADDER
from diffdock_tpu_torch.inference.pipeline import DockingPipeline
from diffdock_tpu_torch.inference.sampler import SamplerConfig
from diffdock_tpu_torch.models import esm2
from diffdock_tpu_torch.models.config import ScoreModelConfig
from diffdock_tpu_torch.utils import logging as plog
from diffdock_tpu_torch.utils.convert import state_dict_from_flax
from tests.test_torch_port_confidence import _conf_kw, _init_confidence, _perturbed, tables  # noqa: F401
from tests.test_torch_port_dock import _jax_noise
from tests.test_torch_port_esm2 import HEADS, HID, SYNTH, hf_dir, random_params, two_chain_pdb  # noqa: F401

LIGANDS = ("syn000_l50r368", "syn001_l24r104", "syn006_l29r122")
ROT_ATOL = 2e-6


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(main, argv):
    """(rc, stdout) of a CLI main."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def prep_dir(tmp_path_factory):
    """A PDBBind-layout directory of two e2e_synth complexes and one bare
    two-chain ``.pdb``."""
    root = tmp_path_factory.mktemp("pdbbind")
    for name in LIGANDS[1:]:
        (root / name).mkdir()
        os.symlink(SYNTH / name / f"{name}_protein_processed.pdb", root / name / f"{name}_protein_processed.pdb")
    two_chain_pdb(SYNTH / "syn000_l50r368" / "syn000_l50r368_protein_processed.pdb", root / "twochain.pdb")
    return root


def test_esm_prep_fasta_and_convert_equal_the_jax_cli(prep_dir, tmp_path):
    rc, out = _run(cli_main.main, ["esm-prep", "fasta", "--data_dir", str(prep_dir), "--out",
                                   str(tmp_path / "port.fasta")])
    jrc, jout = _run(jesm_prep.main, ["fasta", "--data_dir", str(prep_dir), "--out", str(tmp_path / "jax.fasta")])
    assert rc == jrc == 0 and out.replace("port.fasta", "x") == jout.replace("jax.fasta", "x")
    text = (tmp_path / "port.fasta").read_text()
    assert text == (tmp_path / "jax.fasta").read_text()
    labels = [ln[1:] for ln in text.splitlines() if ln.startswith(">")]
    assert labels == ["syn001_l24r104_chain_0", "syn006_l29r122_chain_0", "twochain_chain_0", "twochain_chain_1"]

    # esm extract's per-record .pt files, chain 1 written before chain 0
    records = esm.fasta_records_for_pdbs({"twochain": str(prep_dir / "twochain.pdb")})
    extract = tmp_path / "extract"
    extract.mkdir()
    rng = np.random.RandomState(0)
    seqs = dict(zip(labels, text.splitlines()[1::2]))
    assert {k: seqs[k] for k in records} == records
    for label in reversed(labels):
        rep = torch.from_numpy(rng.randn(len(seqs[label]), 8).astype(np.float32))
        torch.save({"representations": {esm.ESM_LAYER: rep}}, extract / f"{label}.pt")
    (extract / "notes.txt").write_text("not a record")
    rc, out = _run(cli_main.main, ["esm_prep", "convert", "--extract_dir", str(extract), "--out_dir",
                                   str(tmp_path / "port")])
    jrc, jout = _run(jesm_prep.main, ["convert", "--extract_dir", str(extract), "--out_dir", str(tmp_path / "jax")])
    assert rc == jrc == 0 and out.replace("port", "x") == jout.replace("jax", "x")
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == ["syn001_l24r104.npy", "syn006_l29r122.npy",
                                                              "twochain.npy"]
    for n in names:
        a, b = np.load(tmp_path / "port" / n), np.load(tmp_path / "jax" / n)
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    two = np.load(tmp_path / "port" / "twochain.npy")
    assert two.shape == (368, 8)
    first = torch.load(extract / "twochain_chain_0.pt")["representations"][esm.ESM_LAYER].numpy()
    np.testing.assert_array_equal(two[: len(first)], first)


def test_esm_prep_convert_hf_equals_the_jax_cli(hf_dir, tmp_path):
    d, _ = hf_dir
    rc, out = _run(cli_main.main, ["esm-prep", "convert-hf", "--model", str(d), "--out", str(tmp_path / "p.npz")])
    jrc, _ = _run(jesm_prep.main, ["convert-hf", "--model", str(d), "--out", str(tmp_path / "j.npz")])
    assert rc == jrc == 0 and "converted 2-layer ESM2" in out
    with np.load(tmp_path / "p.npz") as a, np.load(tmp_path / "j.npz") as b:
        assert sorted(a.files) == sorted(b.files) and "meta/num_heads" in a.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_esm_prep_convert_hf_says_it_needs_transformers(monkeypatch, tmp_path, capsys):
    monkeypatch.setitem(sys.modules, "transformers", None)
    assert cli_main.main(["esm-prep", "convert-hf", "--model", "x", "--out", str(tmp_path / "o.npz")]) == 2
    assert "needs the transformers package" in capsys.readouterr().err


class FakeFold:
    """An ESMFold stand-in: out of memory until its chunk size is at most
    ``fits`` (never, with None; the model's default counts as no limit);
    ``error`` raises that instead."""

    def __init__(self, fits, pdb_text, error=None):
        self.fits, self.text, self.error = fits, pdb_text, error
        self.chunks, self.chunk = [], None
        self.trunk = self

    def set_chunk_size(self, chunk):
        self.chunks.append(chunk)
        self.chunk = chunk

    def infer_pdbs(self, seqs):
        assert len(seqs) == 1
        if self.error is not None:
            raise self.error
        if self.fits is None or (self.chunk if self.chunk is not None else 10 ** 9) > self.fits:
            raise RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB")
        return [self.text]


PDB_TEXT = (SYNTH / "syn001_l24r104" / "syn001_l24r104_protein_processed.pdb").read_text()


@pytest.mark.parametrize("fits", [None, 1, 64, 256, 10 ** 9])
def test_fold_sequence_halves_the_chunk_on_oom_as_jax(tmp_path, fits):
    runs = {}
    for pkg, fold in (("port", inference_dataset.fold_sequence), ("jax", jinf.fold_sequence)):
        fake = FakeFold(fits, PDB_TEXT)
        out = tmp_path / f"{pkg}.pdb"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            try:
                fold("MKTAYIAKQR", str(out), model=fake)
                err = None
            except RuntimeError as e:
                err = str(e)
        runs[pkg] = (fake.chunks, err, out.read_text() if out.exists() else None, buf.getvalue())
    assert runs["port"] == runs["jax"]
    chunks, err, text, _ = runs["port"]
    if fits is None:
        assert chunks == [256, 128, 64, 32, 16, 8, 4, 2, 1] and "even at chunk_size=1" in err and text is None
    else:
        want = [c for c in (256, 128, 64, 32, 16, 8, 4, 2, 1) if c >= fits] if fits < 10 ** 9 else []
        assert chunks == want and text == PDB_TEXT


def test_fold_sequence_reraises_other_errors_and_needs_weights(tmp_path):
    fake = FakeFold(None, PDB_TEXT, error=RuntimeError("shape mismatch"))
    with pytest.raises(RuntimeError, match="shape mismatch"):
        inference_dataset.fold_sequence("MK", str(tmp_path / "x.pdb"), model=fake)
    assert fake.chunks == []
    with pytest.raises(RuntimeError, match="ESMFold|transformers"):
        inference_dataset.fold_sequence("MK", str(tmp_path / "y.pdb"))


@pytest.mark.parametrize("exc", [MemoryError(), RuntimeError("CUDA out of memory"),
                                 RuntimeError("DefaultCPUAllocator: can't allocate memory"),
                                 RuntimeError("cannot allocate 4 GB"), RuntimeError("index out of range")])
def test_is_oom_is_the_jax_packages(exc):
    assert inference_dataset._is_oom(exc) == jinf._is_oom(exc)


def test_esmfold_folder_feeds_the_inference_dataset(tmp_path):
    fake = FakeFold(128, PDB_TEXT)
    dataset = inference_dataset.InferenceDatasetBuilder(
        workdir=str(tmp_path), folder=inference_dataset.make_esmfold_folder(fake))
    spec = inference_dataset.InferenceSpec(
        "folded", protein_sequence="MKTAYIAKQR",
        ligand_description=str(SYNTH / "syn001_l24r104" / "syn001_l24r104_ligand.sdf"))
    with contextlib.redirect_stdout(io.StringIO()):
        c = dataset.build(spec)
    assert c.success, c.error
    assert fake.chunks == [256, 128] and (tmp_path / "folded_esmfold.pdb").read_text() == PDB_TEXT
    assert c.data.n_rec == 104


class FakeHubFold(FakeFold):
    """A FakeFold that ``from_pretrained`` hands out, recording where it is
    moved."""

    loaded = []

    def __init__(self):
        super().__init__(10 ** 9, PDB_TEXT)
        self.devices = []
        FakeHubFold.loaded.append(self)

    @classmethod
    def from_pretrained(cls, name, local_files_only=False):
        assert name == "facebook/esmfold_v1" and local_files_only
        return cls()

    def eval(self):
        return self

    def to(self, device):
        self.devices.append(torch.device(device))
        return self


def test_esmfold_is_loaded_once_onto_the_requested_device(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "transformers", types.SimpleNamespace(EsmForProteinFolding=FakeHubFold))
    monkeypatch.setattr(FakeHubFold, "loaded", [])
    sdf = str(SYNTH / "syn001_l24r104" / "syn001_l24r104_ligand.sdf")
    for kwargs, want in (({}, "cuda"), ({"device": "cpu"}, "cpu")):
        FakeHubFold.loaded.clear()
        dataset = inference_dataset.InferenceDatasetBuilder(workdir=str(tmp_path), **kwargs)
        for name in ("a", "b"):
            c = dataset.build(inference_dataset.InferenceSpec(name, protein_sequence="MKTAYIAKQR",
                                                              ligand_description=sdf))
            assert c.success, c.error
        assert [m.devices for m in FakeHubFold.loaded] == [[torch.device(want)]]
    out = inference_dataset.fold_sequence("MK", str(tmp_path / "c.pdb"), device="cpu")
    assert open(out).read() == PDB_TEXT and FakeHubFold.loaded[-1].devices == [torch.device("cpu")]


def _mols(name):
    sdf = str(SYNTH / name / f"{name}_ligand.sdf")
    return chem.read_molecule_file(sdf).remove_hs(), jchem.read_molecule_file(sdf).remove_hs()


@pytest.mark.parametrize("name", LIGANDS)
def test_conformer_functions_equal_jax_bit_for_bit(name):
    assert not jchem.HAVE_RDKIT
    mol, jmol = _mols(name)
    np.testing.assert_array_equal(mol.coords, jmol.coords)
    edges, mask_rotate = conformers.rotatable_edges(mol)
    jedges, jmask = jconf.rotatable_edges(jmol)
    np.testing.assert_array_equal(edges, jedges)
    np.testing.assert_array_equal(mask_rotate, jmask)
    assert len(edges) > 0
    updates = np.random.RandomState(1).uniform(-np.pi, np.pi, len(edges))
    updates[0] = 0.0  # a zero update is skipped
    pos = np.asarray(mol.coords, np.float64)
    moved = conformers.apply_torsion_np(pos, edges, mask_rotate, updates)
    np.testing.assert_array_equal(moved, jconf.apply_torsion_np(pos, jedges, jmask, updates))
    for i, j, _ in mol.bonds:  # torsions keep bond lengths
        assert abs(np.linalg.norm(moved[i] - moved[j]) - np.linalg.norm(pos[i] - pos[j])) < 1e-9
    conf = conformers.generate_conformer(mol, seed=2)
    jc = jconf.generate_conformer(jmol, seed=2)
    np.testing.assert_array_equal(conf.coords, jc.coords)
    assert conf.bonds == jc.bonds and conf.name == jc.name and conf.coords.dtype == np.float32
    assert conformers._aligned_rmsd(moved, pos) == jconf._aligned_rmsd(moved, pos)
    opt, rmsd = conformers.optimize_rotatable_bonds(np.asarray(conf.coords, np.float64), pos, edges, mask_rotate,
                                                    popsize=4, maxiter=3, seed=5)
    jopt, jrmsd = jconf.optimize_rotatable_bonds(np.asarray(jc.coords, np.float64), pos, jedges, jmask,
                                                 popsize=4, maxiter=3, seed=5)
    np.testing.assert_array_equal(opt, jopt)
    assert rmsd == jrmsd
    matched, rmsd = conformers.conformer_match(mol, tries=2, popsize=4, maxiter=3, seed=3)
    jmatched, jrmsd = jconf.conformer_match(jmol, tries=2, popsize=4, maxiter=3, seed=3)
    np.testing.assert_array_equal(matched.coords, jmatched.coords)
    assert rmsd == jrmsd and np.isfinite(rmsd)


def test_a_molecule_without_rotatable_bonds_is_kept():
    mol = chem.Molecule(elements=["C", "O"], coords=np.array([[0, 0, 0], [1.2, 0, 0]], np.float32),
                        bonds=[(0, 1, 2)], charges=[0, 0])
    edges, _ = conformers.rotatable_edges(mol)
    assert edges.shape == (0, 2)
    matched, rmsd = conformers.conformer_match(mol)
    np.testing.assert_array_equal(matched.coords, mol.coords)
    assert rmsd == jconf.conformer_match(jchem.Molecule(elements=["C", "O"], coords=mol.coords,
                                                        bonds=[(0, 1, 2)], charges=[0, 0]))[1]


def _rotation_cases():
    """(label, (N, 3, 3) float32): random rotations and rotations near and
    at 180 degrees about each axis and a skew one (each |q| component
    largest in turn), plus the identity and near-identity."""
    rng = np.random.RandomState(0)
    rand = Rotation.random(32, random_state=rng).as_matrix()
    axes = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 2, -2]], np.float64)
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    near = [Rotation.from_rotvec(a * ang).as_matrix() for a in axes for ang in (np.pi - 1e-3, np.pi - 1e-5, np.pi)]
    small = [Rotation.from_rotvec(v).as_matrix() for v in ([0, 0, 0], [1e-7, 0, 0], [0.01, -0.02, 0.03])]
    return [("random", rand), ("near 180", np.stack(near)), ("near 0", np.stack(small))]


@pytest.mark.parametrize("label,mats", _rotation_cases(), ids=[c[0] for c in _rotation_cases()])
def test_rotation_conversions_match_jax(label, mats):
    m = mats.astype(np.float32)
    q = rotations.matrix_to_quaternion(torch.as_tensor(m)).numpy()
    jq = np.array(jrot.matrix_to_quaternion(jnp.asarray(m)))
    np.testing.assert_allclose(q, jq, rtol=0, atol=ROT_ATOL)
    assert (q[:, 0] >= 0).all()
    aa = rotations.quaternion_to_axis_angle(torch.as_tensor(jq)).numpy()
    np.testing.assert_allclose(aa, np.asarray(jrot.quaternion_to_axis_angle(jnp.asarray(jq))), rtol=0,
                               atol=ROT_ATOL)
    aa = rotations.matrix_to_axis_angle(torch.as_tensor(m)).numpy()
    jaa = np.asarray(jrot.matrix_to_axis_angle(jnp.asarray(m)))
    np.testing.assert_allclose(aa, jaa, rtol=0, atol=4 * ROT_ATOL)
    # back to the matrix
    back = rotations.axis_angle_to_matrix(torch.as_tensor(aa)).numpy()
    np.testing.assert_allclose(back, m, rtol=0, atol=1e-5)
    if label == "near 180":
        assert {int(i) for i in np.argmax(np.abs(q), axis=1)} == {1, 2, 3}
    if label == "near 0":
        assert (np.argmax(np.abs(q), axis=1) == 0).all()


def test_logger_and_file_handler(tmp_path, monkeypatch):
    monkeypatch.setenv("DIFFDOCK_TPU_LOGLEVEL", "warning")
    name = "diffdock_tpu_torch_test"
    log = plog.get_logger(name)
    try:
        assert log is plog.get_logger(name) and log.name == f"{name}.{os.getpid()}"
        assert log.level == logging.WARNING and not log.propagate and len(log.handlers) == 1
        plog.add_file_handler(str(tmp_path / "run.log"), name=name)
        log.info("not written")
        log.warning("written %d", 7)
        for h in log.handlers:
            h.flush()
        text = (tmp_path / "run.log").read_text()
        assert text.endswith(f"] [{name}.{os.getpid()} WARNING] written 7\n") and "not written" not in text
    finally:
        for h in list(log.handlers):
            h.close()
            log.removeHandler(h)


def test_prewarm_on_the_cpu_with_a_narrow_preset():
    argv = ["--device", "cpu", "--model_preset", "diffdock_s", "--confidence_preset", "diffdock_s",
            "--compute_dtype", "float32", "--no_cover_ladder", "--bucket", "8,32,2,2", "--bucket", "8,32,2,2",
            "--inference_steps", "2", "--actual_steps", "1"]
    rc, out = _run(cli_main.main, ["prewarm"] + argv)
    lines = out.splitlines()
    assert rc == 0 and lines[0].startswith("kernels: none built (device cpu")
    assert lines[1].startswith("tables: SO(3)") and lines[-1] == "prewarm complete"
    jobs = [ln for ln in lines if ln.startswith("bucket ")]
    assert len(jobs) == 1 and jobs[0].startswith("bucket nl=8 nr=32 nb=2 poses=2: ")
    assert jobs[0].endswith("peak memory not measured (cpu)")


def test_prewarm_job_list_is_the_jax_commands():
    parse = prewarm.get_parser().parse_args
    assert COVER_LADDER == J_COVER_LADDER
    assert prewarm.jobs_from_args(parse([])) == list(COVER_LADDER)
    jobs = prewarm.jobs_from_args(parse(["--samples_per_complex", "40", "--bucket", "32,192,16,40",
                                         "--bucket", "8,32,2,2"]))
    # cover entries already at 40 poses are not repeated; the explicit
    # duplicate neither
    extra = [(nl, nr, nb, 40) for nl, nr, nb, p in COVER_LADDER if p != 40]
    assert jobs == list(COVER_LADDER) + extra + [(8, 32, 2, 2)]
    assert prewarm.jobs_from_args(parse(["--no_cover_ladder", "--bucket", "8,32,2,2"])) == [(8, 32, 2, 2)]


SKW = dict(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1, lm_embedding_dim=HID)
CKW = _conf_kw(False, HID, 2)
P, SEED, STEPS = 3, 4, 3
DOCK = "syn001_l24r104"


def test_live_embedder_dock_equals_the_table_dock_and_jax(tables, tmp_path):
    js, jt, ps, pt = tables
    lig = str(SYNTH / DOCK / f"{DOCK}_ligand.sdf")
    pdb = str(SYNTH / DOCK / f"{DOCK}_protein_processed.pdb")
    embedder = esm2.TorchESM2Embedder.from_params(random_params(6), esm2.ESM2Config(
        hidden_size=HID, num_layers=2, num_heads=HEADS, intermediate_size=96), device="cpu")
    spec = inference_dataset.InferenceSpec(DOCK, protein_path=pdb, ligand_description=lig)
    mol, prot, lm = inference_dataset.InferenceDatasetBuilder(esm_embedder=embedder).load(spec)
    assert lm.shape == (104, HID)
    np.save(tmp_path / f"{DOCK}.npy", lm)
    tmol, tprot, tlm = inference_dataset.InferenceDatasetBuilder(
        esm_table=esm.LazyNpyTable(str(tmp_path)), esm_embedder=embedder).load(spec)
    np.testing.assert_array_equal(tlm, lm)

    # JAX's models and pipeline, fed the same embeddings
    jmol, jprot = jchem.read_molecule_file(lig), jchem.read_pdb_file(pdb)
    jdata, _ = jfeat.build_complex_data(jmol, jprot, lm)
    nl, nr, nb = bucket_sizes(jdata.n_lig, jdata.n_rec, jdata.n_bonds)
    from diffdock_tpu.data import complexes as j_complexes

    jpad = jax.tree.map(jnp.asarray, j_complexes.pad_to(jdata, nl, nr, nb))
    jscore = jax.jit(JCGScoreModel(JScoreModelConfig(**SKW)).init)(
        jax.random.PRNGKey(2), jpad, jnp.asarray(jpad.lig_pos), jnp.asarray(0.5), js, jt)
    jscore = jax.tree.map(np.asarray, _perturbed(jscore, 2, weights=False))
    _, jconfp = _init_confidence(JScoreModelConfig(**CKW), jpad, js, jt, 3)
    jconfp = jax.tree.map(np.asarray, jconfp)
    sampler = dict(inference_steps=STEPS, actual_steps=STEPS)
    jpipe = JDockingPipeline(JScoreModelConfig(**SKW), jscore, JSamplerConfig(**sampler),
                             confidence_cfg=JScoreModelConfig(**CKW), confidence_params=jconfp,
                             so3_tables=js, torus_tables=jt)
    ref = jpipe.dock_mol_protein(jmol, jprot, str(tmp_path / "jax"), num_poses=P, seed=SEED,
                                 lm_embeddings=lm, save_trajectory=True)

    scfg, ccfg = ScoreModelConfig(**SKW), ScoreModelConfig(**CKW)
    pipe = DockingPipeline(scfg, state_dict_from_flax(jscore, scfg), SamplerConfig(**sampler), ps, pt,
                           device="cpu", confidence_cfg=ccfg, confidence_weights=state_dict_from_flax(jconfp, ccfg))
    kw = dict(num_poses=P, seed=SEED, save_trajectory=True, noise=_jax_noise(STEPS))
    live = pipe.dock_mol_protein(mol, prot, str(tmp_path / "live"), lm_embeddings=lm, **kw)
    table = pipe.dock_mol_protein(tmol, tprot, str(tmp_path / "table"), lm_embeddings=tlm, **kw)
    np.testing.assert_array_equal(live.poses, table.poses)
    np.testing.assert_array_equal(live.confidence, table.confidence)
    np.testing.assert_allclose(live.trajectory[0], ref.trajectory[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(live.trajectory[1], ref.trajectory[1], rtol=0, atol=1e-3)
    assert np.isfinite(live.confidence).all()
    # the LM features reach both models: zeroed embeddings dock elsewhere
    zero = pipe.dock_mol_protein(mol, prot, str(tmp_path / "zero"), lm_embeddings=np.zeros_like(lm), **kw)
    assert np.abs(zero.trajectory[1] - live.trajectory[1]).max() > 1e-3
    data, _, _ = pipe.featurize(mol, prot, lm)
    zdata, _, _ = pipe.featurize(mol, prot, np.zeros_like(lm))
    final = torch.as_tensor(live.poses - np.asarray(data.original_center), dtype=torch.float32)
    final = torch.cat([final, final.new_zeros(P, nl - data.n_lig, 3)], dim=1)
    c_live = pipe.confidence(pipe.confidence_input(data), final).numpy()
    c_zero = pipe.confidence(pipe.confidence_input(zdata), final).numpy()
    assert np.abs(c_live - c_zero).max() > 1e-4 * max(np.abs(c_live).max(), 1.0)
