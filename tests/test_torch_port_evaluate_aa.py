"""The evaluate CLI with the shipped kind of confidence model, the old
all-atom architecture, on the CPU.

A fact of the reference, checked here: the JAX package's evaluate CLI
builds its dataset without the receptor's atoms and docks without them, so
with an all-atom confidence model its pipeline refuses every dock
(``all-atom confidence needs aa_data``) and every complex becomes a penalty
row. The port's CLI featurizes the atoms and passes them, so the model
ranks the poses; it is held here to the JAX pipeline's ``dock_complex`` fed
the JAX package's own all-atom dataset shards, with the tolerances of
``tests/test_torch_port_evaluate.py`` (rows within 2e-3 A, a float64 JAX dock
arbitrating where they part by more).
"""

import json

import numpy as np
import pytest
import torch

from diffdock_tpu.cli import dock as jdock
from diffdock_tpu.cli import evaluate as jevaluate
from diffdock_tpu.data import datasets as jds
from diffdock_tpu.data.chem import read_molecule_file as jread
from diffdock_tpu.eval import rmsd as jrmsd
from diffdock_tpu.inference.pipeline import DockingPipeline as JDockingPipeline
from diffdock_tpu.models.config import ScoreModelConfig as JScoreModelConfig
from diffdock_tpu_torch.cli import evaluate
from tests.test_torch_port_confidence import _conf_kw, tables  # noqa: F401
from tests.test_torch_port_evaluate import (
    NAMES,
    P,
    SKW,
    SYNTH,
    argv,
    assert_rows_match,
    float64_rmsds,
    init_params,
    patch_tables_and_draws,
    split_file,
    write_run_dirs,
)

CONF_KW = _conf_kw(True, 0, 2)
NEW_CONF_KW = dict(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1, confidence_mode=True, all_atoms=True)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run_dirs(tables, tmp_path_factory):  # noqa: F811
    js, jt, _, _ = tables
    jscore, jconf = init_params(js, jt, CONF_KW)
    return (jscore, jconf) + write_run_dirs(tmp_path_factory.mktemp("runs_aa"), jscore, jconf, CONF_KW)


def test_the_jax_cli_gives_penalty_rows_with_an_all_atom_confidence_model(run_dirs, tables, monkeypatch,  # noqa: F811
                                                                          tmp_path, capsys):
    _, _, score_dir, conf_dir = run_dirs
    patch_tables_and_draws(monkeypatch, tables)
    out = tmp_path / "jax"
    assert jevaluate.main(argv(tmp_path, score_dir, conf_dir, "--out_dir", str(out), "--cache_path",
                               str(tmp_path / "jc"), "--compute_dtype", "float32")) == 0
    printed = capsys.readouterr().out
    assert printed.count("] failed: AssertionError: all-atom confidence needs aa_data") == len(NAMES)
    assert (np.load(out / "rmsds.npy") == 10000.0).all()
    assert (np.load(out / "confidences.npy") == -10000.0).all()
    assert json.loads((out / "metrics.json").read_text())["failures"] == len(NAMES)


def test_the_port_cli_ranks_like_the_jax_pipeline_on_all_atom_shards(run_dirs, tables, monkeypatch,  # noqa: F811
                                                                     tmp_path):
    _cli_against_jax_pipeline(run_dirs, CONF_KW, tables, monkeypatch, tmp_path)


@pytest.fixture(scope="module")
def new_run_dirs(tables, tmp_path_factory):  # noqa: F811
    js, jt, _, _ = tables
    jscore, jconf = init_params(js, jt, NEW_CONF_KW)
    return (jscore, jconf) + write_run_dirs(tmp_path_factory.mktemp("runs_new_aa"), jscore, jconf, NEW_CONF_KW)


def test_the_port_cli_ranks_with_a_new_all_atom_confidence_model(new_run_dirs, tables, monkeypatch,  # noqa: F811
                                                                 tmp_path):
    """The same sweep ranked by a new-architecture ``AAScoreModel``
    confidence run directory (with a protein-embedding layer)."""
    _cli_against_jax_pipeline(new_run_dirs, NEW_CONF_KW, tables, monkeypatch, tmp_path)


def _cli_against_jax_pipeline(run_dirs, conf_kw, tables, monkeypatch, tmp_path):  # noqa: F811
    """The port's evaluate CLI against the JAX pipeline's ``dock_complex``
    fed the JAX package's all-atom shards: RMSD rows and confidences."""
    jscore, jconf, score_dir, conf_dir = run_dirs
    js, jt, _, _ = tables
    patch_tables_and_draws(monkeypatch, tables)
    base = argv(tmp_path, score_dir, conf_dir)
    out = tmp_path / "port"
    assert evaluate.main(base + ["--out_dir", str(out), "--cache_path", str(tmp_path / "pc"),
                                 "--compute_dtype", "float32", "--device", "cpu"]) == 0
    metrics = json.loads((out / "metrics.json").read_text())
    assert metrics["failures"] == 0 and np.load(out / "names.npy").tolist() == list(NAMES)

    args = jevaluate.get_parser().parse_args(base + ["--compute_dtype", "float32"])
    ds = jds.ComplexDataset(jds.pdbbind_specs(str(SYNTH), split_file(tmp_path)),
                            jds.DatasetConfig(cache_dir=str(tmp_path / "jc"), all_atoms=True))
    ds.preprocess(verbose=False)
    jpipe = JDockingPipeline(JScoreModelConfig(**SKW), jscore, jdock.sampler_config_from_args(args),
                             confidence_cfg=JScoreModelConfig(**conf_kw), confidence_params=jconf,
                             so3_tables=js, torus_tables=jt, bucket_ladder="cover")
    rows, confs = [], []
    for name in NAMES:
        aa = ds.get(name)
        res = jpipe.dock_complex(aa.base, num_poses=P, seed=args.seed, aa_data=aa)
        mol = jread(str(SYNTH / name / f"{name}_ligand.sdf")).remove_hs()
        ref = np.asarray(aa.base.lig_pos) + np.asarray(aa.base.original_center)
        rows.append(jrmsd.symmetry_rmsd(ref, res.poses[res.order], mol.elements,
                                        [(i, j) for i, j, _ in mol.bonds]))
        confs.append(np.asarray(res.confidence)[res.order])
    rmsds = np.load(out / "rmsds.npy")
    assert rmsds.shape == (len(NAMES), P) and np.isfinite(rmsds).all() and (rmsds < 10000.0).all()
    assert_rows_match(rmsds, np.asarray(rows), lambda i: float64_rmsds(jscore, jconf, conf_kw, tables, args,
                                                                       NAMES[i], str(tmp_path / "c64")))
    confs = np.asarray(confs)
    np.testing.assert_allclose(np.load(out / "confidences.npy"), confs, rtol=0,
                               atol=1e-3 * max(np.abs(confs).max(), 1))
