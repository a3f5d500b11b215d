"""The port's evaluate CLI vs the JAX package's on the CPU.

Small models (a score model and the old coarse-grained confidence model,
with the JAX models' own initial parameters) are written to run directories
by the JAX package's ``save_checkpoint`` and read by both CLIs. Both
evaluate the same two e2e_synth complexes (which share one fine bucket and
one cover entry, so each JAX run compiles one program) with 2 poses and 2
steps, the port with the JAX pipeline's own draws. ``names.npy`` must be
equal, the RMSD, centroid and clash rows within 2e-3 A (the float32 drift
bound of ROADMAP section 3; where a row parts by more, the JAX dock in
float64 arbitrates: the port within 2e-3 A of it and no farther than twice
JAX's own float32 dock), the confidences within 1e-3 of their scale, and
``metrics.json`` the same keys. The all-atom confidence model is in
``tests/test_torch_port_evaluate_aa.py``.
"""

import argparse
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from diffdock_tpu.cli import dock as jdock
from diffdock_tpu.cli import evaluate as jevaluate
from diffdock_tpu.data import complexes as j_complexes
from diffdock_tpu.data import datasets as jds
from diffdock_tpu.data.chem import read_molecule_file as jread
from diffdock_tpu.eval import rmsd as jrmsd
from diffdock_tpu.inference import pipeline as jpipeline_mod
from diffdock_tpu.inference.pipeline import DockingPipeline as JDockingPipeline
from diffdock_tpu.models.config import ScoreModelConfig as JScoreModelConfig
from diffdock_tpu.models.score_model import CGScoreModel as JCGScoreModel
from diffdock_tpu.train.checkpoints import save_checkpoint as jsave
from diffdock_tpu_torch.cli import evaluate
from diffdock_tpu_torch.data.chem import write_sdf
from diffdock_tpu_torch.inference import pipeline as pipeline_mod
from diffdock_tpu_torch.inference.pipeline import DockingPipeline
from tests.test_torch_port_confidence import _conf_kw, _init_confidence, _perturbed, tables  # noqa: F401
from tests.test_torch_port_dock import _jax_draws, _to_f64

REPO = Path(__file__).resolve().parent.parent
SYNTH = REPO / "data" / "e2e_synth"
NAMES = ("syn001_l24r104", "syn132_l23r105")  # both (24, 128, 8) fine, (32, 192) cover
P, STEPS = 2, 2
SKW = dict(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1)
DRIFT = 2e-3  # Angstrom


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def init_params(js, jt, conf_kw):
    """The JAX models' initial parameters (the score model's weights
    unperturbed, so the poses stay near the receptor over the steps)."""
    d = j_complexes.synthetic_aa_complex(np.random.RandomState(0), n_lig=10, n_rec=24, n_bonds=2, atoms_per_res=3)
    jpad = jax.tree.map(jnp.asarray, j_complexes.pad_aa_to(d, 16, 64, 8, 256))
    jscore = jax.jit(JCGScoreModel(JScoreModelConfig(**SKW)).init)(
        jax.random.PRNGKey(2), jpad.base, jnp.asarray(jpad.base.lig_pos), jnp.asarray(0.5), js, jt)
    jscore = jax.tree.map(np.asarray, _perturbed(jscore, 2, weights=False))
    _, jconf = _init_confidence(JScoreModelConfig(**conf_kw), jpad if conf_kw["all_atoms"] else jpad.base,
                                js, jt, 3)
    return jscore, jax.tree.map(np.asarray, jconf)


def write_run_dirs(root, jscore, jconf, conf_kw):
    jsave(str(root / "score"), jscore, JScoreModelConfig(**SKW))
    jsave(str(root / "confidence"), jconf, JScoreModelConfig(**conf_kw))
    return root / "score", root / "confidence"


def patch_tables_and_draws(monkeypatch, tables):  # noqa: F811
    js, jt, ps, pt = tables
    monkeypatch.setattr(jpipeline_mod, "get_so3_tables", lambda *a, **k: js)
    monkeypatch.setattr(jpipeline_mod, "get_torus_tables", lambda *a, **k: jt)
    monkeypatch.setattr(pipeline_mod, "get_so3_tables", lambda *a, **k: ps)
    monkeypatch.setattr(pipeline_mod, "get_torus_tables", lambda *a, **k: pt)
    monkeypatch.setattr(DockingPipeline, "draw_noise",
                        lambda self, num_poses, n_bonds, seed: _jax_draws(seed, num_poses, n_bonds, STEPS))


def split_file(tmp_path, names=NAMES):
    path = tmp_path / "split.txt"
    path.write_text("\n".join(names) + "\n")
    return str(path)


def argv(tmp_path, score_dir, conf_dir, *extra):
    return ["--data_dir", str(SYNTH), "--split", split_file(tmp_path), "--model_dir", str(score_dir),
            "--confidence_model_dir", str(conf_dir), "--samples_per_complex", str(P), "--inference_steps",
            str(STEPS), "--actual_steps", str(STEPS), *extra]


def float64_rmsds(jscore, jconf, conf_kw, tables, args, name, cache):  # noqa: F811
    """The sorted per-pose RMSDs of the JAX CLI's dock of ``name`` in float64:
    the same parameters, tables, sampler, bucket ladder and float32 draws,
    widened."""
    js, jt, _, _ = tables
    cfg = jds.DatasetConfig(cache_dir=cache, all_atoms=conf_kw["all_atoms"])
    spec = next(s for s in jds.pdbbind_specs(str(SYNTH), None) if s.name == name)
    ds = jds.ComplexDataset([spec], cfg)
    ds.preprocess(verbose=False)
    item = ds.get(name)
    normal, uniform = jax.random.normal, jax.random.uniform
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", lambda k, shape=(), dtype=None: normal(
            k, shape, jnp.float32).astype(jnp.float64))
        mp.setattr(jax.random, "uniform", lambda k, shape=(), dtype=None, minval=0.0, maxval=1.0: uniform(
            k, shape, jnp.float32, minval, maxval).astype(jnp.float64))
        pipe = JDockingPipeline(JScoreModelConfig(**SKW), _to_f64(jscore), jdock.sampler_config_from_args(args),
                                confidence_cfg=JScoreModelConfig(**conf_kw), confidence_params=_to_f64(jconf),
                                so3_tables=_to_f64(js), torus_tables=_to_f64(jt), bucket_ladder=args.bucket_ladder)
        if conf_kw["all_atoms"]:
            base = type(item.base)(*[None if a is None else _to_f64(a) for a in item.base])
            data, aa = base, type(item)(base, *[_to_f64(a) for a in item[1:]])
        else:
            data, aa = type(item)(*[None if a is None else _to_f64(a) for a in item]), None
        res = pipe.dock_complex(data, num_poses=P, seed=args.seed, aa_data=aa)
    assert res.poses.dtype == np.float64
    mol = jread(spec.ligand_path).remove_hs()
    ref = np.asarray(data.lig_pos) + np.asarray(data.original_center)
    return np.sort(jrmsd.symmetry_rmsd(ref, res.poses, mol.elements, [(i, j) for i, j, _ in mol.bonds]))


def assert_rows_match(ours, ref, arbiter):
    """Rows within DRIFT of each other or, where a row parts by more, held to
    the float64 dock by ``arbiter(i)`` (sorted RMSDs of row i)."""
    for i in range(len(ref)):
        gap = np.abs(ours[i] - ref[i]).max()
        if gap <= DRIFT:
            continue
        r64 = arbiter(i)
        err_port, err_jax = np.abs(np.sort(ours[i]) - r64).max(), np.abs(np.sort(ref[i]) - r64).max()
        assert err_port <= DRIFT and err_port <= 2 * err_jax, (i, gap, err_port, err_jax)


@pytest.fixture(scope="module")
def run_dirs(tables, tmp_path_factory):  # noqa: F811
    js, jt, _, _ = tables
    conf_kw = _conf_kw(False, 0, 2)
    jscore, jconf = init_params(js, jt, conf_kw)
    root = tmp_path_factory.mktemp("runs")
    return (jscore, jconf, conf_kw) + write_run_dirs(root, jscore, jconf, conf_kw)


@pytest.mark.parametrize("ladder", ["cover", "fine"])
def test_evaluate_matches_the_jax_cli(run_dirs, tables, monkeypatch, tmp_path, ladder):  # noqa: F811
    jscore, jconf, conf_kw, score_dir, conf_dir = run_dirs
    patch_tables_and_draws(monkeypatch, tables)
    base = argv(tmp_path, score_dir, conf_dir, "--bucket_ladder", ladder)
    jout, out = tmp_path / "jax", tmp_path / "port"
    assert jevaluate.main(base + ["--out_dir", str(jout), "--cache_path", str(tmp_path / "jc"),
                                  "--compute_dtype", "float32"]) == 0
    assert evaluate.main(base + ["--out_dir", str(out), "--cache_path", str(tmp_path / "pc"),
                                 "--compute_dtype", "float32", "--device", "cpu"]) == 0
    files = sorted(os.listdir(jout))
    assert sorted(os.listdir(out)) == files and len(files) == 7
    np.testing.assert_array_equal(np.load(out / "names.npy"), np.load(jout / "names.npy"))
    assert np.load(out / "names.npy").tolist() == list(NAMES)
    args = jevaluate.get_parser().parse_args(base)
    rmsds, jrmsds = np.load(out / "rmsds.npy"), np.load(jout / "rmsds.npy")
    assert rmsds.shape == (2, P) and np.isfinite(rmsds).all()
    assert_rows_match(rmsds, jrmsds, lambda i: float64_rmsds(jscore, jconf, conf_kw, tables, args, NAMES[i],
                                                             str(tmp_path / "c64")))
    for f in ("centroid_distances.npy", "min_self_distances.npy"):
        np.testing.assert_allclose(np.load(out / f), np.load(jout / f), rtol=0, atol=DRIFT)
    conf, jconf_rows = np.load(out / "confidences.npy"), np.load(jout / "confidences.npy")
    np.testing.assert_allclose(conf, jconf_rows, rtol=0, atol=1e-3 * max(np.abs(jconf_rows).max(), 1))
    metrics, jmetrics = (json.loads((d / "metrics.json").read_text()) for d in (out, jout))
    assert sorted(metrics) == sorted(jmetrics) and metrics["failures"] == jmetrics["failures"] == 0
    assert np.load(out / "run_times.npy").shape == (2,)


def test_chip_smoke_metric_keys_are_the_jax_clis(tmp_path):
    """The key list phase D of chip_smoke.py holds metrics.json to is what
    the JAX CLI writes for 10 poses per complex."""
    rows = np.ones((3, 10))
    table = jevaluate.emit_metric_tables(str(tmp_path), ["a", "b", "c"], rows, rows, [1.0, 2.0, 3.0], rows, rows, 0)
    assert sorted(table) == sorted(chip_smoke.EVAL_METRIC_KEYS)
    assert chip_smoke.PENALTY_RMSD == 10000.0
    assert set(chip_smoke.EVAL_COMPLEXES) <= {p.name for p in SYNTH.iterdir()}


def test_parser_has_every_jax_flag_with_its_default():
    def flags(parser):
        return {a.dest: (tuple(sorted(a.option_strings)), a.default, getattr(a, "choices", None))
                for a in parser._actions if not isinstance(a, argparse._HelpAction)}

    ours, ref = flags(evaluate.get_parser()), flags(jevaluate.get_parser())
    assert set(ours) - set(ref) == {"device"} and set(ref) <= set(ours)
    assert ours["device"][:2] == (("--device",), "cuda")
    assert {k for k in ref if ours[k] != ref[k]} == set()
    assert ours["compute_dtype"][1] == ref["compute_dtype"][1] == "bfloat16"
    assert "--device" in evaluate.get_parser().format_help()


def test_unported_options_raise(run_dirs, tables, monkeypatch, tmp_path):  # noqa: F811
    _, _, _, score_dir, conf_dir = run_dirs
    base = argv(tmp_path, score_dir, conf_dir, "--device", "cpu", "--out_dir", str(tmp_path / "o"),
                "--cache_path", str(tmp_path / "c"))
    # ROADMAP queue 1 item 8 is ported: 0 means every visible device, one
    # on the CPU, so the pipeline has no mesh (test_torch_port_parallel_cli.py
    # runs the multi-rank sweep)
    from diffdock_tpu_torch.parallel.mesh import CPU_DEVICES_ENV

    monkeypatch.delenv(CPU_DEVICES_ENV, raising=False)
    patch_tables_and_draws(monkeypatch, tables)
    pipe = evaluate.build_pipeline(evaluate.get_parser().parse_args(base + ["--complex_devices", "0"]))
    assert pipe.mesh is None and pipe.mesh_size == 1
    # --compute_dtype (default bfloat16, as in the JAX CLI) reaches the score
    # model's conv layers; the confidence model keeps its run directory's
    for extra, dtype in (([], "bfloat16"), (["--compute_dtype", "float32"], "float32")):
        pipe = evaluate.build_pipeline(evaluate.get_parser().parse_args(base + extra))
        assert pipe.score_cfg.compute_dtype == dtype
        assert {m.dtype for m in pipe.model.conv_layers} == {dtype}
        assert pipe.confidence_cfg.compute_dtype == "float32"
    # the crop options are ported: they reach the pipeline
    args = evaluate.get_parser().parse_args(base + ["--crop_beyond", "5", "--pocket_capacity", "10"])
    pipe = evaluate.build_pipeline(args)
    assert pipe.score_cfg.crop_beyond == 5.0 and pipe.pocket_capacity == 10
    with pytest.raises(SystemExit, match="not found"):
        evaluate.main(base + ["--no_rec_overlap_names", str(tmp_path / "absent.txt")])


def test_pocket_options_set_the_sampler_as_jax_does(run_dirs, tables, monkeypatch, tmp_path):  # noqa: F811
    _, _, _, score_dir, conf_dir = run_dirs
    patch_tables_and_draws(monkeypatch, tables)
    for extra in ([], ["--pocket_knowledge"], ["--pocket_knowledge", "--different_schedules", "--pocket_tr_max", "4"],
                  ["--no_random_pocket"]):
        base = argv(tmp_path, score_dir, conf_dir, *extra)
        pipe = evaluate.build_pipeline(evaluate.get_parser().parse_args(base + ["--device", "cpu"]))
        ref = jevaluate.get_parser().parse_args(base)
        # the JAX CLI's own rule, on the sigma schedule both pipelines hold
        t_max, sc = 1.0, pipe.score_cfg.sigma
        if ref.pocket_knowledge and ref.different_schedules:
            t_max = (np.log(ref.pocket_tr_max) - np.log(sc.tr_sigma_min)) / (
                np.log(sc.tr_sigma_max) - np.log(sc.tr_sigma_min))
        cfg = pipe.sampler_cfg
        if extra:
            assert cfg.t_max == t_max and cfg.no_random_pocket == ref.no_random_pocket
            assert cfg.pocket_tr_max == (ref.pocket_tr_max if ref.pocket_knowledge else None)
        assert cfg.initial_noise_std_proportion == -1.0 and cfg.no_final_step_noise is False
        assert pipe.bucket_ladder == "cover" and pipe.anomaly_guard == 0.0


def test_pocket_knowledge_docks_at_the_true_pocket(run_dirs, tables, monkeypatch, tmp_path):  # noqa: F811
    """--pocket_knowledge starts the poses at true_pocket_center (equal to
    the JAX CLI's), with translation noise of pocket_tr_max."""
    _, _, _, score_dir, conf_dir = run_dirs
    patch_tables_and_draws(monkeypatch, tables)
    centers = []
    real = DockingPipeline.dock_complex

    def spy(self, data, **kw):
        centers.append(kw.get("pocket_center"))
        return real(self, data, **kw)

    monkeypatch.setattr(DockingPipeline, "dock_complex", spy)
    out = tmp_path / "o"
    assert evaluate.main(argv(tmp_path, score_dir, conf_dir, "--pocket_knowledge", "--device", "cpu", "--out_dir",
                              str(out), "--cache_path", str(tmp_path / "c"))) == 0
    ds = jds.ComplexDataset(jds.pdbbind_specs(str(SYNTH), split_file(tmp_path)),
                            jds.DatasetConfig(cache_dir=str(tmp_path / "jc")))
    ds.preprocess(verbose=False)
    for name, c in zip(NAMES, centers):
        np.testing.assert_array_equal(c, jevaluate.true_pocket_center(ds.get(name), 5.0))
        np.testing.assert_array_equal(c, evaluate.true_pocket_center(ds.get(name), 5.0))
    # far from everything: the closest residue
    d = ds.get(NAMES[0])
    far = d._replace(lig_pos=np.asarray(d.lig_pos) + 1000.0)
    np.testing.assert_array_equal(evaluate.true_pocket_center(far, 5.0), jevaluate.true_pocket_center(far, 5.0))


def test_failures_become_penalty_rows(run_dirs, tables, monkeypatch, tmp_path, capsys):  # noqa: F811
    """A complex whose dock fails every retry is a penalty row with a NaN run
    time, counted in metrics.json, and the retry halves the chunk first."""
    _, _, _, score_dir, conf_dir = run_dirs
    patch_tables_and_draws(monkeypatch, tables)
    real = DockingPipeline.dock_complex
    calls = []

    def flaky(self, data, **kw):
        calls.append(kw.get("batch_size"))
        if data.n_lig == 23:
            raise RuntimeError("CUDA out of memory")
        return real(self, data, **kw)

    monkeypatch.setattr(DockingPipeline, "dock_complex", flaky)
    out = tmp_path / "o"
    assert evaluate.main(argv(tmp_path, score_dir, conf_dir, "--device", "cpu", "--out_dir", str(out),
                              "--cache_path", str(tmp_path / "c"), "--gnina_minimize")) == 0
    assert calls == [None, None, 1]  # the first complex, then 2 -> 1 for the failing one
    assert "retry with pose chunks of 1" in capsys.readouterr().out
    rmsds, rt = np.load(out / "rmsds.npy"), np.load(out / "run_times.npy")
    assert np.isfinite(rmsds[0]).all() and (rmsds[1] == 10000.0).all()
    assert (np.load(out / "confidences.npy")[1] == -10000.0).all() and np.isnan(rt[1]) and np.isfinite(rt[0])
    # gnina is not on PATH: the input poses are kept with score 0
    assert np.load(out / "gnina_scores.npy").tolist() == [[0.0], [-10000.0]]
    metrics = json.loads((out / "metrics.json").read_text())
    assert metrics["failures"] == 1 and metrics["run_times_mean"] == pytest.approx(rt[0])


def test_posebusters_and_moad_modes(run_dirs, tables, monkeypatch, tmp_path):  # noqa: F811
    """posebusters: the least RMSD over every pose of {name}_ligands.sdf (here
    the crystal pose and a translated copy) is at most the pdbbind mode's;
    moad: one row per ligand file, the same receptor shared."""
    _, _, _, score_dir, conf_dir = run_dirs
    patch_tables_and_draws(monkeypatch, tables)
    from diffdock_tpu_torch.data.chem import read_molecule_file, write_pdb_ligand

    name = NAMES[0]
    pb = tmp_path / "pb" / name
    pb.mkdir(parents=True)
    pdb = (SYNTH / name / f"{name}_protein_processed.pdb").read_text()
    sdf = SYNTH / name / f"{name}_ligand.sdf"
    (pb / f"{name}_protein.pdb").write_text(pdb)
    (pb / f"{name}_ligand.sdf").write_text(sdf.read_text())
    mol = read_molecule_file(str(sdf))
    (pb / f"{name}_ligands.sdf").write_text(write_sdf(mol) + write_sdf(mol, mol.coords + 3.0))
    common = ["--model_dir", str(score_dir), "--confidence_model_dir", str(conf_dir), "--samples_per_complex",
              str(P), "--inference_steps", str(STEPS), "--actual_steps", str(STEPS), "--device", "cpu"]
    assert evaluate.main(common + ["--data_dir", str(tmp_path / "pb"), "--dataset", "posebusters", "--out_dir",
                                   str(tmp_path / "o_pb"), "--cache_path", str(tmp_path / "c1")]) == 0
    assert evaluate.main(common + ["--data_dir", str(tmp_path / "pb"), "--protein_file", "protein", "--out_dir",
                                   str(tmp_path / "o_pdb"), "--cache_path", str(tmp_path / "c2")]) == 0
    r_pb, r_pdb = np.load(tmp_path / "o_pb" / "rmsds.npy"), np.load(tmp_path / "o_pdb" / "rmsds.npy")
    assert r_pb.shape == r_pdb.shape == (1, P) and (r_pb <= r_pdb + 1e-9).all()

    moad = tmp_path / "moad"
    (moad / "pdb_protein").mkdir(parents=True)
    (moad / "pdb_ligand").mkdir()
    (moad / "pdb_protein" / "s001_1_protein.pdb").write_text(pdb)
    heavy = mol.remove_hs()
    for i, shift in enumerate((0.0, 1.0)):
        (moad / "pdb_ligand" / f"s001_1_A_{i}.pdb").write_text(write_pdb_ligand(heavy, heavy.coords + shift))
    out = tmp_path / "o_moad"
    assert evaluate.main(common + ["--data_dir", str(moad), "--dataset", "moad", "--out_dir", str(out),
                                   "--cache_path", str(tmp_path / "c3")]) == 0
    assert np.load(out / "names.npy").tolist() == ["s001_1_A_0", "s001_1_A_1"]
    rm = np.load(out / "rmsds.npy")
    assert rm.shape == (2, P) and np.isfinite(rm).all()
