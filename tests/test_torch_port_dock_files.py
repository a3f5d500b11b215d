"""Docking from files: the port's pipeline and CLI vs the JAX package's on the CPU.

A small score model (ns=8, nv=2) and a small old all-atom confidence model
with the same flax parameters in both packages, the 3-step schedule, and
the JAX pipeline's own ``jax.random`` draws injected into the port. One
``data/e2e_synth`` complex goes from its SDF and PDB through
``dock_mol_protein`` of both packages.

On this real complex the two float32 docks drift apart by more than 1e-3 A
over the three steps (1.4e-3 to 3.7e-3 A over seeds 4-6), about tenfold a
step. The float64 JAX dock (same parameters and draws, widened) arbitrates:
the port lies 0.4e-3 to 1.7e-3 A from it, JAX's float32 dock 1.3e-3 to
2.2e-3 A, so the gap is float32 rounding amplified by the sampler, not a
difference of the computation. The tests therefore hold the port to JAX
step by step where the drift has not grown: the start poses within 1e-4 A,
the poses after the first step within 1e-3 A; the whole trajectory to the
float64 dock within 2e-3 A and no farther than twice JAX's own float32
dock; the confidence model on JAX's final poses within 1e-4 x
max(max|conf|, 1) of JAX's confidences. The same start and first-step
checks hold with a pocket center and in pose chunks (``batch_size``),
whose chunks and joint ranking are also checked against the port's own
chunk-by-chunk docks, exactly. The SDF and trajectory PDB texts of the
port's writer equal the JAX package's for the same poses; the port's CLI
writes the port pipeline's files from run directories, byte for byte.
"""

import argparse
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdock_tpu.cli import dock as jdock
from diffdock_tpu.data import chem as jchem
from diffdock_tpu.data import featurize as jfeat
from diffdock_tpu.inference.pipeline import DockingPipeline as JDockingPipeline
from diffdock_tpu.inference.sampler import SamplerConfig as JSamplerConfig
from diffdock_tpu.models.config import ScoreModelConfig as JScoreModelConfig
from diffdock_tpu.models.score_model import CGScoreModel as JCGScoreModel
from diffdock_tpu_torch.cli import dock
from diffdock_tpu_torch.data import chem
from diffdock_tpu_torch.data.complexes import atom_bucket, bucket_sizes
from diffdock_tpu_torch.inference import pipeline as pipeline_mod
from diffdock_tpu_torch.inference.pipeline import DockingPipeline, DockingResult, write_ranked_poses
from diffdock_tpu_torch.inference.sampler import SamplerConfig
from diffdock_tpu_torch.models.config import ConfigError, ScoreModelConfig
from diffdock_tpu_torch.models.tpconv import _ConvBase
from diffdock_tpu_torch.ops import fused_tp3 as ft
from diffdock_tpu_torch.train.checkpoints import save_checkpoint
from diffdock_tpu_torch.utils.convert import state_dict_from_flax
from tests.test_torch_port_confidence import _conf_kw, _init_confidence, _perturbed, tables  # noqa: F401
from tests.test_torch_port_dock import _jax_draws, _jax_noise, _to_f64

REPO = Path(__file__).resolve().parent.parent
SYNTH = REPO / "data" / "e2e_synth"
NAME = "syn001_l24r104"  # 24 ligand atoms, 104 residues
OTHER = "syn006_l29r122"
P, SEED, STEPS = 3, 4, 3
SKW = dict(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1)
CKW = _conf_kw(True, 0, 2)
SAMPLER = dict(inference_steps=STEPS, actual_steps=STEPS)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _files(name):
    d = SYNTH / name
    return str(d / f"{name}_ligand.sdf"), str(d / f"{name}_protein_processed.pdb")


@pytest.fixture(scope="module")
def setup(tables, tmp_path_factory):
    """Both pipelines with the same parameters, and the JAX pipeline's dock
    of NAME from its files (3 poses, trajectories written)."""
    js, jt, ps, pt = tables
    lig, pdb = _files(NAME)
    jmol, jprot = jchem.read_molecule_file(lig), jchem.read_pdb_file(pdb)
    jaa, _ = jfeat.build_aa_complex_data(jmol, jprot)
    nl, nr, nb = bucket_sizes(jaa.base.n_lig, jaa.base.n_rec, jaa.base.n_bonds)
    jpad = jax.tree.map(jnp.asarray, jfeat_pad(jaa, nl, nr, nb))
    jscore = jax.jit(JCGScoreModel(JScoreModelConfig(**SKW)).init)(
        jax.random.PRNGKey(2), jpad.base, jnp.asarray(jpad.base.lig_pos), jnp.asarray(0.5), js, jt)
    # the score model's weights as initialized, so the poses stay near the
    # receptor over the steps
    jscore = jax.tree.map(np.asarray, _perturbed(jscore, 2, weights=False))
    _, jconf = _init_confidence(JScoreModelConfig(**CKW), jpad, js, jt, 3)
    jconf = jax.tree.map(np.asarray, jconf)
    jpipe = JDockingPipeline(JScoreModelConfig(**SKW), jscore, JSamplerConfig(**SAMPLER),
                             confidence_cfg=JScoreModelConfig(**CKW), confidence_params=jconf,
                             so3_tables=js, torus_tables=jt)
    out = tmp_path_factory.mktemp("jax_dock")
    ref = jpipe.dock_mol_protein(jmol, jprot, str(out), num_poses=P, seed=SEED, save_trajectory=True)
    ref64 = _float64_dock(jscore, jconf, js, jt, jaa, SEED)
    score_cfg, conf_cfg = ScoreModelConfig(**SKW), ScoreModelConfig(**CKW)
    pipe = DockingPipeline(score_cfg, state_dict_from_flax(jscore, score_cfg), SamplerConfig(**SAMPLER),
                           ps, pt, device="cpu", confidence_cfg=conf_cfg,
                           confidence_weights=state_dict_from_flax(jconf, conf_cfg))
    return dict(jpipe=jpipe, pipe=pipe, ref=ref, ref64=ref64, ref_dir=out, nb=nb, jscore=jscore,
                jconf=jconf)


def _float64_dock(jscore, jconf, js, jt, jaa, seed):
    """The JAX pipeline's dock in float64: the same parameters, tables,
    complex and float32 draws, widened (float64 draws from the same key
    differ)."""
    normal, uniform = jax.random.normal, jax.random.uniform
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", lambda k, shape=(), dtype=None: normal(
            k, shape, jnp.float32).astype(jnp.float64))
        mp.setattr(jax.random, "uniform", lambda k, shape=(), dtype=None, minval=0.0, maxval=1.0: uniform(
            k, shape, jnp.float32, minval, maxval).astype(jnp.float64))
        pipe = JDockingPipeline(JScoreModelConfig(**SKW), _to_f64(jscore), JSamplerConfig(**SAMPLER),
                                confidence_cfg=JScoreModelConfig(**CKW), confidence_params=_to_f64(jconf),
                                so3_tables=_to_f64(js), torus_tables=_to_f64(jt))
        base = type(jaa.base)(*[None if a is None else _to_f64(a) for a in jaa.base])
        aa = type(jaa)(base, *[_to_f64(a) for a in jaa[1:]])
        out = pipe.dock_complex(base, num_poses=P, seed=seed, aa_data=aa, return_trajectory=True)
    assert out.poses.dtype == np.float64
    return out


def jfeat_pad(jaa, nl, nr, nb):
    from diffdock_tpu.data import complexes as j_complexes

    return j_complexes.pad_aa_to(jaa, nl, nr, nb, atom_bucket(jaa.n_atoms))


def _assert_steps_match(res, ref):
    """Start poses within 1e-4 A and the poses after the first step within
    1e-3 A of the JAX dock's (the whole trajectory is checked against the
    float64 dock where that matters)."""
    assert res.trajectory.shape == ref.trajectory.shape == (STEPS + 1,) + ref.poses.shape
    np.testing.assert_allclose(res.trajectory[0], ref.trajectory[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(res.trajectory[1], ref.trajectory[1], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(res.trajectory[-1], res.poses)
    assert res.affinity is None and sorted(res.order) == list(range(len(ref.order)))
    np.testing.assert_array_equal(res.order, np.argsort(-res.confidence))


def test_dock_mol_protein_matches_jax(setup, tmp_path):
    lig, pdb = _files(NAME)
    mol, prot = chem.read_molecule_file(lig), chem.read_pdb_file(pdb)
    pipe, ref, ref64 = setup["pipe"], setup["ref"], setup["ref64"]
    before = ft.counts.as_dict()
    res = pipe.dock_mol_protein(mol, prot, str(tmp_path), num_poses=P, seed=SEED, save_trajectory=True,
                                noise=_jax_noise(STEPS))
    after = ft.counts.as_dict()
    assert after["fused_tp3"] == before["fused_tp3"]  # the plain version on the CPU
    _assert_steps_match(res, ref)
    # the float64 dock arbitrates the whole trajectory
    err_port = np.abs(res.trajectory - ref64.trajectory).max()
    err_jax = np.abs(ref.trajectory - ref64.trajectory).max()
    assert err_port <= 2e-3 and err_port <= 2 * err_jax, (err_port, err_jax)
    # the confidence model on JAX's final poses gives JAX's confidences
    data, aa, _ = pipe.featurize(mol, prot)
    final = torch.as_tensor(ref.poses - np.asarray(data.original_center), dtype=torch.float32)
    nl = bucket_sizes(data.n_lig, data.n_rec, data.n_bonds)[0]
    final = torch.cat([final, final.new_zeros(P, nl - data.n_lig, 3)], dim=1)
    conf = pipe.confidence(pipe.confidence_input(data, aa), final).numpy()
    np.testing.assert_allclose(conf, ref.confidence, rtol=0, atol=1e-4 * max(np.abs(ref.confidence).max(), 1))
    # the ranked files
    written = sorted(os.listdir(tmp_path))
    assert written == sorted(["rank1.sdf"] + [f"rank{r + 1}_confidence{res.confidence[i]:.2f}.sdf"
                                              for r, i in enumerate(res.order) if r]
                             + [f"rank{r}_reverseprocess.pdb" for r in range(1, P + 1)])
    for r, i in enumerate(res.order):
        name = "rank1.sdf" if r == 0 else f"rank{r + 1}_confidence{res.confidence[i]:.2f}.sdf"
        text = (tmp_path / name).read_text()
        assert f"> <confidence>\n{res.confidence[i]:.4f}\n" in text
        back = chem.parse_sdf(text)[0]
        assert back.elements == mol.remove_hs().elements
        np.testing.assert_allclose(back.coords, res.poses[i], rtol=0, atol=5e-5 + 1e-4)
    assert sorted(f for f in os.listdir(setup["ref_dir"]) if f.endswith(".pdb")) == \
        sorted(f for f in written if f.endswith(".pdb"))
    # dock_files: the same dock from the two paths, its own draws
    res2 = pipe.dock_files(pdb, lig, str(tmp_path / "files"), num_poses=2, seed=1)
    assert res2.poses.shape == (2, data.n_lig, 3) and np.isfinite(res2.poses).all()
    assert sorted(os.listdir(tmp_path / "files")) == ["rank1.sdf", f"rank2_confidence{res2.confidence[res2.order[1]]:.2f}.sdf"]


def test_written_texts_equal_jax_for_the_same_poses(setup, tmp_path):
    """The port's writer on the JAX dock's result writes the JAX package's
    files, byte for byte."""
    ref = setup["ref"]
    heavy = chem.read_molecule_file(_files(NAME)[0]).remove_hs()
    result = DockingResult(poses=ref.poses, confidence=ref.confidence, order=ref.order,
                           trajectory=ref.trajectory)
    write_ranked_poses(str(tmp_path), heavy, result)
    names = sorted(os.listdir(setup["ref_dir"]))
    assert sorted(os.listdir(tmp_path)) == names
    for n in names:
        assert (tmp_path / n).read_text() == Path(setup["ref_dir"], n).read_text(), n


def test_pocket_center_matches_jax(setup):
    lig, pdb = _files(NAME)
    jaa, _ = jfeat.build_aa_complex_data(jchem.read_molecule_file(lig), jchem.read_pdb_file(pdb))
    pipe = setup["pipe"]
    data, aa, _ = pipe.featurize(chem.read_molecule_file(lig), chem.read_pdb_file(pdb))
    pocket = np.asarray(data.rec_pos)[7] + np.array([1.0, -2.0, 0.5], np.float32)
    noise = _jax_noise(STEPS)
    ref = setup["jpipe"].dock_complex(jaa.base, num_poses=P, seed=SEED + 1, aa_data=jaa,
                                      return_trajectory=True, pocket_center=pocket)
    res = pipe.dock_complex(data, num_poses=P, seed=SEED + 1, aa_data=aa, return_trajectory=True,
                            pocket_center=pocket, noise=noise)
    _assert_steps_match(res, ref)
    # the start poses sit around the pocket, not the receptor mean
    blind = pipe.dock_complex(data, num_poses=P, seed=SEED + 1, aa_data=aa, return_trajectory=True,
                              noise=noise)
    shift = (res.trajectory[0] - blind.trajectory[0]).mean(axis=(0, 1))
    np.testing.assert_allclose(shift, pocket - np.asarray(data.rec_pos).mean(0), rtol=0, atol=1e-3)


def test_pose_chunks_match_jax(setup):
    """5 poses in chunks of 2: three chunks, the last one cut to one pose,
    each from seed ``seed * 100003 + c``, ranked jointly."""
    from diffdock_tpu_torch.models.old_models import confidence_launches

    lig, pdb = _files(NAME)
    jaa, _ = jfeat.build_aa_complex_data(jchem.read_molecule_file(lig), jchem.read_pdb_file(pdb))
    pipe = setup["pipe"]
    data, aa, _ = pipe.featurize(chem.read_molecule_file(lig), chem.read_pdb_file(pdb))
    n, b, seed = 5, 2, 6
    assert pipe.effective_pose_chunk(data, n, b) == 2
    ref = setup["jpipe"].dock_complex(jaa.base, num_poses=n, seed=seed, aa_data=jaa,
                                      return_trajectory=True, batch_size=b)
    calls = []

    def noise(num_poses, n_bonds, s):
        calls.append((num_poses, n_bonds, s))
        return _jax_draws(s, num_poses, n_bonds, STEPS)

    before = ft.counts["fused_tp3_reference"]
    res = pipe.dock_complex(data, num_poses=n, seed=seed, aa_data=aa, return_trajectory=True,
                            batch_size=b, noise=noise)
    assert calls == [(b, setup["nb"], seed * 100003 + c) for c in range(3)]
    # three chunks, each one score dock (1 receptor layer + 12 per step) and
    # one confidence forward
    assert ft.counts["fused_tp3_reference"] - before == 3 * (1 + 12 * STEPS + confidence_launches(
        ScoreModelConfig(**CKW)))
    assert res.poses.shape == ref.poses.shape == (n, data.n_lig, 3)
    _assert_steps_match(res, ref)
    # the chunks are the port's own docks of 2 poses from each chunk's draws
    parts = [pipe.dock_complex(data, num_poses=b, seed=seed * 100003 + c, aa_data=aa,
                               return_trajectory=True, noise=noise) for c in range(3)]
    np.testing.assert_array_equal(res.poses, np.concatenate([r.poses for r in parts])[:n])
    np.testing.assert_array_equal(res.confidence, np.concatenate([r.confidence for r in parts])[:n])
    np.testing.assert_array_equal(res.trajectory, np.concatenate([r.trajectory for r in parts], 1)[:, :n])


def test_score_pose_cap_chunks_a_large_request(monkeypatch, setup):
    """Without a batch size, a request larger than the card's cap runs in
    chunks of the cap (here the budget is shrunk to two poses' worth)."""
    pipe = setup["pipe"]
    lig, pdb = _files(NAME)
    data, _, _ = pipe.featurize(chem.read_molecule_file(lig), chem.read_pdb_file(pdb))
    nl, nr, _ = bucket_sizes(data.n_lig, data.n_rec, data.n_bonds)
    per_pose = pipeline_mod.score_bytes_per_pose(nl, nr)
    assert per_pose > 0
    assert pipe.effective_pose_chunk(data, 40) == min(40, pipeline_mod.auto_pose_chunk(nl, nr))
    monkeypatch.setattr(pipeline_mod, "SCORE_BUDGET_BYTES", 2.5 * per_pose)
    assert pipeline_mod.auto_pose_chunk(nl, nr) == 2
    assert pipe.effective_pose_chunk(data, 5) == 2
    assert pipe.effective_pose_chunk(data, 5, batch_size=1) == 1
    assert pipe.effective_pose_chunk(data, 5, batch_size=4) == 2


def _write_run_dirs(setup, root):
    score_dir, conf_dir = root / "score", root / "confidence"
    save_checkpoint(str(score_dir), setup["jscore"], ScoreModelConfig(**SKW))
    save_checkpoint(str(conf_dir), setup["jconf"], ScoreModelConfig(**CKW))
    return score_dir, conf_dir


def test_cli_docks_a_csv_like_the_jax_pipeline(setup, tables, monkeypatch, tmp_path):
    """``main`` on a CSV of two complexes (and one that fails) with run
    directories, on ``--device cpu`` (JAX draws injected, small tables):
    the complex docked above gives the port pipeline's files byte for
    byte, with the JAX dock's file names; the other its ranked SDFs; the
    failed one is counted."""
    _, _, ps, pt = tables
    monkeypatch.setattr(pipeline_mod, "get_so3_tables", lambda device=None: ps)
    monkeypatch.setattr(pipeline_mod, "get_torus_tables", lambda device=None: pt)
    monkeypatch.setattr(DockingPipeline, "draw_noise",
                        lambda self, num_poses, n_bonds, seed: _jax_draws(seed, num_poses, n_bonds, STEPS))
    score_dir, conf_dir = _write_run_dirs(setup, tmp_path)
    csv = tmp_path / "pairs.csv"
    rows = ["complex_name,protein_path,ligand_description"]
    for name in (NAME, OTHER):
        lig, pdb = _files(name)
        rows.append(f"{name},{pdb},{lig}")
    rows.append(f"broken,{_files(NAME)[1]},{tmp_path / 'absent.sdf'}")
    csv.write_text("\n".join(rows) + "\n")
    out = tmp_path / "out"
    argv = ["--protein_ligand_csv", str(csv), "--model_dir", str(score_dir), "--confidence_model_dir",
            str(conf_dir), "--out_dir", str(out), "--samples_per_complex", str(P), "--inference_steps",
            str(STEPS), "--actual_steps", str(STEPS), "--seed", str(SEED), "--save_visualisation",
            "--compute_dtype", "float32", "--device", "cpu"]
    assert dock.main(argv) == 1  # one of three failed
    lig, pdb = _files(NAME)
    setup["pipe"].dock_mol_protein(chem.read_molecule_file(lig), chem.read_pdb_file(pdb),
                                   str(tmp_path / "pipeline"), num_poses=P, seed=SEED, save_trajectory=True,
                                   noise=_jax_noise(STEPS))
    names = sorted(os.listdir(tmp_path / "pipeline"))
    assert sorted(os.listdir(out / NAME)) == names and len(names) == 2 * P
    for n in names:
        assert (out / NAME / n).read_text() == (tmp_path / "pipeline" / n).read_text(), n
    assert [n for n in names if n.endswith(".pdb")] == \
        sorted(n for n in os.listdir(setup["ref_dir"]) if n.endswith(".pdb"))
    other = sorted(os.listdir(out / OTHER))
    assert "rank1.sdf" in other and len([f for f in other if f.endswith(".sdf")]) == P
    assert not (out / "broken").exists()
    # the two good complexes alone: success
    csv.write_text("\n".join(rows[:3]) + "\n")
    assert dock.main(argv[:-2] + ["--device", "cpu", "--out_dir", str(tmp_path / "again")]) == 0


def test_cli_parser_has_every_jax_flag_with_its_default():
    def flags(parser):
        return {a.dest: (tuple(sorted(a.option_strings)), a.default) for a in parser._actions
                if not isinstance(a, argparse._HelpAction)}

    ours, ref = flags(dock.get_parser()), flags(jdock.get_parser())
    assert set(ours) - set(ref) == {"device"} and set(ref) <= set(ours)
    assert ours["device"] == (("--device",), "cuda")
    differ = {k for k in ref if ours[k] != ref[k]}
    assert differ == set()
    assert ours["compute_dtype"][1] == ref["compute_dtype"][1] == "bfloat16"
    args = dock.get_parser().parse_args(["--temp_sampling_rot", "1.5", "--no-no_final_step_noise"])
    jargs = jdock.get_parser().parse_args(["--temp_sampling_rot", "1.5", "--no-no_final_step_noise"])
    cfg, jcfg = dock.sampler_config_from_args(args), jdock.sampler_config_from_args(jargs)
    for f in ("inference_steps", "actual_steps", "no_final_step_noise", "temp_sampling", "temp_psi",
              "temp_sigma_data", "initial_noise_std_proportion", "choose_residue"):
        assert getattr(cfg, f) == getattr(jcfg, f), f


def test_cli_config_overrides_and_refusals(setup, tables, monkeypatch, tmp_path, capsys):
    args = dock.get_parser().parse_args([])
    cfg = tmp_path / "c.yml"
    cfg.write_text("samples_per_complex: 4\nligand_description: x.sdf\nold_score_model: true\nbogus: 1\n")
    from diffdock_tpu_torch.utils import simple_yaml

    dock.apply_config_overrides(args, simple_yaml.load(cfg.read_text()))
    assert args.samples_per_complex == 4 and args.ligand == "x.sdf"
    assert "unknown config key 'bogus'" in capsys.readouterr().err
    score_dir, conf_dir = _write_run_dirs(setup, tmp_path)
    base = ["--model_dir", str(score_dir), "--device", "cpu"]
    # --pose_devices is ported (ROADMAP queue 1 item 8): the pipeline's mesh
    # needs the ranks that the CLI's main starts
    with pytest.raises(ConfigError, match="process group"):
        dock.load_pipeline(dock.get_parser().parse_args(base + ["--pose_devices", "2"]))
    # --compute_dtype (default bfloat16, as in the JAX CLI) sets the score
    # model's conv layers, not its heads, and not the confidence model's
    monkeypatch.setattr(pipeline_mod, "get_so3_tables", lambda device=None: tables[2])
    monkeypatch.setattr(pipeline_mod, "get_torus_tables", lambda device=None: tables[3])
    for extra, dtype in (([], "bfloat16"), (["--compute_dtype", "float32"], "float32")):
        pipe = dock.load_pipeline(dock.get_parser().parse_args(
            base + ["--confidence_model_dir", str(conf_dir)] + extra))
        assert pipe.score_cfg.compute_dtype == dtype
        assert {m.dtype for m in pipe.model.conv_layers} == {dtype}
        assert pipe.model.final_conv.dtype == "float32"
        assert pipe.confidence_cfg.compute_dtype == "float32"
        assert {m.dtype for m in pipe.confidence_model.modules() if isinstance(m, _ConvBase)} == {"float32"}
    # the bucket ladders are ported: the guard stays off on the CPU
    for ladder in ("fine_dense", "cover"):
        pipe = dock.load_pipeline(dock.get_parser().parse_args(base + ["--bucket_ladder", ladder]))
        assert pipe.bucket_ladder == ladder and pipe.anomaly_guard == 0.0
    # the crop options reach the config and the pipeline
    pipe = dock.load_pipeline(dock.get_parser().parse_args(base + ["--crop_beyond", "5", "--pocket_capacity", "10"]))
    assert pipe.score_cfg.crop_beyond == 5.0 and pipe.pocket_capacity == 10 and pipe.pre_crop_radius > 5.0
    # a reference .pt directory is converted (tests/test_torch_port_import_weights.py); an
    # unreadable checkpoint fails there
    ref_dir = tmp_path / "reference"
    ref_dir.mkdir()
    (ref_dir / "best_ema_inference_epoch_model.pt").write_bytes(b"")
    (ref_dir / "model_parameters.yml").write_text("ns: 16\n")
    with pytest.raises(EOFError):
        dock.load_pipeline(dock.get_parser().parse_args(["--model_dir", str(ref_dir), "--device", "cpu"]))
    # a missing directory is downloaded first: with no network, every URL fails
    from diffdock_tpu_torch.utils import download

    def no_network(url, timeout):
        raise OSError("no network")

    monkeypatch.setattr(download, "_default_opener", no_network)
    with pytest.raises(RuntimeError, match="failed to download"):
        dock.load_pipeline(dock.get_parser().parse_args(["--model_dir", str(tmp_path / "nope")]))
    # the mesh is ported (ROADMAP queue 1 item 8): a parallel.mesh.Mesh, and
    # nothing else, is taken
    from diffdock_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(TypeError, match="Mesh"):
        DockingPipeline(ScoreModelConfig(**SKW), 0, device="cpu", mesh=object())
    assert DockingPipeline(ScoreModelConfig(**SKW), 0, device="cpu", so3_tables=tables[2], torus_tables=tables[3],
                           mesh=Mesh(1, 0, "cpu", "gloo")).mesh_size == 1
    for kw in (dict(pre_crop_radius=10.0), dict(pocket_capacity=5)):
        assert DockingPipeline(ScoreModelConfig(**SKW), 0, device="cpu", so3_tables=tables[2],
                               torus_tables=tables[3], **kw).pre_crop_radius == kw.get("pre_crop_radius")
    assert dock.main(["--device", "cpu"]) == 2
