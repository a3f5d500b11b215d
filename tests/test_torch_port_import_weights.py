"""Reference run directories in the port against the JAX package on the
CPU: ``cli/import_weights.py`` both ways (a directory either package
converts is read by the other to the same tree), ``utils/download.py``
with the network mocked (the cases of ``tests/test_download.py``, and a
``tpu_native`` subdirectory shared between the packages), and the dock CLI
on a ``.pt`` run directory of ``data/e2e_synth`` against the JAX dock CLI
on a copy of the same directory.

Reference-format directories are written here: ``torch.save`` of a state
dict under the reference's key names (``tests/test_torch_import.py:
build_ref_sd``) from parameters drawn with a numpy seed at small width,
and a flat args dump as ``model_parameters.yml``. The docks use the small
SO(3) and torus grids (no NaN rows) and the JAX pipeline's own draws; two
steps, where the two float32 docks stay within 1e-3 A (the dock tests'
tolerance; SDF coordinates carry four decimals).
"""

import dataclasses
import io
import os
import shutil
import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from diffdock_tpu.cli import dock as jdock
from diffdock_tpu.cli import import_weights as jimport_cli
from diffdock_tpu.inference import pipeline as jpipeline_mod
from diffdock_tpu.models.factory import build_model as jbuild_model
from diffdock_tpu.train import checkpoints as jckpt
from diffdock_tpu.utils import download as jdownload
from diffdock_tpu.utils import torch_import as jimport
from diffdock_tpu_torch.cli import dock, import_weights
from diffdock_tpu_torch.data import chem
from diffdock_tpu_torch.inference import pipeline as pipeline_mod
from diffdock_tpu_torch.inference.pipeline import DockingPipeline
from diffdock_tpu_torch.train import checkpoints
from diffdock_tpu_torch.utils import download
from tests.test_torch_import import build_ref_sd
from tests.test_torch_port_confidence import _perturbed, tables  # noqa: F401
from tests.test_torch_port_dock import _jax_draws
from tests.test_torch_port_torch_import import assert_trees_equal

REPO = Path(__file__).resolve().parent.parent
SYNTH = REPO / "data" / "e2e_synth"
NAME = "syn001_l24r104"
STEPS, P, SEED = 2, 3, 4
# flat reference args dumps (the argparse values a reference run records)
SCORE_ARGS = dict(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1, embed_also_ligand=True, sh_lmax=2,
                  max_radius=5.0,
                  cross_max_distance=80.0, dynamic_max_cross=False, embedding_type="sinusoidal",
                  embedding_scale=1000, sigma_embed_dim=32, distance_embed_dim=32,
                  cross_distance_embed_dim=32, esm_embeddings_path=None, dropout=0.1, lr=0.001,
                  w_decay=1.0e-05, log_dir="workdir/score", tr_sigma_max=30.0,
                  rmsd_classification_cutoff=None, not_fixed_center_conv=False)
CONF_ARGS = dict(ns=8, nv=2, num_conv_layers=2, all_atoms=True, esm_embeddings_path=None,
                 embedding_type="sinusoidal", embedding_scale=1000, rmsd_classification_cutoff=[2.0],
                 confidence_dropout=0.1, use_old_atom_encoder=True, log_dir="workdir/confidence")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_variables(jcfg, js, jt, seed):
    """The JAX model's variables for ``jcfg`` at small width, biases and
    statistics perturbed (weights as initialized, so poses stay near the
    receptor)."""
    from diffdock_tpu.data import complexes as jc

    rng = np.random.RandomState(0)
    if jcfg.all_atoms:
        d = jc.synthetic_aa_complex(rng, n_lig=8, n_rec=12, n_bonds=2, atoms_per_res=3)
        pos = d.base.lig_pos
    else:
        d = jc.synthetic_complex(rng, n_lig=8, n_rec=16, n_bonds=2)
        pos = d.lig_pos
    v = jax.jit(jbuild_model(jcfg).init)(jax.random.PRNGKey(seed), jax.tree.map(jnp.asarray, d),
                                         jnp.asarray(pos), jnp.asarray(0.5), js, jt)
    return jax.tree.map(np.asarray, _perturbed(v, seed, weights=False))


def write_reference_dir(path, args, variables, jcfg, ckpt=download.DEFAULT_CKPT):
    """A reference run directory: ``torch.save`` of the state dict under
    the reference's names and the flat args dump."""
    os.makedirs(path, exist_ok=True)
    sd = build_ref_sd(variables["params"], variables.get("batch_stats", {}), jcfg)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, os.path.join(path, ckpt))
    with open(os.path.join(path, "model_parameters.yml"), "w") as f:
        f.write(yaml.dump(args))
    return path


@pytest.fixture(scope="module")
def ref_dirs(tables, tmp_path_factory):
    js, jt, _, _ = tables
    root = tmp_path_factory.mktemp("reference")
    out = {}
    for name, args, kw in (("score", SCORE_ARGS, {}), ("confidence", CONF_ARGS,
                                                       dict(confidence_mode=True, old=True))):
        jcfg = jimport.config_from_reference_args(args, **kw)
        v = _jax_variables(jcfg, js, jt, seed=len(name))
        out[name] = (write_reference_dir(str(root / name), args, v, jcfg), v, jcfg, kw)
    return out


def _argv(ref, out, kw):
    argv = ["--torch_checkpoint", os.path.join(ref, download.DEFAULT_CKPT), "--out_dir", out]
    return argv + [f"--{k}" for k, on in kw.items() if on]


@pytest.mark.parametrize("name", ["score", "confidence"])
def test_import_weights_both_ways(ref_dirs, tmp_path, name):
    ref, variables, jcfg, kw = ref_dirs[name]
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    assert import_weights.main(_argv(ref, ours, kw)) == 0
    assert jimport_cli.main(_argv(ref, theirs, kw)) == 0
    # the port's directory through JAX's reader, and JAX's through the port's
    for a, b in ((jckpt.load_checkpoint(ours), jckpt.load_checkpoint(theirs)),
                 (checkpoints.load_checkpoint(theirs), checkpoints.load_checkpoint(ours))):
        assert_trees_equal(jax.tree.map(np.asarray, a[0]), jax.tree.map(np.asarray, b[0]))
        assert dataclasses.asdict(a[1]) == dataclasses.asdict(b[1])
    assert_trees_equal(checkpoints.load_checkpoint(ours)[0], variables)
    assert dataclasses.asdict(checkpoints.load_checkpoint(ours)[1]) == dataclasses.asdict(jcfg)
    with open(os.path.join(ours, "model.msgpack"), "rb") as f, \
            open(os.path.join(theirs, "model.msgpack"), "rb") as g:
        assert f.read() == g.read()


def test_import_weights_refuses_what_it_cannot_place(ref_dirs, tmp_path):
    """An extra reference key is an error (the JAX CLI only warns)."""
    ref, _, _, kw = ref_dirs["score"]
    bad = tmp_path / "bad"
    shutil.copytree(ref, bad)
    sd = torch.load(bad / download.DEFAULT_CKPT, weights_only=True)
    sd["module.extra_head.weight"] = torch.zeros(3)
    torch.save({"model": sd}, bad / download.DEFAULT_CKPT)  # the {"model": ...} flavor
    with pytest.raises(ValueError, match="extra_head.weight"):
        import_weights.main(_argv(str(bad), str(tmp_path / "out"), kw))
    assert not (tmp_path / "out").exists()
    # without the extra key the same flavor, with module. prefixes, imports
    del sd["module.extra_head.weight"]
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}}, bad / download.DEFAULT_CKPT)
    assert import_weights.main(_argv(str(bad), str(tmp_path / "out"), kw)) == 0


# ---------------------------------------------------------------------
# utils/download.py, the network mocked (tests/test_download.py's cases)
# ---------------------------------------------------------------------
class _Resp:
    def __init__(self, payload: bytes):
        self._payload = payload

    def read(self):
        return self._payload


def _zip_bytes(files):
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        for name, content in files.items():
            zf.writestr(name, content)
    return buf.getvalue()


def _fake_opener(payload, calls):
    def opener(url, timeout):
        calls.append(url)
        return _Resp(payload)
    return opener


def test_constants_equal_jax():
    assert download.REMOTE_URLS == jdownload.REMOTE_URLS
    assert download.DEFAULT_CKPT == jdownload.DEFAULT_CKPT
    assert download.NATIVE_SUBDIR == jdownload.NATIVE_SUBDIR


def test_download_and_extract_and_ensure_downloaded(tmp_path):
    payload = _zip_bytes({"run/model_parameters.yml": "ns: 48\n", "run/best_ema_inference_epoch_model.pt": b"\x00"})
    calls = []
    files = download.download_and_extract("http://example/models.zip", str(tmp_path),
                                          _fake_opener(payload, calls))
    assert sorted(files) == ["run/best_ema_inference_epoch_model.pt", "run/model_parameters.yml"]
    assert (tmp_path / "run" / "model_parameters.yml").read_text() == "ns: 48\n"
    assert calls == ["http://example/models.zip"]
    # present: no network touch
    calls = []
    assert download.ensure_downloaded(str(tmp_path / "run"), opener=_fake_opener(b"x", calls)) == []
    assert calls == []
    # the first URL fails, the second works; extracted into the parent
    target = tmp_path / "workdir" / "score_model"
    good = _fake_opener(_zip_bytes({"score_model/model_parameters.yml": "ns: 16\n"}), calls)

    def opener(url, timeout):
        if not calls:
            calls.append(url)
            raise OSError("connection refused")
        return good(url, timeout)

    assert download.ensure_downloaded(str(target), opener=opener) == ["score_model/model_parameters.yml"]
    assert len(calls) == 2 and calls[0] == download.REMOTE_URLS[0]
    assert (target / "model_parameters.yml").exists()

    def refuse(url, timeout):
        raise OSError("no egress")

    with pytest.raises(RuntimeError, match="failed to download"):
        download.ensure_downloaded(str(tmp_path / "missing"), opener=refuse)


def _reference_stub(tmp_path):
    d = tmp_path / "ref_run"
    d.mkdir()
    (d / "model_parameters.yml").write_text(yaml.safe_dump({"ns": 16, "nv": 4, "all_atoms": False}))
    (d / download.DEFAULT_CKPT).write_bytes(b"\x80")
    return d


def test_is_reference_format(tmp_path):
    ref = _reference_stub(tmp_path)
    assert download.is_reference_format(str(ref)) and jdownload.is_reference_format(str(ref))
    assert not download.is_reference_format(str(tmp_path / "does_not_exist"))
    native = tmp_path / "native_run"
    from diffdock_tpu_torch.models.config import ScoreModelConfig

    checkpoints.save_checkpoint(str(native), {"params": {"w": np.zeros(2, np.float32)}, "batch_stats": {}},
                                ScoreModelConfig(ns=8, nv=2))
    assert not download.is_reference_format(str(native)) and not jdownload.is_reference_format(str(native))
    assert download.prepare_model_dir(str(native)) == str(native)
    # .pt weights and no args dump: reference format in both
    (tmp_path / "bare").mkdir()
    (tmp_path / "bare" / "w.pt").write_bytes(b"")
    assert download.is_reference_format(str(tmp_path / "bare")) == jdownload.is_reference_format(
        str(tmp_path / "bare")) is True


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_prepare_model_dir_keys_provenance_and_legacy_cache(tmp_path, monkeypatch, pkg):
    """The conversion cache's subdirectory names, ``SOURCE`` record,
    mismatch error and legacy-cache reconversion, for the port's
    ``prepare_model_dir`` (and, the same steps, the JAX package's)."""
    mod, cli = (download, import_weights) if pkg == "port" else (jdownload, jimport_cli)
    ref = _reference_stub(tmp_path)
    native = os.path.join(str(ref), mod.NATIVE_SUBDIR)
    seen = []

    def fake_import(argv):
        seen.append(list(argv))
        out = argv[argv.index("--out_dir") + 1]
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "model.msgpack"), "wb") as f:
            f.write(b"converted")
        return 0

    monkeypatch.setattr(cli, "main", fake_import)
    out = mod.prepare_model_dir(str(ref), confidence_mode=True, old=True)
    assert out == native + "_conf_old"
    assert "--confidence_mode" in seen[0] and "--old" in seen[0]
    assert seen[0][seen[0].index("--torch_checkpoint") + 1] == str(ref / mod.DEFAULT_CKPT)
    assert mod.prepare_model_dir(str(ref), confidence_mode=True, old=True) == out and len(seen) == 1
    (ref / "last_model.pt").write_bytes(b"torch2")
    assert mod.prepare_model_dir(str(ref), ckpt="last_model.pt") == native + "_last_model"
    assert len(seen) == 2
    out4 = mod.prepare_model_dir(str(ref))
    assert out4 == native and len(seen) == 3
    with open(os.path.join(out4, "SOURCE")) as f:
        assert f.read() == f"{mod.DEFAULT_CKPT} confidence=False old=False\n"
    with open(os.path.join(out4, "SOURCE"), "w") as f:
        f.write("something_else.pt confidence=False old=False\n")
    for m in (download, jdownload):  # a mismatch raises in both packages
        with pytest.raises(RuntimeError, match="different source"):
            m.prepare_model_dir(str(ref))
    os.remove(os.path.join(out4, "SOURCE"))
    with pytest.warns(RuntimeWarning, match="no SOURCE provenance"):
        assert mod.prepare_model_dir(str(ref)) == native
    assert len(seen) == 4
    assert mod.prepare_model_dir(str(ref)) == native and len(seen) == 4


def test_a_conversion_by_either_package_serves_the_other(ref_dirs, tmp_path):
    ref, variables, _, kw = ref_dirs["confidence"]
    for first, second in ((jdownload, download), (download, jdownload)):
        d = tmp_path / first.__name__.split(".")[0]
        shutil.copytree(ref, d)
        out = first.prepare_model_dir(str(d), **kw)
        assert out == os.path.join(str(d), "tpu_native_conf_old")
        mtime = os.path.getmtime(os.path.join(out, "model.msgpack"))
        assert second.prepare_model_dir(str(d), **kw) == out  # served, not reconverted
        assert os.path.getmtime(os.path.join(out, "model.msgpack")) == mtime
        assert_trees_equal(checkpoints.load_checkpoint(out)[0], variables)


# ---------------------------------------------------------------------
# the dock CLIs on a reference run directory
# ---------------------------------------------------------------------
def _read_ranked(out_dir):
    """{rank: (confidence, coords)} of the ranked SDFs a dock wrote."""
    ranked = {}
    for f in os.listdir(out_dir):
        if f.endswith(".sdf"):
            rank = int(f[4:].split("_")[0].split(".")[0])
            text = Path(out_dir, f).read_text()
            mol = chem.parse_sdf(text)[0]
            conf = float(text.split("> <confidence>\n")[1].split("\n")[0])
            ranked[rank] = (conf, np.asarray(mol.coords))
    return ranked


def test_dock_cli_on_a_reference_run_dir_matches_the_jax_cli(ref_dirs, tables, monkeypatch, tmp_path):
    js, jt, ps, pt = tables
    monkeypatch.setattr(jpipeline_mod, "get_so3_tables", lambda *a, **k: js)
    monkeypatch.setattr(jpipeline_mod, "get_torus_tables", lambda *a, **k: jt)
    monkeypatch.setattr(pipeline_mod, "get_so3_tables", lambda *a, **k: ps)
    monkeypatch.setattr(pipeline_mod, "get_torus_tables", lambda *a, **k: pt)
    monkeypatch.setattr(DockingPipeline, "draw_noise",
                        lambda self, num_poses, n_bonds, seed: _jax_draws(seed, num_poses, n_bonds, STEPS))
    lig = SYNTH / NAME / f"{NAME}_ligand.sdf"
    pdb = SYNTH / NAME / f"{NAME}_protein_processed.pdb"
    outs = {}
    for pkg, main in (("port", dock.main), ("jax", jdock.main)):
        # each package converts its own copy of the reference directories
        runs = tmp_path / f"runs_{pkg}"
        score = shutil.copytree(ref_dirs["score"][0], runs / "score")
        conf = shutil.copytree(ref_dirs["confidence"][0], runs / "confidence")
        outs[pkg] = tmp_path / f"out_{pkg}"
        argv = ["--protein_path", str(pdb), "--ligand", str(lig), "--complex_name", NAME,
                "--model_dir", str(score), "--confidence_model_dir", str(conf), "--out_dir", str(outs[pkg]),
                "--samples_per_complex", str(P), "--inference_steps", str(STEPS), "--actual_steps",
                str(STEPS), "--seed", str(SEED)]
        extra = ["--compute_dtype", "float32"] + (["--device", "cpu"] if pkg == "port" else [])
        assert main(argv + extra) == 0
        assert os.path.isdir(runs / "score" / "tpu_native") and os.path.isdir(runs / "confidence" / "tpu_native_conf_old")
    ours, ref = _read_ranked(outs["port"] / NAME), _read_ranked(outs["jax"] / NAME)
    assert sorted(ours) == sorted(ref) == list(range(1, P + 1))
    for r in ref:
        np.testing.assert_allclose(ours[r][1], ref[r][1], rtol=0, atol=1e-3)
        assert ours[r][0] == pytest.approx(ref[r][0], abs=2e-4)


@pytest.mark.parametrize("arch", ["diffdock_l", "shipped_confidence", "v1_score"])
def test_chip_smoke_reference_state_dict_round_trips(arch, tmp_path):
    """``chip_smoke.py`` phases F and J write reference checkpoints from the
    port's random weights with its own inverse key map and args dump: at
    small width (the preset's, the shipped confidence model's and the v1.0
    score model's layout, ns=8, nv=2) both packages' converters take them
    back to the weights exactly, every reference key consumed (the v1.0
    model's never-called last-layer receptor convs among them), and the
    args dump derives the config the weights were made for."""
    import chip_smoke
    from diffdock_tpu_torch.models.config import PRESETS
    from diffdock_tpu_torch.utils import simple_yaml
    from diffdock_tpu_torch.utils.convert import build_model, flax_from_model, load_converted
    from diffdock_tpu_torch.utils import torch_import

    if arch == "diffdock_l":
        cfg, kw = dataclasses.replace(PRESETS["diffdock_l"], ns=8, nv=2), {}
    elif arch == "v1_score":
        cfg, kw = dataclasses.replace(chip_smoke.v1_config(), ns=8, nv=2, num_conv_layers=3), dict(old=True)
    else:
        cfg = dataclasses.replace(PRESETS["diffdock_s"], **dict(chip_smoke.SHIPPED_CONFIDENCE, ns=8, nv=2,
                                                                num_conv_layers=3))
        kw = dict(confidence_mode=True, old=True)
    model = build_model(cfg)
    model.reset_parameters(torch.Generator().manual_seed(3))
    sd = chip_smoke.reference_state_dict(model)
    if arch == "v1_score":
        assert "rec_conv_layers.2.fc.0.weight" in sd and "lig_to_rec_conv_layers.2.fc.0.weight" in sd
    args = simple_yaml.load(simple_yaml.dump(chip_smoke.reference_args(cfg)))
    assert args == yaml.safe_load(simple_yaml.dump(chip_smoke.reference_args(cfg)))
    derived = torch_import.config_from_reference_args(args, **kw)
    assert {f.name for f in dataclasses.fields(cfg) if getattr(derived, f.name) != getattr(cfg, f.name)} <= \
        ({"embed_also_ligand"} if kw else set())
    weights = load_converted(*torch_import.convert_state_dict(sd, cfg), cfg)
    own = model.state_dict()
    assert set(weights) == set(own)
    for k, v in own.items():
        assert torch.equal(weights[k], v), k
    jp, js, jr = jimport.convert_state_dict({k: v.numpy() for k, v in sd.items()},
                                            jimport.config_from_reference_args(args, **kw))
    assert jr["unconsumed"] == []
    tree = flax_from_model(model)
    assert_trees_equal(jp, tree["params"])
    assert_trees_equal(js, tree["batch_stats"])


def test_evaluate_cli_reads_reference_run_dirs(ref_dirs, tables, monkeypatch, tmp_path):
    """The evaluate CLI builds its pipeline through the dock CLI's
    ``load_pipeline``, so reference directories convert there too (the
    confidence model as the shipped v1.0 architecture by default)."""
    from diffdock_tpu_torch.cli import evaluate
    from diffdock_tpu_torch.utils.convert import state_dict_from_flax

    _, _, ps, pt = tables
    monkeypatch.setattr(pipeline_mod, "get_so3_tables", lambda *a, **k: ps)
    monkeypatch.setattr(pipeline_mod, "get_torus_tables", lambda *a, **k: pt)
    runs = {name: shutil.copytree(ref_dirs[name][0], tmp_path / name) for name in ("score", "confidence")}
    split = tmp_path / "split.txt"
    split.write_text(f"{NAME}\n")
    args = evaluate.get_parser().parse_args([
        "--data_dir", str(SYNTH), "--split", str(split), "--model_dir", str(runs["score"]),
        "--confidence_model_dir", str(runs["confidence"]), "--device", "cpu"])
    pipe = evaluate.build_pipeline(args)
    for model, (name, (_, variables, jcfg, _)) in ((pipe.model, ("score", ref_dirs["score"])),
                                                     (pipe.confidence_model, ("confidence", ref_dirs["confidence"]))):
        want = state_dict_from_flax(variables, checkpoints.load_checkpoint(
            os.path.join(runs[name], "tpu_native" if name == "score" else "tpu_native_conf_old"))[1])
        got = model.state_dict()
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k


# a new-architecture coarse-grained confidence model's args dump (the
# confidence head of CGScoreModel, with a protein-embedding layer)
NEW_CONF_ARGS = dict(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1, embed_also_ligand=True,
                     all_atoms=False, esm_embeddings_path=None, embedding_type="sinusoidal",
                     embedding_scale=1000, rmsd_classification_cutoff=[2.0], confidence_dropout=0.1,
                     log_dir="workdir/confidence_new")


def test_dock_cli_ranks_with_a_new_architecture_reference_dir_like_the_jax_cli(ref_dirs, tables, monkeypatch,
                                                                               tmp_path):
    """``--no-old_confidence_model`` on a reference ``.pt`` directory of a
    new-architecture confidence model: both CLIs convert it (the port into
    ``tpu_native_conf``), the port's pipeline builds ``CGScoreModel`` in
    confidence mode through the factory, and the ranked poses and their
    confidences equal the JAX CLI's, as for the v1.0 model above."""
    from diffdock_tpu_torch.models.score_model import CGScoreModel

    js, jt, ps, pt = tables
    jcfg = jimport.config_from_reference_args(NEW_CONF_ARGS, confidence_mode=True, old=False)
    assert jcfg.confidence_mode and not jcfg.old_architecture and not jcfg.all_atoms
    conf_ref = write_reference_dir(str(tmp_path / "new_conf"), NEW_CONF_ARGS, _jax_variables(jcfg, js, jt, 5),
                                   jcfg)
    monkeypatch.setattr(jpipeline_mod, "get_so3_tables", lambda *a, **k: js)
    monkeypatch.setattr(jpipeline_mod, "get_torus_tables", lambda *a, **k: jt)
    monkeypatch.setattr(pipeline_mod, "get_so3_tables", lambda *a, **k: ps)
    monkeypatch.setattr(pipeline_mod, "get_torus_tables", lambda *a, **k: pt)
    monkeypatch.setattr(DockingPipeline, "draw_noise",
                        lambda self, num_poses, n_bonds, seed: _jax_draws(seed, num_poses, n_bonds, STEPS))
    lig = SYNTH / NAME / f"{NAME}_ligand.sdf"
    pdb = SYNTH / NAME / f"{NAME}_protein_processed.pdb"
    outs = {}
    for pkg, main in (("port", dock.main), ("jax", jdock.main)):
        runs = tmp_path / f"runs_{pkg}"
        score = shutil.copytree(ref_dirs["score"][0], runs / "score")
        conf = shutil.copytree(conf_ref, runs / "confidence")
        outs[pkg] = tmp_path / f"out_{pkg}"
        argv = ["--protein_path", str(pdb), "--ligand", str(lig), "--complex_name", NAME,
                "--model_dir", str(score), "--confidence_model_dir", str(conf), "--no-old_confidence_model",
                "--out_dir", str(outs[pkg]), "--samples_per_complex", str(P), "--inference_steps", str(STEPS),
                "--actual_steps", str(STEPS), "--seed", str(SEED)]
        extra = ["--compute_dtype", "float32"] + (["--device", "cpu"] if pkg == "port" else [])
        assert main(argv + extra) == 0
        assert os.path.isdir(runs / "confidence" / "tpu_native_conf")
        if pkg == "port":
            pipe = dock.load_pipeline(dock.get_parser().parse_args(argv + extra))
            assert type(pipe.confidence_model) is CGScoreModel and pipe.confidence_cfg.confidence_mode
    ours, ref = _read_ranked(outs["port"] / NAME), _read_ranked(outs["jax"] / NAME)
    assert sorted(ours) == sorted(ref) == list(range(1, P + 1))
    for r in ref:
        np.testing.assert_allclose(ours[r][1], ref[r][1], rtol=0, atol=1e-3)
        assert ours[r][0] == pytest.approx(ref[r][0], abs=2e-4)
