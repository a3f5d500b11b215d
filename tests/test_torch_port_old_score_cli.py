"""The dock CLI with ``--old_score_model`` on a reference-format run
directory of a DiffDock v1.0 score model, in the port against the JAX dock
CLI on the CPU, in ``tests/test_torch_port_import_weights.py``'s manner.

The directory holds ``torch.save`` of a state dict under the reference's
key names (``tests/test_torch_import.py:build_ref_sd``) and a flat v1.0
args dump without ``embedding_type`` (so both importers take the sinusoidal
embedding at scale 10000, the reference factory's fallback); the ranking
model is the old all-atom confidence directory of that file. Each package
converts its own copy (``prepare_model_dir(..., old=True)``) and docks
``syn001_l24r104`` from the JAX pipeline's own draws for two steps: the
ranked SDFs within 1e-3 A and their confidences within 2e-4. The score
model's tr and rot heads are scaled down as in
``tests/test_torch_port_old_score.py``, so the poses stay near the
receptor, where float32 rounding does not grow past 1e-3 A.
"""

import os
import shutil

import numpy as np
import pytest

from diffdock_tpu.cli import dock as jdock
from diffdock_tpu.inference import pipeline as jpipeline_mod
from diffdock_tpu.utils import torch_import as jimport
from diffdock_tpu_torch.cli import dock
from diffdock_tpu_torch.inference import pipeline as pipeline_mod
from diffdock_tpu_torch.inference.pipeline import DockingPipeline
from diffdock_tpu_torch.train import checkpoints
from diffdock_tpu_torch.utils import download, torch_import
from tests.test_torch_port_confidence import tables  # noqa: F401
from tests.test_torch_port_dock import _jax_draws
from tests.test_torch_port_old_score import HEAD_SCALE
from tests.test_torch_port_import_weights import (  # noqa: F401
    NAME,
    P,
    SEED,
    STEPS,
    SYNTH,
    _jax_variables,
    _one_thread,
    _read_ranked,
    ref_dirs,
    write_reference_dir,
)

# a v1.0 score run's args dump (the old CLI had no embedding_type,
# sh_lmax or num_prot_emb_layers)
OLD_SCORE_ARGS = dict(ns=8, nv=2, num_conv_layers=3, max_radius=5.0, cross_max_distance=80.0,
                      dynamic_max_cross=True, sigma_embed_dim=16, distance_embed_dim=16,
                      cross_distance_embed_dim=16, esm_embeddings_path=None, dropout=0.1,
                      scale_by_sigma=True, tr_sigma_max=19.0, rot_sigma_max=1.55, lr=0.001,
                      log_dir="workdir/paper_score_model")


@pytest.fixture(scope="module")
def old_score_dir(tables, tmp_path_factory):
    js, jt, _, _ = tables
    jcfg = jimport.config_from_reference_args(OLD_SCORE_ARGS, old=True)
    assert jcfg.old_architecture and jcfg.embedding_scale == 10000
    v = _jax_variables(jcfg, js, jt, seed=7)
    # the tr and rot heads scaled down, as tests/test_torch_port_old_score.py
    # does for its dock: random heads throw the poses far from the receptor
    for head in ("tr_final_layer", "rot_final_layer"):
        last = v["params"][head]["Dense_1"]
        last.update(kernel=last["kernel"] * HEAD_SCALE, bias=last["bias"] * HEAD_SCALE)
    return write_reference_dir(str(tmp_path_factory.mktemp("old_score") / "score"), OLD_SCORE_ARGS, v, jcfg), v


def test_old_score_config_and_weights_import_like_jax(old_score_dir):
    path, v = old_score_dir
    ours = torch_import.config_from_reference_args(OLD_SCORE_ARGS, old=True)
    ref = jimport.config_from_reference_args(OLD_SCORE_ARGS, old=True)
    assert ours.old_architecture and not ours.confidence_mode and ours.embedding_scale == 10000
    for f in ("ns", "nv", "num_conv_layers", "sigma_embed_dim", "embedding_type", "embedding_scale",
              "dynamic_max_cross", "use_old_atom_encoder", "fixed_center_conv", "num_prot_emb_layers"):
        assert getattr(ours, f) == getattr(ref, f), f
    params, _, report = torch_import.load_torch_checkpoint(os.path.join(path, download.DEFAULT_CKPT), ours)
    assert report["unconsumed"] == []
    assert {"final_conv", "tor_bond_conv", "lig_conv_2", "rec_to_lig_conv_2"} <= set(params)
    assert "rec_conv_2" not in params  # built by the reference, never called


def test_dock_cli_with_old_score_model_matches_the_jax_cli(old_score_dir, ref_dirs, tables, monkeypatch,
                                                           tmp_path):
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
        runs = tmp_path / f"runs_{pkg}"
        score = shutil.copytree(old_score_dir[0], runs / "score")
        conf = shutil.copytree(ref_dirs["confidence"][0], runs / "confidence")
        outs[pkg] = tmp_path / f"out_{pkg}"
        argv = ["--protein_path", str(pdb), "--ligand", str(lig), "--complex_name", NAME,
                "--model_dir", str(score), "--confidence_model_dir", str(conf), "--out_dir", str(outs[pkg]),
                "--samples_per_complex", str(P), "--inference_steps", str(STEPS), "--actual_steps",
                str(STEPS), "--seed", str(SEED), "--old_score_model", "--compute_dtype", "float32"]
        assert main(argv + (["--device", "cpu"] if pkg == "port" else [])) == 0
        native = [d for d in os.listdir(runs / "score") if d.startswith("tpu_native")]
        assert native, os.listdir(runs / "score")
        _, cfg, _ = checkpoints.load_checkpoint(str(runs / "score" / native[0]))
        assert cfg.old_architecture and not cfg.confidence_mode
    ours, ref = _read_ranked(outs["port"] / NAME), _read_ranked(outs["jax"] / NAME)
    assert sorted(ours) == sorted(ref) == list(range(1, P + 1))
    for r in ref:
        assert np.isfinite(ours[r][1]).all()
        np.testing.assert_allclose(ours[r][1], ref[r][1], rtol=0, atol=1e-3)
        assert ours[r][0] == pytest.approx(ref[r][0], abs=2e-4)
