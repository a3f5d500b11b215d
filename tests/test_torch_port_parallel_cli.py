"""The dock and evaluate CLIs of the port on 2 CPU ranks, each CLI in a
process of its own: under ``torchrun --standalone --nproc_per_node 2``
and started by the CLI itself (``parallel/mesh.py:launch``, gloo over a
``file://`` store), with ``--device cpu``.

``cli.dock --pose_devices 2`` docks one e2e_synth complex from random-weight
run directories (score model and a coarse-grained confidence model) and
must write the ranked SDFs once, under the JAX CLI's names, the same files
both ways; ``cli.evaluate --complex_devices 2`` sweeps three e2e_synth
complexes (two groups of one complex per rank) and writes its artifacts.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from diffdock_tpu_torch.models.config import ScoreModelConfig
from diffdock_tpu_torch.parallel.mesh import CPU_DEVICES_ENV

REPO = Path(__file__).resolve().parent.parent
SYNTH = REPO / "data" / "e2e_synth"
COMPLEXES = ("syn044_l9r90", "syn131_l25r90", "syn128_l41r90")
SCORE = ScoreModelConfig(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=1, lm_embedding_dim=0)
CONFIDENCE = ScoreModelConfig(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=0, confidence_mode=True)
STEPS = ["--inference_steps", "3", "--actual_steps", "3"]
TIMEOUT = 300


def run_cli(args, torchrun: bool, env_extra=None):
    """``python -m <args>`` in a process of its own (under ``torchrun`` with
    2 ranks when asked); fails the test on a non-zero exit."""
    env = dict(os.environ)
    env.pop(CPU_DEVICES_ENV, None)
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", **(env_extra or {}))
    launcher = ["-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2"] if torchrun else []
    proc = subprocess.run([sys.executable, *launcher, "-m", *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, f"{args[0]} exited {proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}"
    return proc.stdout


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    """Random-weight run directories, and the default diffusion tables in
    the package's cache so that the ranks load them."""
    from diffdock_tpu_torch.diffusion.so3 import get_so3_tables
    from diffdock_tpu_torch.diffusion.torus import get_torus_tables

    get_so3_tables(device="cpu")
    get_torus_tables(device="cpu")
    return chip_smoke._write_run_dirs(tmp_path_factory.mktemp("runs"), SCORE, CONFIDENCE)


@pytest.fixture(scope="module")
def docks(run_dirs, tmp_path_factory):
    out = tmp_path_factory.mktemp("docks")
    name = COMPLEXES[1]
    common = ["--protein_path", str(SYNTH / name / f"{name}_protein_processed.pdb"),
              "--ligand", str(SYNTH / name / f"{name}_ligand.sdf"), "--model_dir", run_dirs["score"],
              "--confidence_model_dir", run_dirs["confidence"], "--samples_per_complex", "3",
              "--complex_name", name, "--pose_devices", "2", "--device", "cpu", "--compute_dtype", "float32",
              *STEPS]
    logs = {}
    for how in ("torchrun", "spawn"):
        logs[how] = run_cli(["diffdock_tpu_torch.cli.dock", *common, "--out_dir", str(out / how)],
                            torchrun=how == "torchrun")
    return out, name, logs


def test_dock_cli_on_two_ranks_writes_the_ranked_files_once(docks):
    out, name, logs = docks
    files = {}
    for how in ("torchrun", "spawn"):
        names = sorted(p.name for p in (out / how / name).iterdir())
        # 3 poses (4 sampled, 2 per rank): rank1.sdf and two with their confidence
        assert len(names) == 3 and "rank1.sdf" in names, names
        assert sorted(n.split("_")[0] for n in names) == ["rank1.sdf", "rank2", "rank3"], names
        files[how] = {n: (out / how / name / n).read_text() for n in names}
        assert logs[how].count("mesh: 2 ranks over gloo") == 1, logs[how][-2000:]
    # both launches dock the same poses from the same seed
    assert files["torchrun"] == files["spawn"]


def test_evaluate_cli_docks_one_complex_per_rank(run_dirs, tmp_path):
    split = tmp_path / "names.txt"
    split.write_text("\n".join(COMPLEXES) + "\n")
    out = tmp_path / "eval"
    log = run_cli(["diffdock_tpu_torch.cli.evaluate", "--data_dir", str(SYNTH), "--split", str(split),
                   "--model_dir", run_dirs["score"], "--confidence_model_dir", run_dirs["confidence"],
                   "--samples_per_complex", "2", "--complex_devices", "2", "--device", "cpu",
                   "--compute_dtype", "float32", "--cache_path", str(tmp_path / "cache"),
                   "--out_dir", str(out), *STEPS], torchrun=False)
    assert "batch dock failed" not in log and "0 failures due to exceptions" in log
    names = np.load(out / "names.npy")
    assert sorted(names) == sorted(COMPLEXES)
    rmsds = np.load(out / "rmsds.npy")
    assert rmsds.shape == (3, 2) and np.isfinite(rmsds).all() and (rmsds < 10000).all()
    assert np.isfinite(np.load(out / "run_times.npy")).all()
    assert json.loads((out / "metrics.json").read_text())["failures"] == 0
