"""The port's confidence-train CLI on the CPU (``--device cpu``): the
``--synthetic`` runs of the JAX CLI's tests (coarse-grained, ``--all_atoms``,
two cutoffs, ``--rmsd_prediction``), the PDBBind layout with symmetry-RMSD
labels, the run directory read by the JAX package (its ``load_checkpoint``
and model give the port's confidences on the same poses within 1e-4, the
forward tolerance of ``test_torch_port_confidence.py``), a pose cache
written by the JAX package's functions trained on with
``--cache_ids_to_combine``, and the refusals.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdock_tpu.models.factory import build_model as j_build_model
from diffdock_tpu.train import checkpoints as jckpt
from diffdock_tpu.train import confidence as jconf
from diffdock_tpu_torch.cli import confidence_train as cli
from diffdock_tpu_torch.data.complexes import to_device
from diffdock_tpu_torch.models.config import ConfigError
from diffdock_tpu_torch.models.factory import build_model
from diffdock_tpu_torch.ops import fused_tp3 as ft
from diffdock_tpu_torch.train import checkpoints as ckpt
from diffdock_tpu_torch.utils.convert import state_dict_from_flax
from tests.test_torch_port_confidence import _one_thread, tables  # noqa: F401
from tests.test_torch_port_confidence_train import _FixedPoses

SMALL = ["--ns", "8", "--nv", "2", "--num_conv_layers", "2", "--num_prot_emb_layers", "0",
         "--samples_per_complex", "2", "--inference_steps", "2", "--device", "cpu"]
PDBBIND = ("syn044_l9r90", "syn001_l24r104")


def _run(tmp_path, name, *extra):
    argv = ["--synthetic", "3", "--n_epochs", "1", "--batch_size", "2",
            "--log_dir", str(tmp_path / name), "--pose_cache", str(tmp_path / f"{name}_poses")]
    return cli.main(argv + SMALL + list(extra))


VARIANTS = {
    "cg": ([], "bce", 1),
    "all_atoms": (["--all_atoms"], "bce", 1),
    "two_cutoffs": (["--rmsd_classification_cutoff", "2.0", "5.0"], "ce", 3),
    "rmsd_prediction": (["--rmsd_prediction"], "mse", 1),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_synthetic_runs(tmp_path, variant, capsys):
    """Three synthetic complexes, 2 poses each, 1 epoch of 2 steps: the
    caches, ``metrics.jsonl`` and the run directory, whose config is the
    JAX CLI's (batch norms over ``batch``, the outputs of the loss)."""
    extra, kind, n_out = VARIANTS[variant]
    before = ft.counts["fused_tp3_reference"]
    assert _run(tmp_path, "run", *extra) == 0
    assert "WARNING: random score-model weights" in capsys.readouterr().out
    assert ft.counts["fused_tp3_reference"] > before
    caches = sorted(p.name for p in (tmp_path / "run_poses").iterdir())
    assert caches == ["0.npz", "1.npz", "2.npz"]
    with np.load(tmp_path / "run_poses" / "0.npz") as z:
        assert z["poses"].shape == (2, 16, 3) and z["rmsds"].shape == (2,)
        assert np.isfinite(z["rmsds"]).all() and not z["poses"][:, 12:].any()
    recs = [json.loads(x) for x in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert len(recs) == 1 and recs[0]["kind"] == kind and np.isfinite(recs[0]["loss"])
    params, cfg, extra_meta = ckpt.load_checkpoint(str(tmp_path / "run"), "last_model.msgpack")
    assert cfg.confidence_mode and cfg.all_atoms == ("--all_atoms" in extra)
    assert cfg.num_confidence_outputs == n_out and tuple(cfg.bn_axis_names) == ("batch",)
    assert extra_meta["epoch"] == 0
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_flax(params, cfg), strict=True)


@pytest.mark.parametrize("all_atoms", [False, True])
def test_run_directory_gives_jax_the_same_confidences(tmp_path, tables, all_atoms):
    """The ``last_model.msgpack`` the port writes, read by the JAX
    package's ``load_checkpoint`` into its model: the same confidences as
    the port's model on the same poses (evaluation mode)."""
    js, jt, _, _ = tables
    assert _run(tmp_path, "run", *(["--all_atoms"] if all_atoms else [])) == 0
    jparams, jcfg, _ = jckpt.load_checkpoint(str(tmp_path / "run"), "last_model.msgpack")
    params, cfg, _ = ckpt.load_checkpoint(str(tmp_path / "run"), "last_model.msgpack")
    assert jcfg.confidence_mode and jcfg.all_atoms == all_atoms
    args = cli.get_parser().parse_args(["--synthetic", "3"] + (["--all_atoms"] if all_atoms else []))
    datas, _ = cli.load_complexes(args)
    data = datas["1"]
    base = data.base if all_atoms else data
    poses = (np.asarray(base.lig_pos)[None]
             + np.random.RandomState(0).randn(3, *np.asarray(base.lig_pos).shape) * 1.5).astype(np.float32)
    jdata = jax.tree.map(jnp.asarray, data)
    jmodel = j_build_model(jcfg)
    ref = jax.jit(jax.vmap(lambda q: jmodel.apply(jparams, jdata, q, jnp.asarray(0.0), js, jt)))(
        jnp.asarray(poses))
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_flax(params, cfg), strict=True)
    model.eval()
    with torch.no_grad():
        out = model(to_device(data, "cpu"), torch.from_numpy(poses), 0.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_trains_on_a_pose_cache_written_by_jax(tmp_path, monkeypatch):
    """Two generation runs' caches written by the JAX package's functions
    (its ``generate_poses_for_complex`` labels, its ``pose_cache_file``
    names, ``np.savez_compressed`` as its CLI writes them), trained on with
    ``--cache_ids_to_combine``: no generation, the complexes' poses from
    both runs; cache ids with no file for a complex raise."""
    args = cli.get_parser().parse_args(["--synthetic", "3"])
    datas, _ = cli.load_complexes(args)
    rng = np.random.RandomState(4)
    (tmp_path / "poses").mkdir()
    for cid, n in ((1, 2), (2, 3)):
        for name, d in datas.items():
            crystal = np.asarray(d.lig_pos) + np.asarray(d.original_center)
            fake = _FixedPoses((crystal[None] + rng.randn(n, *crystal.shape) * 2.0).astype(np.float32))
            poses, rmsds = jconf.generate_poses_for_complex(fake, d, n, seed=0)
            np.savez_compressed(jconf.pose_cache_file(tmp_path / "poses", name, cid), poses=poses, rmsds=rmsds)

    def no_generation(_args):
        raise AssertionError("--cache_ids_to_combine must not generate poses")

    monkeypatch.setattr(cli, "score_pipeline", no_generation)
    seen = {}
    samples_of = cli.generate_poses

    def record(a, d, t, pipeline_factory=no_generation):
        out = samples_of(a, d, t, pipeline_factory)
        seen.update(out)
        return out

    monkeypatch.setattr(cli, "generate_poses", record)
    argv = ["--synthetic", "3", "--n_epochs", "2", "--batch_size", "3", "--log_dir", str(tmp_path / "run"),
            "--pose_cache", str(tmp_path / "poses")] + SMALL
    assert cli.main(argv + ["--cache_ids_to_combine", "1", "2"]) == 0
    assert {k: v[0].shape for k, v in seen.items()} == {n: (5, 16, 3) for n in datas}
    recs = (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()
    assert len(recs) == 2
    with pytest.raises(FileNotFoundError, match="cache ids"):
        cli.main(argv + ["--cache_ids_to_combine", "7", "8"])


def test_pdbbind_layout_pads_to_one_bucket(tmp_path):
    """Two e2e_synth complexes in the PDBBind layout, all-atom: padded to
    one shared bucket with one set of widths (they stack), labelled with
    symmetry RMSD from their ligands' topology, trained for one step."""
    split = tmp_path / "train.txt"
    split.write_text("\n".join(PDBBIND) + "\n")
    argv = ["--data_dir", "data/e2e_synth", "--split_train", str(split), "--cache_path",
            str(tmp_path / "cache"), "--all_atoms", "--n_epochs", "1", "--batch_size", "2",
            "--log_dir", str(tmp_path / "run"), "--pose_cache", str(tmp_path / "poses")] + SMALL
    args = cli.get_parser().parse_args(argv)
    datas, topo = cli.load_complexes(args)
    assert set(datas) == set(PDBBIND) == set(topo)
    shapes = {n: [np.asarray(a).shape for a in d[1:]] + [np.asarray(a).shape for a in d.base]
              for n, d in datas.items()}
    assert shapes[PDBBIND[0]] == shapes[PDBBIND[1]]
    assert all(len(topo[n][0]) == int(np.asarray(datas[n].base.lig_mask).sum()) for n in PDBBIND)
    assert cli.main(argv) == 0
    for n in PDBBIND:
        with np.load(tmp_path / "poses" / f"{n}.npz") as z:
            assert z["poses"].shape == (2,) + np.asarray(datas[n].base.lig_pos).shape
            assert np.isfinite(z["rmsds"]).all()


def test_refusals(tmp_path, monkeypatch):
    """ROADMAP queue 1 item 8 is ported (the multi-rank runs are in
    test_torch_port_parallel_cli_train.py): what is refused now is two
    counts above 1 that differ, since both phases share one process group."""
    from diffdock_tpu_torch.parallel.mesh import CPU_DEVICES_ENV

    monkeypatch.delenv(CPU_DEVICES_ENV, raising=False)
    with pytest.raises(ConfigError, match="share one process group"):
        cli.main(["--synthetic", "2", "--data_parallel", "2", "--pose_devices", "3",
                  "--log_dir", str(tmp_path / "r")] + SMALL)
    # 0 means every visible device: one on the CPU
    args = cli.get_parser().parse_args(["--data_parallel", "0", "--pose_devices", "0", "--device", "cpu"])
    assert cli.phase_ranks(args) == (1, 1)
    args = cli.get_parser().parse_args(["--data_parallel", "2", "--device", "cpu"])
    assert cli.phase_ranks(args) == (1, 2)
    assert not (tmp_path / "r").exists()
