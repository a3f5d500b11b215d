"""The port's train CLI (``diffdock_tpu_torch.cli.train``) on the CPU.

``--synthetic`` runs write the JAX CLI's run directory: the same file set
(every checkpoint flavour, ``train_state.msgpack``, ``metrics.jsonl``,
``history.json``); the JAX package's ``load_checkpoint`` and
``load_train_state`` read it; the port's dock CLI docks from its
``last_ema_model``. ``--restart_dir`` resumes the full state (and falls
back to the weights), ``--pretrain_dir`` loads weights, the PDBBind path
runs with a validation split, ``--dataset moad``, ``--combined_training``
and ``--triple_training`` train from MOAD and PDBSidechain layouts (those of
``tests/test_torch_port_loaders.py``), and the options once refused
naming their ROADMAP items run: ``--data_parallel`` on one CPU rank, and
the sidechain loss weights, which build the sidechain head and add their
losses.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdock_tpu.data import complexes as j_complexes
from diffdock_tpu.models.config import PRESETS as J_PRESETS
from diffdock_tpu.models.score_model import CGScoreModel as JCGScoreModel
from diffdock_tpu.train import checkpoints as jckpt
from diffdock_tpu.train import trainer as jtrainer
from diffdock_tpu_torch.cli import dock as dock_cli
from diffdock_tpu_torch.cli import train as train_cli
from diffdock_tpu_torch.data.complexes import synthetic_complex
from tests.test_torch_port_datasets import SYNTH
from tests.test_torch_port_moad import layout  # noqa: F401
from tests.test_torch_port_pdb_sidechain import sc_dir  # noqa: F401

SMALL = ["--ns", "8", "--nv", "2", "--num_conv_layers", "2", "--device", "cpu", "--batch_size", "2"]
# the files the JAX CLI writes for a run with validation docking and a
# secondary metric (diffdock_tpu/cli/train.py:419-473)
RUN_FILES = {
    "model_parameters.yml", "train_state.msgpack", "metrics.jsonl", "history.json",
    "last_model.msgpack", "last_ema_model.msgpack", "best_ema_model.msgpack", "best_model.msgpack",
    "best_ema_inference_epoch_model.msgpack", "best_inference_epoch_model.msgpack",
    "best_ema_secondary_epoch_model.msgpack",
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def small_tables():
    """The CLIs' SO(3) and torus tables at the tests' small grids."""
    from diffdock_tpu_torch.diffusion import so3, torus
    from diffdock_tpu_torch.inference import pipeline

    get_so3, get_torus = so3.get_so3_tables, torus.get_torus_tables
    small_so3 = lambda cfg=None, device="cuda": get_so3(  # noqa: E731
        so3.SO3Config(n_eps=64, x_n=256, l_max=512), device)
    small_torus = lambda cfg=None, device="cuda": get_torus(  # noqa: E731
        torus.TorusConfig(x_n=256, sigma_n=128, mc_samples=2000), device)
    with pytest.MonkeyPatch.context() as mp:
        for mod in (so3, pipeline):
            mp.setattr(mod, "get_so3_tables", small_so3)
        for mod in (torus, pipeline):
            mp.setattr(mod, "get_torus_tables", small_torus)
        yield


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory, small_tables):
    out = tmp_path_factory.mktemp("train") / "run"
    rc = train_cli.main(["--synthetic", "4", "--n_epochs", "2", "--log_dir", str(out),
                         "--val_inference_freq", "2", "--num_inference_complexes", "1",
                         "--inference_steps", "2", "--inference_samples", "2",
                         "--inference_secondary_metric", "valinf_rmsds_lt5", *SMALL])
    assert rc == 0
    return out


def test_synthetic_run_writes_the_jax_cli_file_set(run_dir):
    assert set(os.listdir(run_dir)) == RUN_FILES
    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["phase"] for r in records] == ["train", "train", "val_inference"]
    assert all(np.isfinite(r["loss"]) and r["steps"] == 2 for r in records[:2])
    history = json.loads((run_dir / "history.json").read_text())
    assert len(history) == 2 and np.all(np.isfinite(history))


def test_jax_package_reads_the_run_directory(run_dir):
    params, jcfg, extra = jckpt.load_checkpoint(str(run_dir), "last_ema_model.msgpack")
    want = dataclasses.replace(J_PRESETS["diffdock_s"], ns=8, nv=2, num_conv_layers=2,
                               bn_axis_names=("batch",))
    assert jcfg == want and extra == {"epoch": 1}
    data = j_complexes.pad_to(j_complexes.synthetic_complex(np.random.RandomState(0), n_lig=16,
                                                            n_rec=64, n_bonds=4), 16, 64, 8)
    data = jax.tree.map(jnp.asarray, data)
    model = JCGScoreModel(jcfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), data, data.lig_pos, jnp.asarray(0.5),
                            *_jax_tables())
    leaf_shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)  # noqa: E731
    assert leaf_shapes(params) == leaf_shapes(shapes)
    # the full state into a JAX template
    tc = jtrainer.TrainConfig()
    template = jtrainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=params["params"], batch_stats=params["batch_stats"],
        opt_state=jtrainer.make_optimizer(tc).init(params["params"]), ema_params=params["params"])
    restored = jckpt.load_train_state(str(run_dir), template)
    assert int(restored.step) == 4  # 2 epochs of 2 batches
    np.testing.assert_array_equal(
        np.asarray(restored.ema_params["final_conv"]["fc"]["out_kernel"]),
        params["params"]["final_conv"]["fc"]["out_kernel"])


def _jax_tables():
    from diffdock_tpu.diffusion.so3 import SO3Config, get_so3_tables
    from diffdock_tpu.diffusion.torus import TorusConfig, get_torus_tables

    return (get_so3_tables(SO3Config(n_eps=64, x_n=256, l_max=512)),
            get_torus_tables(TorusConfig(x_n=256, sigma_n=128, mc_samples=2000)))


def test_port_dock_loads_the_last_ema_model(run_dir):
    args = dock_cli.get_parser().parse_args([
        "--model_dir", str(run_dir), "--ckpt", "last_ema_model.msgpack", "--device", "cpu",
        "--inference_steps", "2", "--actual_steps", "2"])
    pipe = dock_cli.load_pipeline(args)
    data = synthetic_complex(np.random.RandomState(1), n_lig=12, n_rec=40, n_bonds=2)
    res = pipe.dock_complex(data, num_poses=2, seed=0)
    assert res.poses.shape == (2, 12, 3) and np.isfinite(res.poses).all()


def test_restart_resumes_and_falls_back_to_weights(run_dir, tmp_path, capsys):
    out = tmp_path / "resumed"
    assert train_cli.main(["--synthetic", "4", "--n_epochs", "1", "--log_dir", str(out),
                           "--restart_dir", str(run_dir), *SMALL]) == 0
    assert "at step 4" in capsys.readouterr().out
    # without the train state: the weights only
    weights_only = tmp_path / "weights_only"
    weights_only.mkdir()
    for f in ("model_parameters.yml", "last_ema_model.msgpack"):
        (weights_only / f).write_bytes((run_dir / f).read_bytes())
    assert train_cli.main(["--synthetic", "2", "--n_epochs", "1", "--log_dir", str(tmp_path / "r2"),
                           "--restart_dir", str(weights_only), *SMALL]) == 0
    assert "falling back to weights-only restart" in capsys.readouterr().out
    assert train_cli.main(["--synthetic", "2", "--n_epochs", "1", "--log_dir", str(tmp_path / "r3"),
                           "--pretrain_dir", str(weights_only), *SMALL]) == 0
    assert "pretrained weights loaded" in capsys.readouterr().out


def test_pdbbind_path_with_a_validation_split(tmp_path):
    (tmp_path / "train.txt").write_text("syn044_l9r90\nsyn131_l25r90\n")
    (tmp_path / "val.txt").write_text("syn128_l41r90\n")
    out = tmp_path / "run"
    assert train_cli.main(["--data_dir", str(SYNTH), "--split_train", str(tmp_path / "train.txt"),
                           "--split_val", str(tmp_path / "val.txt"), "--cache_path",
                           str(tmp_path / "cache"), "--n_epochs", "1", "--log_dir", str(out),
                           "--num_workers", "0", *SMALL]) == 0
    records = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["phase"] for r in records] == ["train", "val"]
    assert all(np.isfinite(r["loss"]) for r in records)


@pytest.mark.parametrize("flags,item", [
    # ROADMAP queue 1 item 8 is ported: --data_parallel trains on every
    # visible device, one rank each (one CPU rank here; the multi-rank runs
    # are in test_torch_port_parallel_cli_train.py), and the run directory
    # records the batch norms' "dp" axis, as the JAX CLI's does
    pytest.param(["--data_parallel"], 8, id="flags4-item 8"),
    # ROADMAP queue 1 item 5 is ported: these two now train the sidechain head
    pytest.param(["--backbone_loss_weight", "0.5"], 5, id="flags5-item 5"),
    pytest.param(["--sidechain_loss_weight", "0.5"], 5, id="flags6-item 5"),
])
def test_unported_options_raise_and_name_their_item(tmp_path, monkeypatch, flags, item):
    from diffdock_tpu_torch.parallel.mesh import CPU_DEVICES_ENV

    monkeypatch.delenv(CPU_DEVICES_ENV, raising=False)
    argv = ["--synthetic", "2", "--log_dir", str(tmp_path), *flags, *SMALL]
    assert train_cli.main(argv + ["--n_epochs", "1", "--num_workers", "0"]) == 0
    from diffdock_tpu_torch.train.checkpoints import load_checkpoint

    params, cfg, _ = load_checkpoint(str(tmp_path))
    if item == 8:
        assert tuple(cfg.bn_axis_names) == ("batch", "dp") and not cfg.sidechain_pred
    else:
        assert cfg.sidechain_pred and "sidechain_predictor" in params["params"]
    records = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["phase"] for r in records] == ["train"] and np.isfinite(records[0]["loss"])


@pytest.mark.parametrize("flags,sources", [
    (["--dataset", "moad"], {"moad"}),
    (["--dataset", "pdbsidechain", "--remove_second_segment"], {"pdbsidechain"}),
    (["--combined_training"], {"pdbbind", "moad"}),
    (["--triple_training", "--val_inference_freq", "1", "--num_inference_complexes", "1",
      "--inference_steps", "2", "--inference_samples", "2"], {"pdbbind", "moad", "pdbsidechain"}),
])
def test_data_sources_train_through_the_cli(tmp_path, layout, sc_dir, monkeypatch, flags,  # noqa: F811
                                            sources):
    """Two epochs from MOAD, PDBSidechain and their combinations
    (``--triple_training`` implies ``--combined_training``): finite losses,
    every epoch's batches drawn from each source the flags name, the
    validation docking of the source's first items, no validation-loss
    set (as in the JAX CLI)."""
    from diffdock_tpu_torch.data import loaders

    (tmp_path / "train.txt").write_text("syn044_l9r90\nsyn131_l25r90\nsyn001_l24r104\n")
    (tmp_path / "val.txt").write_text("syn128_l41r90\n")
    epochs = []
    real = loaders.iter_bucketed_batches

    def recorded(items, batch_size, flush_partial=True):
        epochs.append(set())
        for names, batch in real(items, batch_size, flush_partial):
            epochs[-1].update(names)
            yield names, batch

    monkeypatch.setattr(loaders, "iter_bucketed_batches", recorded)
    out = tmp_path / "run"
    assert train_cli.main(["--data_dir", str(SYNTH), "--split_train", str(tmp_path / "train.txt"),
                           "--split_val", str(tmp_path / "val.txt"), "--moad_dir", str(layout[0]),
                           "--pdbsidechain_dir", str(sc_dir), "--cache_path", str(tmp_path / "cache"),
                           "--n_epochs", "2", "--log_dir", str(out), "--num_workers", "0",
                           *flags, *SMALL]) == 0
    records = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    want = ["train"] * 2 if "--val_inference_freq" not in flags else ["train", "val_inference"] * 2
    assert [r["phase"] for r in records] == want
    assert all(np.isfinite(r["loss"]) for r in records if r["phase"] == "train")
    source_of = lambda n: "pdbbind" if n.startswith("syn") else "moad" if n[:2] == "s0" else "pdbsidechain"  # noqa: E731
    assert len(epochs) == 2 and all({source_of(n) for n in e} == sources for e in epochs)


@pytest.mark.parametrize("scheduler", ["plateau", "layer_linear_warmup"])
def test_schedulers_run_through_the_cli(tmp_path, scheduler, capsys):
    """Four epochs with a scheduler: the layer warmup's stages (warmup_dur
    1: a new stage each epoch, the EMA re-initialized at the handoff) and
    the plateau's patience 0 (the LR scale drops on the first epoch that
    does not improve)."""
    cfg = tmp_path / "train.yml"
    cfg.write_text(f"scheduler: {scheduler}\nscheduler_patience: 0\nwarmup_dur: 1\n")
    assert train_cli.main(["--config", str(cfg), "--synthetic", "4", "--n_epochs", "4",
                           "--log_dir", str(tmp_path / "run"), *SMALL]) == 0
    out = capsys.readouterr().out
    records = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert len(records) == 4 and all(np.isfinite(r["loss"]) for r in records)
    if scheduler == "layer_linear_warmup":
        assert [line.strip() for line in out.splitlines() if "warmup stage" in line] == \
            ["warmup stage 1", "warmup stage 2", "warmup stage 3"]  # (e + 1) // warmup_dur
        assert "warmup complete" in out


def test_host_controllers_match_jax():
    """The layer-warmup schedule and the plateau scheduler against the JAX
    package's, on the same inputs."""
    from diffdock_tpu.train import schedulers as jschedulers
    from diffdock_tpu.train import validation as jvalidation
    from diffdock_tpu_torch.train import schedulers, validation

    ours, ref = schedulers.LayerWarmupScheduler(3, 2, 0.01), jschedulers.LayerWarmupScheduler(3, 2, 0.01)
    assert [ours.epoch_update(e) for e in range(14)] == [ref.epoch_update(e) for e in range(14)]
    assert ours.total_warmup_epochs == ref.total_warmup_epochs
    for path in (("conv_1", "fc_0", "Dense_0", "kernel"), ("tr_final_layer", "Dense_0", "bias"),
                 ("rec_emb_0", "bn", "weight"), ("lig_node_embedding", "cat_0", "embedding")):
        assert schedulers.unfreeze_stage(path, 3) == jschedulers.unfreeze_stage(path, 3)
    metrics = np.random.RandomState(0).rand(30).tolist()
    a, b = validation.PlateauScheduler(patience=2), jvalidation.PlateauScheduler(patience=2)
    assert [a.step(m) for m in metrics] == [b.step(m) for m in metrics]


def test_metrics_writer_writes_the_jax_records(tmp_path):
    from diffdock_tpu.utils import logging as jlogging
    from diffdock_tpu_torch.utils import logging

    for mod, name in ((logging, "ours.jsonl"), (jlogging, "ref.jsonl")):
        w = mod.MetricsWriter(str(tmp_path / name))
        w.log(3, "train", loss=np.float32(0.5), steps=2, note="x")
        w.log(4, "val", loss=float("nan"))
        w.close()
        mod.MetricsWriter(None).log(0, "noop", loss=1.0)
    assert (tmp_path / "ours.jsonl").read_text() == (tmp_path / "ref.jsonl").read_text()
