"""The train and confidence-train CLIs of the port on 2 CPU ranks, each in
a process of its own (``test_torch_port_parallel_cli.py``'s ``run_cli``):
``cli.train --data_parallel`` under ``torchrun`` and started by the CLI
itself (two visible CPU devices, ``DIFFDOCK_TPU_CPU_DEVICES=2``), and
``cli.confidence_train --data_parallel 2`` started by the CLI (generation on
rank 0, sent to rank 1) and under ``torchrun`` with both phases sharded.
Each run writes one ``metrics.jsonl`` with finite losses and a run
directory whose config aggregates the batch norms over ``"dp"``.
"""

import json

import numpy as np
import pytest

from diffdock_tpu_torch.parallel.mesh import CPU_DEVICES_ENV
from diffdock_tpu_torch.train.checkpoints import load_checkpoint
from tests.test_torch_port_parallel_cli import run_cli, run_dirs  # noqa: F401

SMALL = ["--ns", "8", "--nv", "2", "--num_conv_layers", "2", "--device", "cpu"]


def _records(log_dir):
    lines = (log_dir / "metrics.jsonl").read_text().splitlines()
    return [json.loads(line) for line in lines]


@pytest.mark.parametrize("how", ["torchrun", "spawn"])
def test_train_cli_data_parallel(run_dirs, tmp_path, how):  # noqa: F811
    log_dir = tmp_path / "run"
    log = run_cli(["diffdock_tpu_torch.cli.train", "--synthetic", "4", "--batch_size", "4", "--n_epochs", "1",
                   "--data_parallel", "--log_dir", str(log_dir), *SMALL], torchrun=how == "torchrun",
                  env_extra=None if how == "torchrun" else {CPU_DEVICES_ENV: "2"})
    assert log.count("mesh: 2 ranks over gloo") == 1
    records = _records(log_dir)
    assert [r["phase"] for r in records] == ["train"] and records[0]["steps"] == 1
    assert np.isfinite(records[0]["loss"])
    _, cfg, _ = load_checkpoint(str(log_dir))
    assert tuple(cfg.bn_axis_names) == ("batch", "dp")


@pytest.mark.parametrize("how,flags", [
    ("spawn", ["--data_parallel", "2"]),
    ("torchrun", ["--data_parallel", "0", "--pose_devices", "0"]),
])
def test_confidence_train_cli_data_parallel(run_dirs, tmp_path, how, flags):  # noqa: F811
    log_dir = tmp_path / "run"
    log = run_cli(["diffdock_tpu_torch.cli.confidence_train", "--synthetic", "4", "--batch_size", "3",
                   "--n_epochs", "1", "--samples_per_complex", "2", "--inference_steps", "2",
                   "--pose_cache", str(tmp_path / "poses"), "--log_dir", str(log_dir), *flags, *SMALL],
                  torchrun=how == "torchrun")
    assert log.count("generated 2 poses") == 4  # rank 0 reports each complex once
    records = _records(log_dir)
    assert [r["phase"] for r in records] == ["train"] and np.isfinite(records[0]["loss"])
    assert sorted(p.name for p in (tmp_path / "poses").iterdir()) == [f"{i}.npz" for i in range(4)]
    _, cfg, _ = load_checkpoint(str(log_dir), "last_model.msgpack")
    assert tuple(cfg.bn_axis_names) == ("batch", "dp")
