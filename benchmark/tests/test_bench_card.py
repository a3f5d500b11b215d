"""On the card (``cuda`` marker; each test skips without one): the control,
the reference in TF32 in the program's place, comes out not correct under
each cell's limits, and the program comes out correct, at the cells'
widths on small complexes and a short schedule. Run there with
``python -m pytest --noconftest -m cuda benchmark/tests``."""

import argparse
import json
import shutil
import time

import pytest
import torch

from benchmark import calibrate
from benchmark.harness import check, main, spec

SMALL = dict(cycle=[[20, 120], [16, 90], [24, 150]], warmup_steps=1)


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def small_root(tmp):
    bench = spec.load_json(spec.find_benchmark())
    for sub in ("configs", "traffic", "limits"):
        (tmp / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(spec.BENCH_DIR / "metrics", tmp / "metrics")
    for c in bench["configs"]:
        cfg = spec.load_json(spec.BENCH_DIR / "configs" / f"{c['name']}.json")
        cfg["sampler"].update(inference_steps=6, actual_steps=5)
        (tmp / "configs" / f"{c['name']}.json").write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        t = spec.load_json(spec.BENCH_DIR / "traffic" / f"{w['traffic']}.json")
        t.update(SMALL)
        (tmp / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(t))
        lim = spec.load_json(spec.BENCH_DIR / "limits" / f"{w['name']}.json")
        (tmp / "limits" / f"{w['name']}.json").write_text(json.dumps(lim))
    return tmp, bench


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["dl-mix-p10", "v1-mix-p10"])
def test_control_fails_and_program_passes(tmp_path, workload):
    need_card()
    root, bench = small_root(tmp_path)
    out = calibrate.readings(workload, [11, 12, 13], [21, 22, 23], device="cuda", root=root, benchmark=bench)
    limits = spec.load_cell(workload, bench, root).limits["limits"]
    assert all(d[k] <= limits[k] for d in out["program"] for k in check.NUMBERS), out["program"]
    for seed in (21, 22, 23):
        docks = [d for d in out["control"] if d["seed"] == seed]
        assert any(d[k] > limits[k] for d in docks for k in check.NUMBERS), docks


@pytest.mark.cuda
def test_a_small_run_on_the_card(tmp_path):
    need_card()
    root, bench = small_root(tmp_path)
    args = argparse.Namespace(workload="dl-mix-p10", seed=2**31 + 5, seconds=1.0, trace=1)
    r = main.run(args, time.perf_counter(), device="cuda", root=root, benchmark=bench)
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0 and r["device"]["window_s"] > 0
    assert set(r["metrics"]) == {m["name"] for m in bench["per_layer"]}
    assert 0 < r["metrics"]["fused_tp3_roofline"]["value"] <= 100
