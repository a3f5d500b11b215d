"""Every cell's files are found by name, and BENCHMARK.json keeps to its
contract's shape."""

import json
import re

import pytest

from benchmark.harness import spec

BENCH = spec.load_json(spec.find_benchmark())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    cell = spec.load_cell(w["name"], BENCH)
    assert cell.chips == 1
    assert cell.config["name"] == w["config"]
    assert cell.traffic["poses"] >= 1 and cell.traffic["cycle"]
    assert set(cell.limits["limits"]) == {"start_gap_A", "score_gap", "update_gap_A", "conf_gap",
                                          "ranked_gap"}
    assert {m["name"] for m in cell.end_to_end} == {"poses_per_s", "dock_p95_s", "peak_mem_gib", "setup_s"}
    assert len(cell.per_layer) == 8


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_readers_found_by_name(m):
    assert callable(spec.metric_reader(m["name"]))
    assert m["moves"] == "poses_per_s"
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_names_units_and_bounds():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"pipeline", "score step", "confidence model", "tensor-product conv", "dispatch",
                      "device"}
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    cfg = spec.load_json(spec.BENCH_DIR.parent / c["file"])
    assert cfg["name"] == c["name"] and c["reduced"] == []
    # the published widths stand as published
    for key, value in cfg["published"].items():
        where = [cfg["score_model"], cfg["score_model"]["sigma"], cfg["sampler"]]
        found = [d[key] for d in where if key in d]
        if found:
            assert found[0] == value, key
