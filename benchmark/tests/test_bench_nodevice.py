"""Without the card the run fails and prints no result; it never falls
back to the CPU."""

import subprocess
import sys

import torch

from benchmark.harness import spec


def test_run_fails_without_a_card():
    if torch.cuda.is_available():
        return  # the card is there: nothing to show here
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "dl-mix-p10", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=spec.BENCH_DIR.parent, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "torch.cuda.is_available() is false" in p.stderr


def test_run_fails_with_only_the_benchmarks_files(tmp_path):
    """A directory that holds BENCHMARK.json and the benchmark's folder
    alone has no program to measure."""
    import shutil

    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark", ignore=shutil.ignore_patterns("_build"))
    shutil.copy(spec.find_benchmark(), tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "dl-mix-p10", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
