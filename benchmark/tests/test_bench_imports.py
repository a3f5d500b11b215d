"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: ``diffdock_tpu_torch`` is not ``diffdock_tpu``),
and the reference imports nothing of the port."""

import ast
from pathlib import Path

import pytest

from benchmark.harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "diffdock_tpu"}
SOURCES = sorted(p for p in spec.BENCH_DIR.rglob("*.py") if "_build" not in p.parts)


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_sources_found():
    assert len(SOURCES) > 30


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(spec.BENCH_DIR)))
def test_no_jax(path):
    assert not FORBIDDEN & set(top_level_imports(path))


@pytest.mark.parametrize("path", [p for p in SOURCES if "reference" in p.relative_to(spec.BENCH_DIR).parts],
                         ids=lambda p: str(p.relative_to(spec.BENCH_DIR)))
def test_reference_imports_nothing_of_the_port(path):
    assert "diffdock_tpu_torch" not in set(top_level_imports(path))


def test_the_check_compares_whole_names():
    from benchmark.harness.main import FORBIDDEN as RUN_FORBIDDEN

    assert set(RUN_FORBIDDEN) == FORBIDDEN
    assert "diffdock_tpu_torch".split(".")[0] not in RUN_FORBIDDEN
