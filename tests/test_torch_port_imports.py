"""The PyTorch port's import boundary and its host-side bond analysis.

``diffdock_tpu_torch`` and ``chip_smoke.py`` run on a machine that has
PyTorch, numpy and scipy but no JAX, flax, networkx, PyYAML, msgpack or
RDKit, and the port must never lean on the JAX package. The AST check below
holds every import statement of the port to that rule.
"""

import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from diffdock_tpu.geometry.torsion import rotatable_bond_mask as jax_rotatable_bond_mask
from diffdock_tpu_torch.geometry.torsion import rotatable_bond_mask

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "diffdock_tpu", "networkx", "yaml",
             "msgpack", "rdkit"}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_files():
    files = sorted((REPO / "diffdock_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


def test_port_imports_nothing_missing_on_the_card_machine():
    files = _port_files()
    assert len(files) > 20 and (REPO / "chip_smoke.py").exists()
    bad = [
        f"{p.relative_to(REPO)}:{line} imports {mod}"
        for p in files
        for line, mod in _imported_roots(p)
        if mod in FORBIDDEN
    ]
    assert not bad, "\n".join(bad)


@pytest.mark.parametrize("module", [
    "ops/fused_tp3.py", "ops/factored_tp2.py", "ops/factored_tp1.py", "models/old_models.py",
    "models/score_model.py", "inference/pipeline.py", "data/complexes.py", "utils/convert.py",
    "data/chem.py", "data/chi.py", "native.py", "data/featurize.py", "data/esm.py",
    "data/inference_dataset.py", "train/checkpoints.py", "utils/flax_msgpack.py",
    "utils/simple_yaml.py", "inference/sampler.py", "utils/visualise.py", "cli/dock.py",
    "inference/ladder.py", "data/datasets.py", "data/moad.py", "eval/rmsd.py", "eval/metrics.py",
    "eval/gnina.py", "cli/evaluate.py", "train/noise.py", "train/losses.py", "train/trainer.py",
    "train/schedulers.py", "train/validation.py", "data/loaders.py", "utils/logging.py",
    "cli/train.py", "models/aa_model.py", "models/factory.py", "models/tpconv.py",
    "train/confidence.py", "cli/confidence_train.py", "app/__init__.py", "app/server.py",
    "cli/main.py", "data/pdb_sidechain.py", "models/esm2.py", "cli/esm_prep.py", "cli/prewarm.py",
    "data/conformers.py", "utils/profiling.py", "geometry/rotations.py",
    "parallel/__init__.py", "parallel/mesh.py",
])
def test_port_modules_are_in_the_checked_set(module):
    assert REPO / "diffdock_tpu_torch" / module in _port_files()


def test_kernel_sources_include_no_jax_and_no_pytorch_headers():
    """The CUDA sources include only the CUDA runtime, its bfloat16 header
    and the driver API's header (``cuda.h``, for the tensor-map types of
    ``fused_tp3_bf16.cu``; the encoder is reached through the runtime, so
    nothing more is linked), the C++ standard library and headers of
    ``csrc/`` itself (checked here as sources): nothing of JAX or the JAX
    package (and no PyTorch headers, which would turn a seconds-long build
    into minutes)."""
    csrc = REPO / "diffdock_tpu_torch" / "csrc"
    sources = sorted(csrc.glob("*.cu*"))
    assert {p.name for p in sources} >= {"fused_tp3.cu", "factored_tp2.cu", "factored_tp1.cu",
                                         "tp_mma.cuh", "factored_tp.cuh", "fused_tp3_bf16.cu",
                                         "tp_hopper.cuh"}
    for path in sources:
        includes = re.findall(r'^\s*#\s*include\s*[<"]([^>"]+)[>"]', path.read_text(), re.M)
        assert includes, path.name
        for inc in includes:
            root = inc.split("/")[0].split(".")[0]
            assert root not in FORBIDDEN | {"torch", "ATen", "c10", "pybind11"}, f"{path.name}: {inc}"
            local = "/" not in inc and (csrc / inc).is_file()
            assert inc in ("cuda_runtime.h", "cuda_bf16.h", "cuda.h") or "." not in inc or local, \
                f"{path.name}: {inc}"


def test_port_imports_are_checked_by_the_ast_walk():
    """The walk sees nested and relative-free ``from`` imports alike."""
    src = "import os\ndef f():\n    from jax import numpy\n    import networkx.algorithms\n"
    tmp = ast.parse(src)
    found = set()
    for node in ast.walk(tmp):
        if isinstance(node, ast.Import):
            found |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            found.add(node.module.split(".")[0])
    assert {"jax", "networkx"} <= found


def _random_graph(rng, n):
    """A random tree with a few extra ring-closing bonds, sometimes with a
    second fragment."""
    bonds = [(int(rng.randint(i)), i) for i in range(1, n)]
    for _ in range(rng.randint(0, 3)):
        i, j = sorted(rng.choice(n, 2, replace=False))
        if (i, j) not in bonds and (j, i) not in bonds:
            bonds.append((int(i), int(j)))
    if rng.rand() < 0.3:
        m = n + rng.randint(2, 5)
        bonds += [(k, k + 1) for k in range(n, m - 1)]
        n = m
    rng.shuffle(bonds)
    bonds = [(b, a) if rng.rand() < 0.5 else (a, b) for a, b in bonds]
    return n, bonds


@pytest.mark.parametrize("seed", range(6))
def test_rotatable_bond_mask_matches_networkx_version(seed):
    rng = np.random.RandomState(seed)
    for _ in range(8):
        n, bonds = _random_graph(rng, int(rng.randint(3, 24)))
        em, mr = rotatable_bond_mask(n, bonds)
        jem, jmr = jax_rotatable_bond_mask(n, bonds)
        np.testing.assert_array_equal(em, jem)
        np.testing.assert_array_equal(mr, jmr)


def test_rotatable_bond_mask_chain_and_ring():
    # butane-like chain: only the middle bond moves more than one atom; the
    # two halves tie in size, so the first one found ({0, 1}) moves, along
    # the directed edge 2 -> 1
    em, mr = rotatable_bond_mask(4, [(0, 1), (1, 2), (2, 3)])
    assert em.tolist() == [False, False, False, True, False, False]
    assert mr.tolist() == [[True, True, False, False]]
    # a ring has no bridge bonds
    em, mr = rotatable_bond_mask(4, [(0, 1), (1, 2), (2, 3), (3, 0)])
    assert not em.any() and mr.shape == (0, 4)
