"""The port's device mesh (``diffdock_tpu_torch/parallel/mesh.py``) on the
CPU: gloo ranks spawned through ``mesh.launch`` with a ``file://`` store.

The parent computes JAX's references on 2 of the conftest's 8 virtual CPU
devices; the ranks run ``tests/torch_port_parallel_ranks.py``, which
imports no JAX. Checked here: the batch norms of 2 ranks, each holding half
a masked batch, against 1 rank on the whole batch (outputs, running
statistics, input and weight gradients, within 1e-5 of scale) and the
irreps norm against JAX's with ``axis_names=("dp",)`` under ``shard_map``;
``shard_pose_sampler`` (distinct shards, repeatable); the kernel build of a
multi-rank run (rank 0 runs ``nvcc``, a stub here, once per library); a
rank's failure raising on every rank and out of ``launch``; the placement
rules and the pipeline's mesh argument.
"""

import ast
import os
import stat
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdock_tpu.ops.batch_norm import IrrepsBatchNorm as JIrrepsBatchNorm
from diffdock_tpu.ops.irreps import Irreps as JIrreps
from diffdock_tpu.parallel.mesh import make_mesh as jmake_mesh
from diffdock_tpu_torch.inference.pipeline import DockingPipeline
from diffdock_tpu_torch.inference.sampler import SamplerConfig
from diffdock_tpu_torch.models.config import ConfigError, ScoreModelConfig
from diffdock_tpu_torch.parallel import mesh as mesh_mod
from tests import torch_port_parallel_ranks as ranks

IRREPS = "3x0e+2x1o+1x2e"
RTOL = 1e-5  # module outputs and gradients, of their scale


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs():
    rng = np.random.RandomState(0)
    dim = sum(m * (2 * l + 1) for m, l in ((3, 0), (2, 1), (1, 2)))
    x = (rng.randn(2, 7, dim) * 2 + 0.5).astype(np.float32)
    mask = rng.rand(2, 7) > 0.3
    return dict(x=x, mask=mask, irreps=IRREPS, x_scalar=rng.randn(4, 6).astype(np.float32),
                upstream=rng.randn(2, 7, dim).astype(np.float32),
                upstream_scalar=rng.randn(4, 6).astype(np.float32))


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """One 2-rank spawn for the module's jobs; the stub nvcc on PATH counts
    its calls."""
    out = tmp_path_factory.mktemp("ranks")
    bin_dir = out / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(f'#!/bin/sh\necho "$@" >> {out}/nvcc_calls\n'
                    'while [ $# -gt 0 ]; do if [ "$1" = "-o" ]; then shift; : > "$1"; fi; shift; done\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    jobs = [("bn", "batch_norms", _inputs()),
            ("sampler", "pose_sampler", dict(n_poses=8, seed=3)),
            ("build", "build_kernels", dict(build_dir=str(out / "build"))),
            ("run_failure", "run_failure", {})]
    env_path = os.environ["PATH"]
    os.environ["PATH"] = f"{bin_dir}:{env_path}"
    try:
        assert mesh_mod.launch(ranks.run, (str(out), jobs), 2, "cpu") == 0
    finally:
        os.environ["PATH"] = env_path
    return out


def _close(ours, ref, what):
    scale = max(np.abs(ref).max(initial=0.0), 1.0)
    err = np.abs(ours - ref).max(initial=0.0)
    assert err <= RTOL * scale, f"{what}: {err:.3e} > {RTOL} x {scale:.3e}"


@pytest.mark.parametrize("kind", ["irreps", "scalar"])
def test_batch_norm_over_two_ranks_equals_one_rank_on_the_whole_batch(spawned, kind):
    got = [r[kind] for r in ranks.results(spawned, "bn")]
    ref = ranks.batch_norms(None, **_inputs())[kind]
    _close(np.concatenate([g["y"] for g in got]), ref["y"], "output")
    _close(np.concatenate([g["grad_x"] for g in got]), ref["grad_x"], "input gradient")
    # each rank's weight gradient is its shard's; their sum is the batch's
    for k in ("grad_w", "grad_b"):
        _close(got[0][k] + got[1][k], ref[k], k)
    for k in ("mean", "var"):
        _close(got[0][k], ref[k], k)
        np.testing.assert_array_equal(got[0][k], got[1][k])


def test_irreps_batch_norm_over_two_ranks_matches_jax_under_shard_map(spawned):
    """JAX's module with ``axis_names=("dp",)`` under ``shard_map`` on 2
    devices, each holding one complex's rows (the port's ranks hold one
    complex each, so both clamp the same row counts)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    inp = _inputs()
    x, mask, up = jnp.asarray(inp["x"]), jnp.asarray(inp["mask"]), jnp.asarray(inp["upstream"])
    irreps = JIrreps(IRREPS)
    stats = JIrrepsBatchNorm(irreps).init(jax.random.PRNGKey(0), x[0], mask[0])["batch_stats"]
    nf = irreps.num_irreps
    params = {"weight": jnp.linspace(0.5, 1.5, nf), "bias": jnp.zeros(3)}
    bn = JIrrepsBatchNorm(irreps, axis_names=("dp",))

    def local(xs, ms):
        y, mut = bn.apply({"params": params, "batch_stats": stats}, xs, ms, train=True,
                          mutable=["batch_stats"])
        return y, mut["batch_stats"]

    fn = shard_map(local, mesh=jmake_mesh(2), in_specs=(P("dp"), P("dp")),
                   out_specs=(P("dp"), P()), check_vma=False)
    y, new_stats = jax.jit(fn)(x, mask)
    grad_x = jax.jit(jax.grad(lambda xx: (fn(xx, mask)[0] * up).sum()))(x)
    got = [r["irreps"] for r in ranks.results(spawned, "bn")]
    _close(np.concatenate([g["y"] for g in got]), np.asarray(y), "output")
    _close(np.concatenate([g["grad_x"] for g in got]), np.asarray(grad_x), "input gradient")
    _close(got[0]["mean"], np.asarray(new_stats["mean"]), "running mean")
    _close(got[0]["var"], np.asarray(new_stats["var"]), "running var")


def test_shard_pose_sampler_folds_the_rank_into_the_seed(spawned):
    """The counterpart of ``tests/test_pose_sharding.py``'s first test:
    poses sharded, data replicated, distinct noise per shard, the same
    output for the same seed, and the same gathered output on each rank."""
    got = ranks.results(spawned, "sampler")
    out = got[0][0]
    assert out.shape == (8, 5, 3)
    a, b = out[:4], out[4:]
    assert not np.allclose(a, b)
    np.testing.assert_array_equal(out, got[0][1])
    np.testing.assert_array_equal(out, got[1][0])


def test_rank_zero_builds_each_kernel_library_once(spawned):
    calls = (spawned / "nvcc_calls").read_text().splitlines()
    libs = mesh_mod.kernel_libraries()
    assert len(calls) == len(libs)
    assert sorted(Path(c.split(" -o ")[1].split()[0]).name.split("-")[0] for c in calls) == \
        sorted(f"lib{n}" for n in libs)
    assert all(all(r.values()) for r in ranks.results(spawned, "build"))


def test_a_failure_on_one_rank_raises_on_every_rank_and_out_of_launch(spawned, tmp_path):
    msgs = ranks.results(spawned, "run_failure")
    assert msgs[0] == msgs[1] and "rank 1: ZeroDivisionError" in msgs[0]
    with pytest.raises(mesh_mod.RankFailure, match="rank 1 of 2"):
        mesh_mod.launch(ranks.run, (str(tmp_path), [("x", "raise_on_rank", dict(rank=1))]), 2, "cpu")


def test_placement_rules(monkeypatch):
    monkeypatch.delenv(mesh_mod.CPU_DEVICES_ENV, raising=False)
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert mesh_mod.visible_devices("cpu") == 1
    assert mesh_mod.ranks_for(0, "cpu") == 1 and mesh_mod.ranks_for(3, "cpu") == 3
    monkeypatch.setenv(mesh_mod.CPU_DEVICES_ENV, "2")
    assert mesh_mod.ranks_for(0, "cpu") == 2
    assert mesh_mod.backend_for(2, "cpu") == "gloo"
    assert mesh_mod.rank_device(1, "cpu") == torch.device("cpu")
    # under torchrun the group's size rules
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "1")
    assert mesh_mod.ranks_for(0, "cpu") == 2 and mesh_mod.ranks_for(2, "cpu") == 2
    assert mesh_mod.ranks_for(1, "cpu", allow_one=True) == 1
    for n in (1, 3):
        with pytest.raises(ConfigError, match="group of 2"):
            mesh_mod.ranks_for(n, "cpu")
    with pytest.raises(RuntimeError, match="process group"):
        mesh_mod.make_mesh()
    seeds = {mesh_mod.fold_seed(s, i) for s in range(3) for i in range(3)}
    assert len(seeds) == 9 and mesh_mod.fold_seed(2, 1) == mesh_mod.fold_seed(2, 1)
    m = mesh_mod.Mesh(2, 1, "cpu", "gloo")
    assert m.shard(6) == slice(3, 6) and not m.is_main
    with pytest.raises(ValueError, match="does not split"):
        m.shard(5)


def test_the_pipeline_takes_a_mesh_and_a_mesh_of_one_docks_as_before():
    so3, torus = ranks.tables()
    cfg = ScoreModelConfig(ns=8, nv=2, num_conv_layers=2, num_prot_emb_layers=0)
    from diffdock_tpu_torch.data.complexes import synthetic_complex

    data = synthetic_complex(np.random.RandomState(0), n_lig=8, n_rec=14, n_bonds=2)
    plain = DockingPipeline(cfg, 0, SamplerConfig(inference_steps=2, actual_steps=2), so3, torus, device="cpu")
    one = DockingPipeline(cfg, 0, SamplerConfig(inference_steps=2, actual_steps=2), so3, torus, device="cpu",
                          mesh=mesh_mod.Mesh(1, 0, "cpu", "gloo"))
    assert one.mesh_size == 1 and one.effective_pose_chunk(data, 3) == 3
    a, b = plain.dock_batch([data, data], num_poses=3, seed=2), one.dock_batch([data, data], num_poses=3, seed=2)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.poses, y.poses)
    # a pose mesh of 4 rounds the program's pose count up and scales the cap
    four = DockingPipeline(cfg, 0, SamplerConfig(inference_steps=2, actual_steps=2), so3, torus,
                           device="cpu", mesh=mesh_mod.Mesh(4, 0, "cpu", "gloo"))
    assert four.effective_pose_chunk(data, 3) == 4 and four.effective_pose_chunk(data, 10, 5) == 8


def test_the_rank_workers_import_no_jax():
    tree = ast.parse(Path(ranks.__file__).read_text())
    roots = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert not roots & {"jax", "flax", "optax", "diffdock_tpu", "tests"}, roots
