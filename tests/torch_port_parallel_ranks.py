"""Rank workers of the multi-rank CPU tests (``tests/test_torch_port_parallel*.py``).

The ranks are processes that ``parallel/mesh.py:launch`` spawns; they
import this module by name, so it imports neither JAX nor a test module
that does. :func:`run` joins the gloo group, runs a list of jobs (each a
function of this module with numpy or torch inputs from the test) and
pickles each job's result to ``out_dir/<job>.r<rank>.pkl``;
:func:`results` reads them back in rank order.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch

from diffdock_tpu_torch.parallel import mesh as mesh_mod

# the small diffusion tables of the CPU parity tests
SO3_SMALL = dict(n_eps=64, x_n=256, l_max=512)
TORUS_SMALL = dict(x_n=256, sigma_n=128, mc_samples=2000)


def run(out_dir: str, jobs) -> int:
    """Every ``(name, function, kwargs)`` of ``jobs`` on this rank, in order."""
    mesh = mesh_mod.make_mesh()
    for name, fn, kw in jobs:
        out = globals()[fn](mesh, **kw)
        with open(Path(out_dir) / f"{name}.r{mesh.rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    return 0


def results(out_dir, name: str, ranks: int = 2) -> list:
    out = []
    for r in range(ranks):
        with open(Path(out_dir) / f"{name}.r{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def tables():
    from diffdock_tpu_torch.diffusion.so3 import SO3Config, get_so3_tables
    from diffdock_tpu_torch.diffusion.torus import TorusConfig, get_torus_tables

    return (get_so3_tables(SO3Config(**SO3_SMALL), "cpu"),
            get_torus_tables(TorusConfig(**TORUS_SMALL), "cpu"))


def _t(a):
    return torch.from_numpy(np.array(a))


# ----------------------------------------------------------------------
# jobs: each takes the mesh (None: one process, the reference) first

def batch_norms(mesh, x, mask, irreps, x_scalar, upstream, upstream_scalar):
    """IrrepsBatchNorm on ``x`` (B, R, D) with ``mask`` (B, R) and
    ScalarBatchNorm on ``x_scalar`` (B, C) in training mode, each rank on
    its shard of the leading axis: outputs, the gradients of
    sum(upstream * y) with respect to the input and the weights, the
    running statistics."""
    from diffdock_tpu_torch.models.score_model import ScalarBatchNorm
    from diffdock_tpu_torch.ops.batch_norm import IrrepsBatchNorm

    out = {}
    for key, bn, xin, m, up in (("irreps", IrrepsBatchNorm(irreps), x, mask, upstream),
                                ("scalar", ScalarBatchNorm(x_scalar.shape[-1]), x_scalar, None,
                                 upstream_scalar)):
        sl = mesh.shard(xin.shape[0]) if mesh is not None else slice(None)
        bn.train(True)
        bn.mesh = mesh
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, bn.weight.shape[0]))
        xt = _t(xin[sl]).requires_grad_(True)
        y = bn(xt, _t(m[sl])) if m is not None else bn(xt)
        (y * _t(up[sl])).sum().backward()
        out[key] = dict(y=y.detach().numpy(), grad_x=xt.grad.numpy(), grad_w=bn.weight.grad.numpy(),
                        grad_b=bn.bias.grad.numpy(), mean=bn.running_mean.numpy(),
                        var=bn.running_var.numpy())
    return out


def pose_sampler(mesh, n_poses: int, seed: int):
    """``shard_pose_sampler`` of a sampler that adds seeded normal noise to
    its poses, called twice with the same seed."""
    def sample_fn(s, data, init):
        gen = torch.Generator().manual_seed(s)
        return init + data["scale"] * torch.randn(init.shape, generator=gen)

    fn = mesh_mod.shard_pose_sampler(sample_fn, mesh)
    init = torch.zeros(n_poses, 5, 3)
    return [fn(seed, {"scale": 1.0}, init).numpy() for _ in range(2)]


def build_kernels(mesh, build_dir: str):
    """``prepare_kernels`` into ``build_dir``; then whether each library is
    there for this rank to load."""
    from diffdock_tpu_torch.utils import build

    build.BUILD_DIR = Path(build_dir)
    mesh_mod.prepare_kernels(mesh)
    return {name: build.library_path(name, srcs).exists()
            for name, srcs in mesh_mod.kernel_libraries().items()}


def run_failure(mesh):
    """``Mesh.run`` with a call that fails on rank 1: the message that
    every rank's ``RankFailure`` carries."""
    try:
        mesh.run(lambda: 1 // (1 - mesh.rank))
    except mesh_mod.RankFailure as exc:
        return str(exc)
    return None


def raise_on_rank(mesh, rank: int):
    if mesh.rank == rank:
        raise RuntimeError(f"rank {rank} fails")


def _noise_table(draws):
    """A pipeline ``noise`` function that hands out the caller's draws by
    (seed, fold): numpy (InitNoise fields, StepNoise fields)."""
    from diffdock_tpu_torch.inference.sampler import InitNoise, StepNoise

    def noise(num_poses, n_bonds, seed, fold=None):
        init, steps = draws[(seed, fold)]
        got = InitNoise(*[_t(a) for a in init]), StepNoise(*[_t(a) for a in steps])
        assert got[0].rot.shape[0] == num_poses and got[0].tor.shape[1] == n_bonds
        return got

    return noise


def _pipeline(mesh, score_cfg, score_sd, sampler_kw, conf_cfg=None, conf_sd=None):
    from diffdock_tpu_torch.inference.pipeline import DockingPipeline
    from diffdock_tpu_torch.inference.sampler import SamplerConfig

    so3, torus = tables()
    return DockingPipeline(score_cfg, score_sd, SamplerConfig(**sampler_kw), so3, torus, device="cpu",
                           confidence_cfg=conf_cfg, confidence_weights=conf_sd, mesh=mesh)


def dock(mesh, score_cfg, score_sd, conf_cfg, conf_sd, sampler_kw, data, num_poses, seed, draws):
    """One pose-sharded ``dock_complex`` with a trajectory, the draws handed
    to each shard by (seed, rank); the result and this rank's launches."""
    from diffdock_tpu_torch.ops import fused_tp3 as ft

    pipe = _pipeline(mesh, score_cfg, score_sd, sampler_kw, conf_cfg, conf_sd)
    before = ft.counts["fused_tp3_reference"]
    res = pipe.dock_complex(data, num_poses=num_poses, seed=seed, noise=_noise_table(draws),
                            return_trajectory=True)
    return res, ft.counts["fused_tp3_reference"] - before


def dock_batch(mesh, score_cfg, score_sd, sampler_kw, datas, num_poses, seed, draws):
    """``dock_batch`` of several complexes, complex i's draws by
    (seed * 100003, i)."""
    pipe = _pipeline(mesh, score_cfg, score_sd, sampler_kw)
    return pipe.dock_batch(datas, num_poses=num_poses, seed=seed, noise=_noise_table(draws))


def _leaves(named):
    return {k: v.detach().numpy().copy() for k, v in named.items()}


def train_steps(mesh, cfg, state_dict, batch, draws, lr: float):
    """Score-model train steps over the global numpy ``batch``, one per
    entry of ``draws`` (NoiseDraws fields, numpy), which on a mesh holds
    one such list per rank. Returns the params, EMA, batch stats, and each
    step's metrics and gradients."""
    from diffdock_tpu_torch.data.complexes import to_device
    from diffdock_tpu_torch.models.score_model import CGScoreModel
    from diffdock_tpu_torch.train import trainer
    from diffdock_tpu_torch.train.noise import NoiseDraws

    so3, torus = tables()
    model = CGScoreModel(cfg)
    model.load_state_dict(state_dict, strict=True)
    tc = trainer.TrainConfig(lr=lr)
    state = trainer.create_train_state(model, tc)
    step = trainer.make_train_step(model, tc, so3, torus, mesh=mesh)
    if mesh is not None:
        step = mesh_mod.shard_train_step(step, mesh)
        draws = draws[mesh.rank]
    metrics, grads = [], []
    for d in draws:
        state, m = step(state, to_device(batch, "cpu"), NoiseDraws(*[_t(a) for a in d]))
        metrics.append({k: v.numpy() for k, v in m.items()})
        grads.append(_leaves(state.grads))
    return dict(params=_leaves(state.params), ema=_leaves(state.ema_params),
                stats=_leaves(state.batch_stats), grads=grads, metrics=metrics)


def confidence_steps(mesh, cfg, tcfg, state_dict, batch, poses, labels, seeds):
    """Confidence train steps over the global numpy ``batch``, ``poses`` and
    ``labels``, one per dropout seed of ``seeds`` (folded with the rank on a
    mesh); the params, batch statistics, and each step's metrics and
    gradients."""
    from diffdock_tpu_torch.data.complexes import to_device
    from diffdock_tpu_torch.models.factory import build_model
    from diffdock_tpu_torch.train.confidence import create_confidence_train_state, make_confidence_train_step

    model = build_model(cfg)
    model.load_state_dict(state_dict, strict=True)
    state = create_confidence_train_state(model, tcfg)
    step = make_confidence_train_step(model, tcfg, mesh=mesh)
    if mesh is not None:
        step = mesh_mod.shard_confidence_train_step(step, mesh)
    metrics, grads = [], []
    for seed in seeds:
        gen = torch.Generator().manual_seed(seed if mesh is None else mesh_mod.fold_seed(seed, mesh.rank))
        state, m = step(state, to_device(batch, "cpu"), _t(poses), _t(labels), gen)
        metrics.append({k: v.numpy() for k, v in m.items()})
        grads.append(_leaves(state.grads))
    stats = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return dict(params=_leaves(state.params), stats=stats, grads=grads, metrics=metrics)
