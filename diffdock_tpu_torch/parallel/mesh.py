"""Device meshes over ``torch.distributed``: data-parallel training and
sharded docking (port of ``diffdock_tpu/parallel/mesh.py``).

The JAX package drives N devices from one process through ``shard_map``
over a 1-axis mesh named ``"dp"``. The port runs one process per rank of a
``torch.distributed`` process group instead:

* every rank holds its own copy of the parameters, tables and complexes,
  runs the same host code with the same seeds, builds the same global
  batch and takes its own shard of it (``shard_map``'s ``P(axis)`` in-spec);
* a collective that needs a gradient is :meth:`Mesh.all_reduce_sum`, whose
  backward is an all-reduce too (the transpose of ``psum``), so a batch
  norm that sums its statistics over the group gives the gradient of the
  global batch;
* results that the JAX program gathers with ``P(axis)`` out-specs come back
  concatenated in rank order on every rank (:meth:`Mesh.gather`);
* rank ``r`` uses card ``r mod torch.cuda.device_count()``, or the CPU when
  the caller asks for it. NCCL serves when every rank has a card of its
  own, gloo when the ranks are CPU processes or share a card.

A CLI joins the group that ``torchrun`` (``python -m torch.distributed.run``)
describes in its environment, or starts its own ranks with
:func:`launch` (``torch.multiprocessing``, ``spawn``): one per card up to
the requested count (0: every visible card), or that many CPU ranks with
``--device cpu``. On the CPU the visible device count is
``DIFFDOCK_TPU_CPU_DEVICES`` (default 1), the counterpart of the JAX
tests' ``--xla_force_host_platform_device_count``. On the card rank 0
builds the kernels before the other ranks load them
(:func:`prepare_kernels`).
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DP_AXIS = "dp"  # the JAX trainer's mesh axis (diffdock_tpu/train/trainer.py:31)
CPU_DEVICES_ENV = "DIFFDOCK_TPU_CPU_DEVICES"
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


class RankFailure(RuntimeError):
    """A rank of a multi-rank run failed; every rank raises it together."""


class Mesh:
    """A 1-axis mesh: this process's place in its process group (the
    default group, all of its ranks).

    ``size`` ranks, this one ``rank`` on ``device``; ``backend`` is the
    group's (``"nccl"`` or ``"gloo"``). Every collective here is called by
    every rank of the group in the same order."""

    def __init__(self, size: int, rank: int, device: torch.device, backend: str,
                 axis_name: str = DP_AXIS):
        self.size = size
        self.rank = rank
        self.device = torch.device(device)
        self.backend = backend
        self.axis_name = axis_name
        # host seconds spent in this mesh's all-reduces (forward, backward
        # and tree means), for a caller that times its steps
        self.collective_s = 0.0

    def __repr__(self) -> str:
        return (f"Mesh({self.axis_name!r}: rank {self.rank} of {self.size} on {self.device}, "
                f"{self.backend})")

    @property
    def is_main(self) -> bool:
        """Rank 0, the one rank that writes files."""
        return self.rank == 0

    def shard(self, n: int) -> slice:
        """This rank's rows of a leading axis of ``n`` (a multiple of the
        mesh size): ``shard_map``'s ``P(axis)``."""
        if n % self.size:
            raise ValueError(f"a leading axis of {n} does not split over {self.size} ranks")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks, with a gradient (``psum``)."""
        return _AllReduceSum.apply(x, self)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the ranks, with a gradient (``pmean``)."""
        return _AllReduceSum.apply(x, self) / self.size

    def _all_reduce_(self, x: torch.Tensor) -> None:
        t0 = time.perf_counter()
        dist.all_reduce(x)
        self.collective_s += time.perf_counter() - t0

    def mean_tree(self, tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each tensor of ``tree`` averaged over the ranks, in one
        all-reduce of their concatenation (no gradient): the ``pmean`` of
        the JAX steps' gradients and metrics."""
        names = list(tree)
        flat = torch.cat([tree[k].detach().reshape(-1) for k in names])
        self._all_reduce_(flat)
        flat /= self.size
        parts = flat.split([tree[k].numel() for k in names])
        return {k: p.view(tree[k].shape) for k, p in zip(names, parts)}

    def gather(self, obj: Any) -> List[Any]:
        """Every rank's ``obj`` (picklable, host-sized), in rank order."""
        out: List[Any] = [None] * self.size
        dist.all_gather_object(out, obj)
        return out

    def broadcast(self, obj: Any) -> Any:
        """Rank 0's ``obj`` (picklable) on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def run(self, fn: Callable[[], Any]) -> List[Any]:
        """Every rank's ``fn()``, gathered in rank order. A rank whose call
        raises makes every rank raise :class:`RankFailure`, naming it, so
        no rank waits on a collective that the failed one never reaches."""
        try:
            mine = (True, fn())
        except Exception as exc:  # noqa: BLE001 — reported on every rank below
            mine = (False, f"{type(exc).__name__}: {exc}")
        outs = self.gather(mine)
        failed = [f"rank {r}: {msg}" for r, (ok, msg) in enumerate(outs) if not ok]
        if failed:
            raise RankFailure("; ".join(failed))
        return [value for _, value in outs]

    def barrier(self) -> None:
        dist.barrier()


class _AllReduceSum(torch.autograd.Function):
    """All-reduce (sum) forward and backward: ``psum`` and its transpose
    under ``shard_map(check_vma=False)``."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        out = x.detach().clone(memory_format=torch.contiguous_format)
        mesh._all_reduce_(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        ctx.mesh._all_reduce_(g)
        return g, None


def fold_seed(seed: int, i: int) -> int:
    """A seed for stream ``i`` of ``seed``, the counterpart of
    ``jax.random.fold_in(key, i)`` for the port's integer seeds."""
    state = np.random.SeedSequence([int(seed) % 2**63, int(i)]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


# ----------------------------------------------------------------------
# placement, launch and join

def cuda_requested(device) -> bool:
    return torch.device(device).type == "cuda"


def visible_devices(device) -> int:
    """Cards visible to this process, or the CPU's devices
    (``DIFFDOCK_TPU_CPU_DEVICES``, default 1)."""
    if cuda_requested(device):
        return torch.cuda.device_count()
    return int(os.environ.get(CPU_DEVICES_ENV, "1"))


def under_torchrun() -> bool:
    return all(k in os.environ for k in _TORCHRUN_ENV)


def in_rank() -> bool:
    """True in a process that belongs to a process group."""
    return dist.is_available() and dist.is_initialized()


def ranks_for(requested: int, device, allow_one: bool = False) -> int:
    """The ranks a run asks for with a count flag: the flag's count, 0
    meaning every visible device, at most one rank per card (JAX's
    ``jax.devices()[:n]``). Inside a group (or under ``torchrun``) the
    group's size, which the flag must match (0 always does); a flag of 1
    there is refused unless ``allow_one`` (a phase that runs on one rank
    of a larger group), since every rank would then do the whole run."""
    if in_rank() or under_torchrun():
        world = dist.get_world_size() if in_rank() else int(os.environ["WORLD_SIZE"])
        if requested == 1 and (allow_one or world == 1):
            return 1
        if requested not in (0, world):
            from diffdock_tpu_torch.models.config import ConfigError

            raise ConfigError(f"a count of {requested} in a process group of {world} ranks")
        return world
    visible = visible_devices(device)
    n = requested or visible
    return min(n, visible) if cuda_requested(device) else n


def rank_device(rank: int, device) -> torch.device:
    """Card ``rank mod device_count`` for a CUDA run, else the CPU."""
    if cuda_requested(device):
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("a CUDA run was asked for, but no card is visible")
        return torch.device("cuda", rank % n)
    return torch.device("cpu")


def backend_for(world: int, device) -> str:
    """NCCL when every rank has a card of its own, gloo otherwise."""
    if cuda_requested(device) and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def kernel_libraries() -> dict:
    """The port's CUDA libraries by name: their sources under ``csrc/``."""
    from diffdock_tpu_torch.ops import factored_tp1, factored_tp2, fused_tp3

    return {"fused_tp3": fused_tp3._SOURCES, "factored_tp2": factored_tp2._SOURCES,
            "factored_tp1": factored_tp1._SOURCES}


@contextlib.contextmanager
def main_first(mesh: Optional[Mesh]):
    """Run the block on rank 0 first and on the other ranks after it, so
    that they find what it wrote (a dataset cache, a built library). A
    no-op without a mesh."""
    if mesh is None:
        yield
        return
    if not mesh.is_main:
        mesh.barrier()
    try:
        yield
    finally:
        if mesh.is_main:
            mesh.barrier()


def prepare_kernels(mesh: Mesh) -> None:
    """Rank 0 builds every kernel library (``utils/build.py:build_all``)
    while the others wait at a barrier; then each loads what was built,
    so N ranks do not run N copies of ``nvcc``."""
    from diffdock_tpu_torch.utils import build

    with main_first(mesh):
        if mesh.is_main:
            build.build_all(kernel_libraries())


def _init_group(rank: int, world: int, device, init_method: str) -> Mesh:
    dev = rank_device(rank, device)
    backend = backend_for(world, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        # CPU ranks share the host's cores with each other
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    mesh = Mesh(world, rank, dev, backend)
    if rank == 0:
        print(f"mesh: {world} ranks over {backend}, rank r on "
              f"{'cuda:r mod ' + str(torch.cuda.device_count()) if dev.type == 'cuda' else 'the CPU'}",
              flush=True)
    if dev.type == "cuda":
        prepare_kernels(mesh)
    return mesh


def make_mesh(n_devices: Optional[int] = None, device=None, axis_name: str = DP_AXIS) -> Mesh:
    """The mesh of this process's group (which must be initialized, by
    :func:`launch` or ``torchrun``): all of its ranks. ``n_devices`` (None
    or 0: the group's size) must match the group, as the launchers size
    it; ``device`` defaults to the rank's card, or the CPU for a gloo group
    whose ranks hold no card."""
    if not in_rank():
        raise RuntimeError("make_mesh needs a process group: start the ranks with "
                           "diffdock_tpu_torch.parallel.mesh.launch or torchrun")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices in a group of {world} ranks")
    backend = dist.get_backend()
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() and backend == "nccl" else torch.device("cpu"))
    elif cuda_requested(device) and torch.device(device).index is None:
        device = rank_device(rank, device)
    return Mesh(world, rank, device, backend, axis_name)


def _rank_main(rank: int, fn: Callable, args: Sequence, world: int, device, init_file: str) -> None:
    _init_group(rank, world, device, f"file://{init_file}")
    try:
        rc = fn(*args)
    finally:
        dist.destroy_process_group()
    if rc:
        sys.exit(int(rc))


def launch(fn: Callable, args: Sequence, world: int, device) -> Any:
    """Run ``fn(*args)`` on ``world`` ranks; ``fn`` returns an exit code
    (0 or None for success) and may call :func:`make_mesh`.

    Inside a group this process is already a rank: ``fn``'s code comes
    back. Under ``torchrun`` this process is one rank: it joins the group
    the environment describes, runs ``fn``, leaves, and returns its code.
    Otherwise it starts ``world`` ranks with ``torch.multiprocessing``
    (``spawn``; ``fn`` and ``args`` must pickle), rendezvous through a
    ``file://`` store in a fresh temporary directory, waits for all of
    them, and returns 0; a rank that raises or returns another code makes
    it raise :class:`RankFailure`."""
    if in_rank():
        return fn(*args)
    if under_torchrun():
        rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        _init_group(rank, size, device, "env://")
        try:
            return fn(*args)
        finally:
            dist.destroy_process_group()
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="diffdock_mesh_") as tmp:
        try:
            mp.start_processes(_rank_main, args=(fn, tuple(args), world, str(device),
                                                 os.path.join(tmp, "store")),
                               nprocs=world, join=True, start_method="spawn")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as exc:
            raise RankFailure(f"rank {exc.error_index} of {world} failed: {exc}") from exc
    return 0


def bind_batch_norms(model: torch.nn.Module, mesh: Optional[Mesh]) -> None:
    """Point every batch norm of ``model`` at ``mesh`` when the model's
    config aggregates its statistics over the mesh's axis
    (``bn_axis_names``, as ``train/trainer.py:training_model_config(cfg,
    data_parallel=True)`` writes it); otherwise, as the JAX module does
    without the axis, each rank normalizes over its own shard."""
    from diffdock_tpu_torch.models.score_model import ScalarBatchNorm
    from diffdock_tpu_torch.ops.batch_norm import IrrepsBatchNorm

    if mesh is not None and mesh.axis_name not in model.cfg.bn_axis_names:
        mesh = None
    for m in model.modules():
        if isinstance(m, (IrrepsBatchNorm, ScalarBatchNorm)):
            m.mesh = mesh


# ----------------------------------------------------------------------
# the JAX module's three wrappers

def shard_train_step(train_step: Callable, mesh: Mesh, axis_name: str = DP_AXIS) -> Callable:
    """``step(state, batch, draws) -> (state, metrics)`` over the GLOBAL
    stacked ``batch`` (leading axis a multiple of the mesh size): this rank
    takes its shard and runs ``train_step`` (built by
    ``train/trainer.py:make_train_step(..., mesh=mesh)``, which averages the
    gradients and metrics over the ranks), so the state stays identical on
    every rank. ``draws`` are this rank's own, for its shard: drawn from a
    generator seeded by the rank (the JAX step folds the mesh index into
    its key)."""
    _check_axis(mesh, axis_name)
    from diffdock_tpu_torch.data.loaders import take_rows

    def step(state, batch, draws):
        return train_step(state, take_rows(batch, mesh.shard(_leading(batch))), draws)

    return step


def shard_confidence_train_step(train_step: Callable, mesh: Mesh, axis_name: str = DP_AXIS) -> Callable:
    """``step(state, batch, poses, labels, generator) -> (state, metrics)``
    for the confidence step (``train/confidence.py:make_confidence_train_step
    (..., mesh=mesh)``): the batch tree, poses and labels are GLOBAL and
    sharded on their leading axis; ``generator`` (the dropout masks') is
    this rank's own."""
    _check_axis(mesh, axis_name)
    from diffdock_tpu_torch.data.loaders import take_rows

    def step(state, batch, poses, labels, generator=None):
        sl = mesh.shard(poses.shape[0])
        return train_step(state, take_rows(batch, sl), poses[sl], labels[sl], generator)

    return step


def shard_pose_sampler(sample_fn: Callable, mesh: Mesh, axis_name: str = DP_AXIS) -> Callable:
    """``fn(seed, data, init_poses) -> poses``: the pose axis of
    ``init_poses`` is sharded, ``data`` replicated, each rank calls
    ``sample_fn(fold_seed(seed, rank), data, its poses)`` so that shards
    draw independent noise, and the outputs come back concatenated in rank
    order on every rank."""
    _check_axis(mesh, axis_name)

    def fn(seed: int, data, init_poses: torch.Tensor) -> torch.Tensor:
        local = sample_fn(fold_seed(seed, mesh.rank), data, init_poses[mesh.shard(init_poses.shape[0])])
        parts = mesh.gather(local.detach().cpu())
        return torch.cat(parts).to(local.device)

    return fn


def _check_axis(mesh: Mesh, axis_name: str) -> None:
    if axis_name != mesh.axis_name:
        raise ValueError(f"the mesh's axis is {mesh.axis_name!r}, not {axis_name!r}")


def _leading(batch) -> int:
    base = getattr(batch, "base", batch)
    return base.lig_cat.shape[0]
