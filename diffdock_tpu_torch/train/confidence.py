"""Confidence-model training: the pose-generation sweep and the BCE / CE /
MSE step (port of ``diffdock_tpu/train/confidence.py``).

Reference flow (``confidence/dataset.py:212-273`` +
``confidence/confidence_train.py:111-320``): run the trained score model
over the training split to generate ``samples_per_complex`` poses each,
label them with their RMSD to the crystal pose, then train the confidence
network to classify RMSD < cutoff (several cutoffs: the RMSD bin; or
regress the RMSD).

The pose caches are the JAX package's files (``{name}[.id{N}].npz`` with
``poses`` and ``rmsds``), so either package trains on the other's
generation runs. The step is one training-mode forward over a stacked
batch of B complexes with one pose each at t = 0: the batch norms take
their statistics over the batch (the JAX step's ``vmap`` with the named
axis ``batch``), the dropouts draw from the generator the caller passes,
and Adam (optax's ``adam(lr)``, ``train/trainer.py:make_optimizer``)
updates the model's parameters in place.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from diffdock_tpu_torch.data.complexes import ComplexData
from diffdock_tpu_torch.eval.rmsd import molecular_automorphisms, symmetry_rmsd
from diffdock_tpu_torch.parallel.mesh import bind_batch_norms
from diffdock_tpu_torch.train.trainer import AdamState, TrainConfig, batch_stat_names, make_optimizer


@dataclasses.dataclass(frozen=True)
class ConfidenceTrainConfig:
    # one cutoff -> BCE; several -> multi-class CE over RMSD bins
    # (reference confidence_train.py:119-135 list-valued cutoff)
    rmsd_classification_cutoff: Tuple[float, ...] = (2.0,)
    # regress RMSD directly instead of classifying (reference
    # --rmsd_prediction, confidence_train.py:137-142)
    rmsd_prediction: bool = False
    samples_per_complex: int = 8
    lr: float = 3e-4

    @property
    def num_outputs(self) -> int:
        if self.rmsd_prediction:
            return 1
        n = len(self.rmsd_classification_cutoff)
        return 1 if n == 1 else n + 1

    def labels_from_rmsds(self, rmsds) -> np.ndarray:
        """BCE: float(rmsd < cutoff); multi-cutoff: the bin index
        sum(rmsd > cutoffs); regression: the rmsd itself."""
        rmsds = np.asarray(rmsds, np.float32)
        if self.rmsd_prediction:
            return rmsds
        cuts = np.asarray(self.rmsd_classification_cutoff, np.float32)
        if cuts.size == 1:
            return (rmsds < cuts[0]).astype(np.float32)
        return (rmsds[..., None] > cuts).sum(axis=-1).astype(np.float32)


def generate_poses_for_complex(
    pipeline, data: ComplexData, samples: int, seed: int,
    elements=None, bonds=None, aa_data=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sample poses with the pipeline's score model and label them with
    their RMSD to the reference pose (symmetry-corrected when the topology
    is given): (poses (samples, NL, 3) at the input's padded width, in the
    input frame, padding rows zero; rmsds (samples,))."""
    result = pipeline.dock_complex(data, num_poses=samples, seed=seed, aa_data=aa_data)
    # label RMSD over REAL atoms only (the input may be padded; padding rows
    # ride along with the rigid moves and would contaminate labels)
    n = int(np.asarray(data.lig_mask).sum())
    ref = (np.asarray(data.lig_pos) + np.asarray(data.original_center))[:n]
    poses_real = result.poses[:, :n]
    if elements is not None and bonds is not None:
        perms = molecular_automorphisms(elements, bonds)
        rmsds = symmetry_rmsd(ref, poses_real, elements, bonds, perms=perms)
    else:
        rmsds = np.sqrt(np.mean(np.sum((poses_real - ref) ** 2, axis=-1), axis=-1))
    poses = np.zeros((poses_real.shape[0],) + np.asarray(data.lig_pos).shape, np.float32)
    poses[:, :n] = poses_real
    return poses, np.asarray(rmsds)


def pose_cache_file(pose_cache_dir, name: str, cache_id=None) -> Path:
    """Path of one complex's generated-pose cache file; ``cache_id``
    suffixes the file so independent generation runs don't collide."""
    suffix = f".id{cache_id}" if cache_id is not None else ""
    return Path(pose_cache_dir) / f"{name}{suffix}.npz"


def load_pose_cache(
    pose_cache_dir, name: str, cache_ids: Optional[List[int]] = None
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(poses, rmsds) of one complex, or None when no file exists.

    ``cache_ids=None`` reads the plain ``{name}.npz``. A list of ids
    concatenates ``{name}.id{i}.npz`` over every id where the complex was
    generated (the reference's ``cache_creation_id`` /
    ``cache_ids_to_combine`` accumulation, ``confidence/dataset.py:82-155``).
    """
    if cache_ids is None:
        f = pose_cache_file(pose_cache_dir, name)
        if not f.exists():
            return None
        with np.load(f) as z:
            return z["poses"], z["rmsds"]
    poses, rmsds = [], []
    for cid in cache_ids:
        f = pose_cache_file(pose_cache_dir, name, cid)
        if f.exists():
            with np.load(f) as z:
                poses.append(z["poses"])
                rmsds.append(z["rmsds"])
    if not poses:
        return None
    return np.concatenate(poses), np.concatenate(rmsds)


@dataclasses.dataclass
class ConfidenceTrainState:
    params: Dict[str, torch.Tensor]  # the model's own parameters
    batch_stats: Dict[str, torch.Tensor]  # the model's own running statistics
    opt_state: AdamState
    # the last step's gradients by parameter name
    grads: Optional[Dict[str, torch.Tensor]] = None


def create_confidence_train_state(model: torch.nn.Module, cfg: ConfidenceTrainConfig
                                  ) -> ConfidenceTrainState:
    """A fresh state bound to ``model``'s current weights."""
    params = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    return ConfidenceTrainState(params=params, batch_stats={k: buffers[k] for k in batch_stat_names(model)},
                                opt_state=make_optimizer(TrainConfig(lr=cfg.lr)).init(params))


def confidence_loss(logits: torch.Tensor, labels: torch.Tensor, cfg: ConfidenceTrainConfig):
    """(loss, accuracy) of the head's first ``num_outputs`` columns: BCE and
    the sign's accuracy for one cutoff, softmax CE and the argmax's accuracy
    over the bins for several, MSE and the MAE (as 'accuracy') for
    ``rmsd_prediction``."""
    if cfg.rmsd_prediction:
        pred = logits[..., 0]
        return torch.mean((pred - labels) ** 2), torch.mean(torch.abs(pred - labels))
    if cfg.num_outputs == 1:
        x = logits[..., 0]
        loss = F.binary_cross_entropy_with_logits(x, labels)
        return loss, torch.mean(((x > 0) == (labels > 0.5)).to(x.dtype))
    idx = labels.to(torch.int64)
    loss = F.cross_entropy(logits, idx)
    return loss, torch.mean((torch.argmax(logits, -1) == idx).to(logits.dtype))


def make_confidence_train_step(model: torch.nn.Module, cfg: ConfidenceTrainConfig,
                               mesh=None) -> Callable:
    """``train_step(state, batch, poses, labels, generator) -> (state,
    metrics)``: ``batch`` a stacked ComplexData or AAComplexData of B
    complexes (tensors), ``poses`` (B, NL, 3) one pose each relative to its
    complex's ``original_center``, ``labels`` (B,) from
    :meth:`ConfidenceTrainConfig.labels_from_rmsds`, ``generator`` the
    dropout masks' source. The forward runs in training mode at t = 0, the
    gradients of the loss go through Adam at ``cfg.lr``, and the model's
    parameters and running statistics move in place; ``state.grads`` keeps
    the step's gradients; metrics ``loss`` and ``accuracy`` (0-d tensors).

    ``mesh`` (a ``parallel/mesh.py:Mesh``): this rank's step of a
    data-parallel run (wrap it in ``shard_confidence_train_step``), with
    its own shard and its own dropout generator (the JAX step folds the
    mesh index into its key); the batch norms aggregate over the mesh when
    the config says so, and the gradients, loss and accuracy are averaged
    over the ranks before Adam (the JAX step's ``pmean``)."""
    tx = make_optimizer(TrainConfig(lr=cfg.lr))
    n_out = cfg.num_outputs
    if mesh is not None:
        bind_batch_norms(model, mesh)

    def train_step(state: ConfidenceTrainState, batch, poses: torch.Tensor, labels: torch.Tensor,
                   generator: Optional[torch.Generator] = None):
        model.train()
        model.set_generator(generator)
        names = list(state.params)
        t = poses.new_zeros(poses.shape[0])
        logits = model(batch, poses, t)[..., :n_out]
        loss, acc = confidence_loss(logits, labels, cfg)
        grads = torch.autograd.grad(loss, [state.params[k] for k in names], allow_unused=True)
        grads = {k: torch.zeros_like(state.params[k]) if g is None else g for k, g in zip(names, grads)}
        metrics = {"loss": loss.detach(), "accuracy": acc.detach()}
        if mesh is not None:
            grads = mesh.mean_tree(grads)
            metrics = mesh.mean_tree(metrics)
        with torch.no_grad():
            params = {k: p.detach() for k, p in state.params.items()}
            updates, state.opt_state = tx.update(grads, state.opt_state, params)
            for k in names:
                params[k].add_(updates[k])
        state.grads = grads
        return state, metrics

    return train_step
