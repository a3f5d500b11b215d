"""Training step: noising + forward + score-matching loss + Adam + EMA.

Port of ``diffdock_tpu/train/trainer.py``. The JAX step ``vmap``s one
complex's forward over a stacked batch with a named axis, so that batch
norm aggregates over the whole batch; here the model takes the stacked
batch directly (:meth:`CGScoreModel.forward` with one pose per complex) and
its batch norms, in training mode, do the same aggregation.

The optimizer follows optax's ``chain(clip_by_global_norm, adam | adamw)``
with an optional linear warmup from ``lr * 1e-3`` (counted from step 0),
written as plain functions on tensor dicts: ``eps`` outside the square
root, bias correction by ``count + 1``, AdamW's decay decoupled and scaled
by the learning rate. The update is then multiplied by ``lr_scale`` and by
``param_mask`` (masked parameters still advance their Adam moments), and
the EMA is taken over the new parameters.

A :class:`TrainState` holds its model's own parameter and running-statistic
tensors (by ``state_dict`` name), so a step updates the model in place.

Under a model config's ``crop_beyond`` the train step crops each complex's
receptor as the JAX step does (``diffdock_tpu/train/trainer.py:191-205``;
the reference trains with per-sample, sigma-dependent crops,
``datasets/pdbbind.py:112-114``): the residues with a ligand atom of the
noised pose within ``3 tr_sigma(t) + crop_beyond`` are kept
(:func:`~diffdock_tpu_torch.data.complexes.rec_keep_mask`), the others
masked out of the forward through the model's ``rec_keep``. The eval step
does not crop, as JAX's ``make_eval_step`` does not.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional

import torch

from diffdock_tpu_torch.data.complexes import ComplexData, rec_keep_mask
from diffdock_tpu_torch.diffusion.schedules import t_to_sigma
from diffdock_tpu_torch.diffusion.so3 import SO3Tables
from diffdock_tpu_torch.diffusion.torus import TorusTables
from diffdock_tpu_torch.models.config import ScoreModelConfig
from diffdock_tpu_torch.models.score_model import CGScoreModel
from diffdock_tpu_torch.train.losses import per_complex_losses, sigma_interval_metrics, total_loss
from diffdock_tpu_torch.parallel.mesh import DP_AXIS, bind_batch_norms
from diffdock_tpu_torch.train.noise import NoiseDraws, apply_noise

BATCH_AXIS = "batch"
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-3
    w_decay: float = 0.0
    ema_rate: float = 0.999
    tr_weight: float = 0.33
    rot_weight: float = 0.33
    tor_weight: float = 0.33
    # the auxiliary flexible-sidechain losses (reference
    # backbone_loss_weight / sidechain_loss_weight): they need the model's
    # sidechain head (cfg.sidechain_pred) and rec_scv targets in the data.
    # (The JAX config's sampling_alpha and sampling_beta stay at the 1, 1
    # every caller uses: t is uniform, train/noise.py:draw_noise.)
    backbone_weight: float = 0.0
    sidechain_weight: float = 0.0
    grad_clip: Optional[float] = None
    warmup_steps: int = 0
    # per-sigma-interval loss breakdown (reference 10-bucket logging)
    log_sigma_intervals: bool = False


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: the step count (int32, 0-d) and the
    moments by parameter name."""

    count: torch.Tensor
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]  # the model's own parameters
    batch_stats: Dict[str, torch.Tensor]  # the model's own running statistics
    opt_state: AdamState
    ema_params: Dict[str, torch.Tensor]
    # host-controlled LR multiplier (reduce-on-plateau, layer warmup)
    lr_scale: float = 1.0
    # 0/1 per parameter (layer_linear_warmup freezing); None: all train
    param_mask: Optional[Dict[str, float]] = None
    # the last step's gradients by parameter name
    grads: Optional[Dict[str, torch.Tensor]] = None


class Optimizer(NamedTuple):
    """``init(params) -> AdamState``; ``update(grads, state, params) ->
    (updates, AdamState)``, the updates to add to the parameters."""

    init: Callable
    update: Callable


def _schedule(cfg: TrainConfig, count: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``count`` (the step count before this update),
    float32 as optax's ``linear_schedule`` computes it."""
    if cfg.warmup_steps <= 0:
        return torch.tensor(cfg.lr, dtype=torch.float32, device=count.device)
    init, end = cfg.lr * 1e-3, cfg.lr
    c = torch.clamp(count, 0, cfg.warmup_steps).to(torch.float32)
    frac = 1 - c / cfg.warmup_steps
    return torch.tensor(init - end, dtype=torch.float32, device=count.device) * frac + end


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    def init(params: Dict[str, torch.Tensor]) -> AdamState:
        dev = next(iter(params.values())).device
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            mu={k: torch.zeros_like(p) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()},
        )

    def update(grads: Dict[str, torch.Tensor], state: AdamState, params: Dict[str, torch.Tensor]):
        names = list(params)
        g = [grads[k] for k in names]
        if cfg.grad_clip:
            g_norm = torch.sqrt(sum(torch.sum(x * x) for x in g))
            trigger = g_norm < cfg.grad_clip
            g = [torch.where(trigger, x, (x / g_norm) * cfg.grad_clip) for x in g]
        mu = [(1 - ADAM_B1) * x + ADAM_B1 * state.mu[k] for k, x in zip(names, g)]
        nu = [(1 - ADAM_B2) * (x * x) + ADAM_B2 * state.nu[k] for k, x in zip(names, g)]
        count_inc = state.count + 1
        c = count_inc.to(torch.float32)
        corr1 = 1 - torch.tensor(ADAM_B1, dtype=torch.float32, device=c.device) ** c
        corr2 = 1 - torch.tensor(ADAM_B2, dtype=torch.float32, device=c.device) ** c
        updates = [(m / corr1) / (torch.sqrt(v / corr2) + ADAM_EPS) for m, v in zip(mu, nu)]
        if cfg.w_decay > 0:
            updates = [u + cfg.w_decay * params[k] for k, u in zip(names, updates)]
        step_size = -_schedule(cfg, state.count)
        updates = [step_size * u for u in updates]
        new_state = AdamState(count=count_inc, mu=dict(zip(names, mu)), nu=dict(zip(names, nu)))
        return dict(zip(names, updates)), new_state

    return Optimizer(init, update)


def training_model_config(cfg: ScoreModelConfig, data_parallel: bool = False) -> ScoreModelConfig:
    """The config a run directory records: batch statistics over the batch
    axis and, under ``data_parallel``, over the mesh's ``"dp"`` axis too,
    as the JAX CLI writes it."""
    axes = (BATCH_AXIS, DP_AXIS) if data_parallel else (BATCH_AXIS,)
    return dataclasses.replace(cfg, bn_axis_names=axes)


def batch_stat_names(model: torch.nn.Module):
    return [k for k in model.state_dict() if k.endswith(("running_mean", "running_var"))]


def create_train_state(model: CGScoreModel, train_cfg: TrainConfig) -> TrainState:
    """A fresh state bound to ``model``'s current weights."""
    params = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    return TrainState(
        step=0,
        params=params,
        batch_stats={k: buffers[k] for k in batch_stat_names(model)},
        opt_state=make_optimizer(train_cfg).init(params),
        ema_params={k: p.detach().clone() for k, p in params.items()},
    )


def train_rec_keep(cfg: ScoreModelConfig, batch: ComplexData, sample) -> torch.Tensor:
    """(B, NR) bool: per complex of the stacked ``batch``, the residues
    within ``3 tr_sigma(t) + crop_beyond`` of a ligand atom of its noised
    pose ``sample.pos`` (the JAX train step's crop, in float32)."""
    tr_sigma, _, _ = t_to_sigma(sample.t, sample.t, sample.t, cfg.sigma)
    cutoff = 3.0 * tr_sigma + cfg.crop_beyond
    return torch.stack([
        rec_keep_mask(batch.rec_pos[b], batch.rec_mask[b], sample.pos[b][None], batch.lig_mask[b],
                      cutoff[b])
        for b in range(batch.rec_pos.shape[0])
    ])


def _forward_losses(model, batch: ComplexData, draws: NoiseDraws, train_cfg: TrainConfig,
                    so3: SO3Tables, torus: TorusTables, train: bool = False):
    """Loss and metrics of a stacked batch. ``train``: the train step's
    receptor crop and auxiliary sidechain losses, which the JAX eval step
    leaves out."""
    cfg = model.cfg
    with torch.no_grad():
        sample = apply_noise(batch, draws, cfg.sigma, so3, torus, no_torsion=cfg.no_torsion)
        rec_keep = train_rec_keep(cfg, batch, sample) if train and cfg.crop_beyond is not None else None
    out = model(batch, sample.pos, sample.t, so3, torus, rec_keep=rec_keep)
    aux = dict(rec_scv=batch.rec_scv, rec_mask=batch.rec_mask) if train else {}
    parts = per_complex_losses(out, sample, batch.rot_mask, cfg.sigma, so3, torus, **aux)
    weights = dict(backbone_weight=train_cfg.backbone_weight,
                   sidechain_weight=train_cfg.sidechain_weight) if train else {}
    loss, metrics = total_loss(parts, train_cfg.tr_weight, train_cfg.rot_weight,
                               train_cfg.tor_weight, **weights)
    if train_cfg.log_sigma_intervals:
        metrics.update(sigma_interval_metrics(parts))
    return loss, metrics


def make_eval_step(model: CGScoreModel, train_cfg: TrainConfig, so3: SO3Tables,
                   torus: TorusTables) -> Callable:
    """Validation loss over a stacked batch: the same noising and loss as
    training, in evaluation mode (running statistics, no dropout, no
    gradients), with the state's raw parameters — the reference's
    ``test_epoch``; no receptor crop, as in the JAX eval step.
    ``eval_step(state, batch, draws) -> metrics``."""

    def eval_step(state: TrainState, batch: ComplexData, draws: NoiseDraws):
        model.eval()
        with torch.no_grad():
            return _forward_losses(model, batch, draws, train_cfg, so3, torus)[1]

    return eval_step


def make_train_step(model: CGScoreModel, train_cfg: TrainConfig, so3: SO3Tables,
                    torus: TorusTables, mesh=None) -> Callable:
    """``train_step(state, batch, draws) -> (state, metrics)`` over a
    stacked batch (one bucket): the forward in training mode, gradients of
    the loss (with the auxiliary sidechain losses of a nonzero backbone or
    sidechain weight), the optimizer update, ``lr_scale`` and ``param_mask``, the EMA;
    under the model config's ``crop_beyond``, each complex's receptor crop
    (:func:`train_rec_keep`). The model's parameters and running statistics
    (``state.params``, ``state.batch_stats``) move in place; ``state.grads``
    keeps the step's gradients by parameter name.

    ``mesh`` (a ``parallel/mesh.py:Mesh``): this rank's step of a
    data-parallel run (wrap it in ``shard_train_step``). The batch is this
    rank's shard and ``draws`` its own; the batch norms aggregate over the
    mesh when the config says so (``training_model_config(cfg,
    data_parallel=True)``), and the gradients and metrics are averaged over
    the ranks before clipping, Adam and the EMA, so the parameters stay the
    same on every rank (the JAX step's ``pmean``)."""
    tx = make_optimizer(train_cfg)
    if mesh is not None:
        bind_batch_norms(model, mesh)

    def train_step(state: TrainState, batch: ComplexData, draws: NoiseDraws):
        model.train()
        names = list(state.params)
        loss, metrics = _forward_losses(model, batch, draws, train_cfg, so3, torus, train=True)
        grads = torch.autograd.grad(loss, [state.params[k] for k in names], allow_unused=True)
        grads = {k: torch.zeros_like(state.params[k]) if g is None else g
                 for k, g in zip(names, grads)}
        if mesh is not None:
            grads = mesh.mean_tree(grads)
            metrics = mesh.mean_tree(metrics)
        with torch.no_grad():
            params = {k: p.detach() for k, p in state.params.items()}
            updates, state.opt_state = tx.update(grads, state.opt_state, params)
            rate = train_cfg.ema_rate
            for k in names:
                u = updates[k] * state.lr_scale
                if state.param_mask is not None:
                    u = u * state.param_mask[k]
                params[k].add_(u)
                state.ema_params[k].mul_(rate).add_((1.0 - rate) * params[k])
        state.step += 1
        state.grads = grads
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step
