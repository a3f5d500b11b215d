"""Run directories: weights plus a YAML config sidecar (port of
``diffdock_tpu/train/checkpoints.py``).

A run directory holds ``model_parameters.yml`` (``{"model": asdict(cfg),
**extra}``, keys sorted) and a weights file in the msgpack layout of
``flax.serialization.to_bytes`` (``model.msgpack``, or one of the EMA/best
flavors). Both are read and written without flax, msgpack or PyYAML
(:mod:`diffdock_tpu_torch.utils.flax_msgpack`,
:mod:`diffdock_tpu_torch.utils.simple_yaml`), so the run directories of
the JAX package's trainer load here and the port's load there. The
weights are the flax tree; :func:`diffdock_tpu_torch.utils.convert.state_dict_from_flax`
turns them into a ``state_dict`` and
:func:`diffdock_tpu_torch.utils.convert.flax_from_model` goes the other
way. The trainer's full state (:func:`save_train_state`,
:func:`load_train_state`) goes in ``train_state.msgpack`` as the JAX
trainer writes it: step, params, batch stats, the optax state tree
(``chain(clip?, adam | adamw)``, with the schedule's count under warmup)
and the EMA params, so a JAX run resumes here and the reverse.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

from diffdock_tpu_torch.diffusion.schedules import SigmaConfig
from diffdock_tpu_torch.models.config import ScoreModelConfig
from diffdock_tpu_torch.utils import flax_msgpack, simple_yaml

CONFIG_FILE = "model_parameters.yml"
WEIGHTS_FILE = "model.msgpack"
TRAIN_STATE_FILE = "train_state.msgpack"


def _cfg_to_dict(cfg: ScoreModelConfig) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def _cfg_from_dict(d: Dict[str, Any]) -> ScoreModelConfig:
    d = dict(d)
    sigma = d.pop("sigma", None)
    if isinstance(sigma, dict):
        d["sigma"] = SigmaConfig(**sigma)
    known = {f.name for f in dataclasses.fields(ScoreModelConfig)}
    # YAML round-trips tuples as lists; the config stays hashable
    return ScoreModelConfig(**{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in d.items() if k in known
    })


def save_checkpoint(
    run_dir: str,
    params,
    cfg: ScoreModelConfig,
    extra: Optional[Dict[str, Any]] = None,
    weights_name: str = WEIGHTS_FILE,
) -> None:
    """Write ``params`` (the flax tree: nested dicts of numpy arrays) and
    the config sidecar into ``run_dir``."""
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, CONFIG_FILE), "w") as f:
        f.write(simple_yaml.dump({"model": _cfg_to_dict(cfg), **(extra or {})}))
    with open(os.path.join(run_dir, weights_name), "wb") as f:
        f.write(flax_msgpack.to_bytes(params))


_WEIGHT_PREFERENCE = (
    WEIGHTS_FILE,
    "best_ema_model.msgpack",
    "best_model.msgpack",
    "last_ema_model.msgpack",
    "last_model.msgpack",
)


def resolve_weights_name(run_dir: str, name: str) -> str:
    """Map a reference checkpoint filename (``--ckpt`` values like
    ``best_ema_inference_epoch_model.pt``, reference inference.py:74-76) to
    the equivalent converted ``.msgpack`` flavor when the literal file is
    absent from ``run_dir``. Literal existing files always win."""
    if os.path.exists(os.path.join(run_dir, name)):
        return name
    if name.endswith(".pt"):
        stem = name[:-3]
        if "ema" in stem:
            flavor = "last_ema_model" if "last" in stem else "best_ema_model"
        elif "last" in stem:
            flavor = "last_model"
        else:
            flavor = "best_model"
        mapped = flavor + ".msgpack"
        if os.path.exists(os.path.join(run_dir, mapped)):
            return mapped
    return name  # let load_checkpoint raise with the tried candidates


def load_checkpoint(
    run_dir: str, weights_name: Optional[str] = None
) -> Tuple[Any, ScoreModelConfig, Dict[str, Any]]:
    """Returns (params, config, extra); ``params`` is the flax tree of
    nested dicts of numpy arrays. When ``weights_name`` is omitted the best
    available flavor is picked (``model.msgpack`` first, then EMA)."""
    with open(os.path.join(run_dir, CONFIG_FILE)) as f:
        meta = simple_yaml.load(f.read())
    if not isinstance(meta, dict) or "model" not in meta:
        raise ValueError(f"{os.path.join(run_dir, CONFIG_FILE)} has no 'model' section: "
                         "not a run directory of this package")
    cfg = _cfg_from_dict(meta.pop("model"))
    candidates = (
        (resolve_weights_name(run_dir, weights_name),)
        if weights_name else _WEIGHT_PREFERENCE
    )
    for name in candidates:
        path = os.path.join(run_dir, name)
        if os.path.exists(path):
            with open(path, "rb") as f:
                params = flax_msgpack.msgpack_restore(f.read())
            return params, cfg, meta
    raise FileNotFoundError(f"no weights found in {run_dir} (tried {candidates})")


def _optax_tree(adam: Dict[str, Any], count, train_cfg) -> Dict[str, Any]:
    """The state tree of the JAX trainer's ``make_optimizer(train_cfg)`` as
    flax serializes it: tuples as ``{"0": ..., "1": ...}``, named tuples as
    dicts of their fields, empty states as ``{}``."""
    inner = [adam]
    if train_cfg.w_decay > 0:
        inner.append({})  # add_decayed_weights
    inner.append({"count": count} if train_cfg.warmup_steps > 0 else {})  # the learning rate
    chain = ([{}] if train_cfg.grad_clip else []) + [{str(i): s for i, s in enumerate(inner)}]
    return {str(i): s for i, s in enumerate(chain)}


def _find_adam(tree) -> Dict[str, Any]:
    if isinstance(tree, dict):
        if {"count", "mu", "nu"} <= set(tree):
            return tree
        for v in tree.values():
            found = _find_adam(v)
            if found is not None:
                return found
    return None


def save_train_state(run_dir: str, model, state, cfg: ScoreModelConfig, train_cfg,
                     extra: Optional[Dict[str, Any]] = None) -> None:
    """Persist the full training state of ``model`` (params, EMA, Adam
    moments, batch stats, step, ``lr_scale``) for a restart, in the JAX
    trainer's layout (reference last_model.pt with optimizer,
    ``train.py:141-146``). ``state``: a
    :class:`diffdock_tpu_torch.train.trainer.TrainState` of ``model``;
    ``train_cfg`` its :class:`~diffdock_tpu_torch.train.trainer.TrainConfig`."""
    from diffdock_tpu_torch.utils.convert import flax_from_model

    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, CONFIG_FILE), "w") as f:
        f.write(simple_yaml.dump({"model": _cfg_to_dict(cfg), **(extra or {})}))
    own = flax_from_model(model)
    params_tree = lambda named: flax_from_model(model, params=named)["params"]  # noqa: E731
    count = np.asarray(state.opt_state.count.item(), np.int32)
    adam = {"count": count, "mu": params_tree(state.opt_state.mu),
            "nu": params_tree(state.opt_state.nu)}
    payload = {
        "step": np.asarray(state.step, np.int32),
        "params": own["params"],
        "batch_stats": own.get("batch_stats", {}),
        "opt_state": _optax_tree(adam, count, train_cfg),
        "ema_params": params_tree(state.ema_params),
        "lr_scale": np.asarray(state.lr_scale, np.float32),
    }
    with open(os.path.join(run_dir, TRAIN_STATE_FILE), "wb") as f:
        f.write(flax_msgpack.to_bytes(payload))


def load_train_state(run_dir: str, model, state):
    """Restore a training state written by :func:`save_train_state` (of
    this package or of the JAX package) into ``model`` and ``state`` (its
    :class:`~diffdock_tpu_torch.train.trainer.TrainState`), in place;
    returns ``state``. Raises when the file or a leaf is missing."""
    import torch

    from diffdock_tpu_torch.utils.convert import state_dict_from_flax

    with open(os.path.join(run_dir, TRAIN_STATE_FILE), "rb") as f:
        payload = flax_msgpack.msgpack_restore(f.read())
    adam = _find_adam(payload["opt_state"])
    if adam is None:
        raise ValueError(f"{run_dir}: the optimizer state holds no Adam moments")
    cfg = model.cfg
    named = lambda tree: state_dict_from_flax({"params": tree}, cfg)  # noqa: E731
    model.load_state_dict(
        state_dict_from_flax({"params": payload["params"],
                              "batch_stats": payload.get("batch_stats", {})}, cfg),
        strict=True)
    with torch.no_grad():
        for target, tree in ((state.opt_state.mu, adam["mu"]), (state.opt_state.nu, adam["nu"]),
                             (state.ema_params, payload["ema_params"])):
            values = named(tree)
            if set(values) != set(target):
                raise ValueError(f"{run_dir}: the saved tree does not match the model's parameters")
            for k, v in values.items():
                target[k].copy_(v)
        state.opt_state.count.fill_(int(np.asarray(adam["count"])))
    state.step = int(np.asarray(payload["step"]))
    state.lr_scale = float(np.asarray(payload["lr_scale"]))
    return state
