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
way. The trainer's full state (optimizer, EMA) is not ported.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple

from diffdock_tpu_torch.diffusion.schedules import SigmaConfig
from diffdock_tpu_torch.models.config import ScoreModelConfig
from diffdock_tpu_torch.utils import flax_msgpack, simple_yaml

CONFIG_FILE = "model_parameters.yml"
WEIGHTS_FILE = "model.msgpack"


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
