"""Flax parameter trees -> the port's ``state_dict``.

The port's module tree mirrors the flax one, so conversion is a name map:

* ``params/<path>/kernel`` of a Dense -> ``<path>.weight``, transposed;
* ``.../embedding`` of an Embed -> ``.weight``;
* ``out_kernel`` / ``out_bias`` of an FCBlock and ``bn/{weight,bias}``
  keep their names and layout;
* ``batch_stats/<path>/bn/{mean,var}`` -> ``bn.running_{mean,var}``;
* list modules: ``rec_emb_{i}`` -> ``rec_emb_layers.{i}``, ``lig_emb_{i}``
  -> ``lig_emb_layers.{i}``, ``conv_{i}`` -> ``conv_layers.{i}``;
  inside a module ``Dense_{i}`` -> ``layers.{i}`` and ``cat_{i}`` ->
  ``embeddings.{i}``.

Loading the msgpack checkpoints of the JAX package's trainer waits for a
later slice; this takes the tree as nested dicts of numpy arrays (what
``CGScoreModel.init`` returns, converted with ``np.asarray``).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from diffdock_tpu_torch.models.config import ScoreModelConfig

_LIST_MODULES = {"rec_emb": "rec_emb_layers", "lig_emb": "lig_emb_layers", "conv": "conv_layers"}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _module_path(parts: Tuple[str, ...]) -> list:
    out = []
    for p in parts:
        m = re.fullmatch(r"(rec_emb|lig_emb|conv)_(\d+)", p)
        if m and not out:
            out += [_LIST_MODULES[m.group(1)], m.group(2)]
            continue
        m = re.fullmatch(r"Dense_(\d+)", p)
        if m:
            out += ["layers", m.group(1)]
            continue
        m = re.fullmatch(r"cat_(\d+)", p)
        if m:
            out += ["embeddings", m.group(1)]
            continue
        out.append(p)
    return out


def state_dict_from_flax(variables: Mapping, cfg: ScoreModelConfig) -> Dict[str, torch.Tensor]:
    """``variables``: {'params': ..., 'batch_stats': ...} from
    ``CGScoreModel(cfg).init``; returns a ``state_dict`` for
    ``diffdock_tpu_torch.models.score_model.CGScoreModel(cfg)``."""
    if cfg.confidence_mode:
        raise ValueError("confidence models are not ported yet")
    sd: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(variables["params"]):
        *mods, leaf = path
        name = _module_path(tuple(mods))
        if leaf == "kernel":
            value = value.T  # Dense (in, out) -> Linear (out, in)
            leaf = "weight"
        elif leaf == "embedding":
            leaf = "weight"
        sd[".".join(name + [leaf])] = torch.from_numpy(np.array(value, np.float32))
    for path, value in _flatten(variables.get("batch_stats", {})):
        *mods, leaf = path
        leaf = {"mean": "running_mean", "var": "running_var"}[leaf]
        sd[".".join(_module_path(tuple(mods)) + [leaf])] = torch.from_numpy(
            np.array(value, np.float32)
        )
    return sd
