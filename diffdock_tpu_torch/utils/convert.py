"""Flax parameter trees -> the port's ``state_dict``.

The port's module tree mirrors the flax one, so conversion is a name map:

* ``params/<path>/kernel`` of a Dense -> ``<path>.weight``, transposed;
* ``.../embedding`` of an Embed -> ``.weight``;
* ``out_kernel`` / ``out_bias`` of an FCBlock and ``bn/{weight,bias}``
  keep their names and layout;
* ``batch_stats/<path>/bn/{mean,var}`` -> ``bn.running_{mean,var}``;
* a flax ``BatchNorm``'s ``scale`` -> ``weight``;
* list modules: ``rec_emb_{i}`` -> ``rec_emb_layers.{i}``, ``lig_emb_{i}``
  -> ``lig_emb_layers.{i}``, ``conv_{i}`` -> ``conv_layers.{i}``, and the
  old family's ``lig_conv_{i}``, ``rec_conv_{i}``, ``lig_to_rec_conv_{i}``,
  ``rec_to_lig_conv_{i}`` -> ``<name>_layers.{i}``; inside a module
  ``Dense_{i}`` -> ``layers.{i}``, ``BatchNorm_{i}`` -> ``norms.{i}`` and
  ``cat_{i}`` -> ``embeddings.{i}``;
* an equivariant linear's ``w_{k}`` (the sidechain head
  ``sidechain_predictor``, a depthwise conv's ``linear_2``) keeps its name
  and layout, and so do the per-edge and depthwise convs' FCs.

:func:`state_dict_from_flax` takes the tree as nested dicts of numpy
arrays (what ``CGScoreModel.init`` returns, or what
:func:`diffdock_tpu_torch.train.checkpoints.load_checkpoint` reads from a
run directory); :func:`flax_from_model` is the inverse map, from a port
model's parameters to that tree, for writing run directories the JAX
package reads. The same maps carry the training state: gradients, Adam
moments and EMA weights are dicts by parameter name here and trees shaped
like ``params`` there (``flax_from_model(model, params=...)`` one way,
``state_dict_from_flax({"params": tree}, cfg)`` the other).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from diffdock_tpu_torch.models.config import ScoreModelConfig
from diffdock_tpu_torch.models.score_model import ScalarBatchNorm

_LIST_MODULES = ("rec_emb", "lig_emb", "conv", "lig_conv", "rec_conv", "lig_to_rec_conv",
                 "rec_to_lig_conv")
_INNER_LISTS = {"Dense": "layers", "BatchNorm": "norms", "cat": "embeddings"}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _module_path(parts: Tuple[str, ...]) -> list:
    out = []
    for p in parts:
        m = re.fullmatch(r"(\w+?)_(\d+)", p)
        if m and not out and m.group(1) in _LIST_MODULES:
            out += [f"{m.group(1)}_layers", m.group(2)]
        elif m and out and m.group(1) in _INNER_LISTS:
            out += [_INNER_LISTS[m.group(1)], m.group(2)]
        else:
            out.append(p)
    return out


def state_dict_from_flax(variables: Mapping, cfg: ScoreModelConfig) -> Dict[str, torch.Tensor]:
    """``variables``: {'params': ..., 'batch_stats': ...} from the JAX
    model's ``init`` (``CGScoreModel``, ``AAScoreModel``, ``OldCGScoreModel``
    or ``OldAAScoreModel``, in either mode);
    returns a ``state_dict`` for the port's model of the same config. The
    confidence heads (``confidence_predictor``,
    ``atom_confidence_predictor``, ``affinity_predictor``) map through the
    inner ``Dense_{i}`` / ``BatchNorm_{i}`` names like every other MLP."""
    sd: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(variables["params"]):
        *mods, leaf = path
        name = _module_path(tuple(mods))
        if leaf == "kernel":
            value = value.T  # Dense (in, out) -> Linear (out, in)
            leaf = "weight"
        elif leaf in ("embedding", "scale"):
            leaf = "weight"
        sd[".".join(name + [leaf])] = torch.from_numpy(np.array(value, np.float32))
    for path, value in _flatten(variables.get("batch_stats", {})):
        *mods, leaf = path
        leaf = {"mean": "running_mean", "var": "running_var"}[leaf]
        sd[".".join(_module_path(tuple(mods)) + [leaf])] = torch.from_numpy(
            np.array(value, np.float32)
        )
    return sd


_INNER_NAMES = {v: k for k, v in _INNER_LISTS.items()}


def _flax_path(parts) -> list:
    """The inverse of :func:`_module_path`."""
    out, i = [], 0
    while i < len(parts):
        p = parts[i]
        nxt = parts[i + 1] if i + 1 < len(parts) else None
        if i == 0 and p.endswith("_layers") and p[:-len("_layers")] in _LIST_MODULES and nxt is not None:
            out.append(f"{p[:-len('_layers')]}_{nxt}")
            i += 2
        elif i > 0 and p in _INNER_NAMES and nxt is not None and nxt.isdigit():
            out.append(f"{_INNER_NAMES[p]}_{nxt}")
            i += 2
        else:
            out.append(p)
            i += 1
    return out


def flax_path(param_name: str) -> list:
    """The flax module path of a port parameter or buffer name, with the
    port's leaf name last (``conv_layers.0.fc_1.layers.0.weight`` ->
    ``['conv_0', 'fc_1', 'Dense_0', 'weight']``)."""
    *mods, leaf = param_name.split(".")
    return _flax_path(mods) + [leaf]


def flax_from_model(model: torch.nn.Module,
                    params: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, dict]:
    """``{'params': ..., 'batch_stats': ...}`` of a port model, as nested
    dicts of float32 numpy arrays in the flax layout: the tree
    :func:`state_dict_from_flax` maps back to ``model.state_dict()``.
    ``params``: tensors by parameter name (gradients, Adam moments, EMA
    weights) written in place of the model's own parameters."""
    tree: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    for mod_name, module in model.named_modules():
        parts = mod_name.split(".") if mod_name else []
        own = list(module.named_parameters(recurse=False))
        if params is not None:
            own = [(n, params[f"{mod_name}.{n}" if mod_name else n]) for n, _ in own]
        named = own + [
            (n, b) for n, b in module.named_buffers(recurse=False)
            if n in module.state_dict(keep_vars=True)]
        for name, value in named:
            value = value.detach().cpu().numpy().astype(np.float32)
            collection = "params"
            if name in ("running_mean", "running_var"):
                collection, name = "batch_stats", name[len("running_"):]
            elif isinstance(module, torch.nn.Linear) and name == "weight":
                name, value = "kernel", value.T
            elif isinstance(module, torch.nn.Embedding) and name == "weight":
                name = "embedding"
            elif isinstance(module, ScalarBatchNorm) and name == "weight":
                name = "scale"
            node = tree[collection]
            for p in _flax_path(parts):
                node = node.setdefault(p, {})
            node[name] = np.ascontiguousarray(value)
    if not tree["batch_stats"]:
        del tree["batch_stats"]
    return tree


def build_model(cfg: ScoreModelConfig) -> torch.nn.Module:
    """The port model of ``cfg`` on the CPU
    (:func:`diffdock_tpu_torch.models.factory.build_model`)."""
    from diffdock_tpu_torch.models.factory import build_model as build

    return build(cfg)


def load_converted(params: Mapping, batch_stats: Mapping, report: Mapping,
                   cfg: ScoreModelConfig) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of the port model of ``cfg`` from an importer's
    ``(params, batch_stats, report)``
    (:func:`diffdock_tpu_torch.utils.torch_import.convert_state_dict`).
    Nothing is guessed: a reference key the importer left unconsumed, a
    model entry the tree does not produce, an entry the model does not
    have and a shape that differs each raise, naming the keys."""
    unconsumed = list(report.get("unconsumed", ()))
    if unconsumed:
        raise ValueError(f"{len(unconsumed)} reference keys were not consumed: {unconsumed}")
    sd = state_dict_from_flax({"params": params, "batch_stats": batch_stats}, cfg)
    want = build_model(cfg).state_dict()
    missing = sorted(set(want) - set(sd))
    extra = sorted(set(sd) - set(want))
    shapes = sorted(k for k in set(sd) & set(want) if tuple(sd[k].shape) != tuple(want[k].shape))
    if missing or extra or shapes:
        raise ValueError(
            f"converted weights do not fit the model: missing {missing}, not in the model "
            f"{extra}, shapes differ {[(k, tuple(sd[k].shape), tuple(want[k].shape)) for k in shapes]}")
    return sd
