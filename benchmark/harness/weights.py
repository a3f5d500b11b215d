"""Random weights made on the device from the seed.

The state dict is laid out by the reference's module tree (the port's has
the same names and shapes) and filled with the scales of the modules' own
initialisation (``reset_parameters``): ``nn.Linear`` weights normal(0,
1/in), biases zero; embeddings Glorot-uniform; the FC blocks' output kernels
normal(0, 1/hidden), their biases zero; equivariant linears normal(0, 1);
batch norms at identity statistics. All normal draws come from one
``torch.randn`` and all uniform ones from one ``torch.rand``, on the device,
with a ``torch.Generator`` seeded from the run's seed; the same dict goes to
the port and to the reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch import nn

from benchmark.reference.models.encoders import FCBlock
from benchmark.reference.models.score_model import ScalarBatchNorm
from benchmark.reference.ops.batch_norm import IrrepsBatchNorm

# (state-dict name, shape, kind, scale); kind: "normal", "uniform", "zero", "one"
Spec = Tuple[str, Tuple[int, ...], str, float]


def init_specs(model: nn.Module) -> List[Spec]:
    """How each entry of ``model``'s state dict is initialised."""
    specs: Dict[str, Spec] = {}
    for prefix, m in model.named_modules():
        name = (prefix + ".") if prefix else ""
        if isinstance(m, nn.Linear):
            specs[name + "weight"] = (name + "weight", tuple(m.weight.shape), "normal",
                                      1.0 / math.sqrt(m.in_features))
            if m.bias is not None:
                specs[name + "bias"] = (name + "bias", tuple(m.bias.shape), "zero", 0.0)
        elif isinstance(m, nn.Embedding):
            a = math.sqrt(6.0 / (m.num_embeddings + m.embedding_dim))
            specs[name + "weight"] = (name + "weight", tuple(m.weight.shape), "uniform", a)
        elif isinstance(m, FCBlock):
            specs[name + "out_kernel"] = (name + "out_kernel", tuple(m.out_kernel.shape), "normal",
                                          1.0 / math.sqrt(m.out_kernel.shape[0]))
            specs[name + "out_bias"] = (name + "out_bias", tuple(m.out_bias.shape), "zero", 0.0)
        elif isinstance(m, (IrrepsBatchNorm, ScalarBatchNorm)):
            for key, kind in (("running_mean", "zero"), ("running_var", "one"),
                              ("weight", "one"), ("bias", "zero")):
                t = getattr(m, key)
                specs[name + key] = (name + key, tuple(t.shape), kind, 0.0)
    missing = [k for k in model.state_dict() if k not in specs]
    if missing:
        raise ValueError(f"no initialisation rule for {missing[:5]}")
    return [specs[k] for k in model.state_dict()]


def make_state_dict(specs: List[Spec], seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of ``specs`` from ``seed``: one normal and one uniform
    draw of all the entries' values, on ``device``, in float32."""
    device = torch.device(device)
    n_normal = sum(math.prod(s[1]) for s in specs if s[2] == "normal")
    n_uniform = sum(math.prod(s[1]) for s in specs if s[2] == "uniform")
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device) * 2.0 - 1.0
    out, on, ou = {}, 0, 0
    for name, shape, kind, scale in specs:
        n = math.prod(shape)
        if kind == "normal":
            out[name] = normal[on : on + n].view(shape) * scale
            on += n
        elif kind == "uniform":
            out[name] = uniform[ou : ou + n].view(shape) * scale
            ou += n
        elif kind == "zero":
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = torch.ones(shape, device=device)
    return out
