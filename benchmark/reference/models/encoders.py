"""Feature encoders (port of ``diffdock_tpu/models/encoders.py``).

Submodule and parameter names follow the flax modules so that
:func:`benchmark.reference.utils.convert.state_dict_from_flax` is a name map:
flax ``Dense_{i}`` -> ``layers.{i}``, ``cat_{i}`` -> ``embeddings.{i}``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn


class Dropout(nn.Module):
    """Inverted dropout in training mode (flax ``nn.Dropout``: keep with
    probability 1 - p, scale kept values by 1 / (1 - p)); the identity in
    evaluation mode or at p = 0. Its mask comes from ``generator`` (set by
    the trainer, :meth:`CGScoreModel.set_generator`), or the default
    generator when none is set. It starts in evaluation mode, as the batch
    norms do."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None
        self.train(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


class FCBlock(nn.Module):
    """MLP emitting tensor-product weights (reference ``models/layers.py:10``).

    The output layer's kernel/bias are direct parameters (``out_kernel``
    (hidden, out), ``out_bias`` (out,)), not a Linear submodule, so the
    factored tensor-product path contracts them AFTER the neighbour
    reduction — see ``models/tpconv.py``. Activation: ReLU (the
    score model's), each hidden layer followed by dropout.
    """

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, layers: int = 2,
                 dropout: float = 0.0):
        super().__init__()
        if layers < 2:
            raise ValueError("FCBlock needs at least 2 layers")
        dims = [in_dim] + [hidden_dim] * (layers - 1)
        self.layers = nn.ModuleList(
            nn.Linear(dims[i], dims[i + 1]) for i in range(layers - 1)
        )
        self.drop = Dropout(dropout)
        self.out_kernel = nn.Parameter(torch.zeros(hidden_dim, out_dim))
        self.out_bias = nn.Parameter(torch.zeros(out_dim))

    def hidden(self, x: torch.Tensor) -> torch.Tensor:
        """The hidden activations; the weights are ``hidden(x) @ out_kernel
        + out_bias``, contracted only after the neighbour reduction. They
        are computed in ``x``'s dtype, as flax's ``Dense(dtype=...)`` of the
        JAX block: for bfloat16 the kernel and bias are cast to it, the
        product sums its exact products in float32 and rounds, and the bias
        is added in bfloat16."""
        for layer in self.layers:
            if x.dtype == torch.float32:
                y = layer(x)
            else:
                y = nn.functional.linear(x.float(), layer.weight.to(x.dtype).float()).to(x.dtype)
                y = y + layer.bias.to(x.dtype)
            x = self.drop(torch.relu(y))
        return x


class GaussianSmearing(nn.Module):
    """RBF distance embedding (reference ``models/layers.py:20-30``)."""

    def __init__(self, start: float = 0.0, stop: float = 5.0, num_gaussians: int = 50):
        super().__init__()
        offset = np.linspace(start, stop, num_gaussians)
        self.coeff = -0.5 / float(offset[1] - offset[0]) ** 2
        self.register_buffer(
            "offset", torch.as_tensor(offset, dtype=torch.float32), persistent=False
        )

    def forward(self, dist: torch.Tensor) -> torch.Tensor:
        d = dist[..., None] - self.offset
        return torch.exp(self.coeff * d * d)


class AtomEncoder(nn.Module):
    """Sum of categorical embeddings + linear fuse of extra scalar features
    (reference ``models/layers.py:33-68``, the 'new' encoder)."""

    def __init__(self, emb_dim: int, categorical_dims: Sequence[int], scalar_dim: int = 0):
        super().__init__()
        self.embeddings = nn.ModuleList(nn.Embedding(d, emb_dim) for d in categorical_dims)
        self.scalar_dim = scalar_dim
        if scalar_dim > 0:
            self.fuse = nn.Linear(emb_dim + scalar_dim, emb_dim)

    def forward(self, x_cat: torch.Tensor, x_scalar: Optional[torch.Tensor] = None) -> torch.Tensor:
        emb = 0.0
        for i, table in enumerate(self.embeddings):
            emb = emb + table(x_cat[..., i])
        if self.scalar_dim > 0:
            if x_scalar is None or x_scalar.shape[-1] != self.scalar_dim:
                raise ValueError(f"AtomEncoder expects {self.scalar_dim} scalar features")
            emb = self.fuse(torch.cat([emb, x_scalar], dim=-1))
        return emb


class OldAtomEncoder(nn.Module):
    """The v1.0 encoder (reference ``models/layers.py:70-116``): categorical
    embeddings and a linear map of the scalar features are SUMMED; a
    language-model embedding, if present, is concatenated afterwards and
    fused by ``lm_embedding_layer``.

    ``x_tail`` is the whole non-categorical tail of the reference node array
    in reference order: ``(lm_embedding, sigma_emb)`` for receptors with
    ESM, ``(sigma_emb,)`` otherwise. The reference slices the scalars as
    ``x_tail[:scalar_dim]`` and the LM block as ``x_tail[-lm_dim:]``; with
    ESM the two OVERLAP (the 'scalar' block is the first ``scalar_dim`` LM
    dims, the 'lm' block is the rest of lm plus sigma). The released
    weights were trained with that overlap, so it is kept verbatim.
    """

    def __init__(self, emb_dim: int, categorical_dims: Sequence[int], scalar_dim: int = 0,
                 lm_dim: int = 0):
        super().__init__()
        self.embeddings = nn.ModuleList(nn.Embedding(d, emb_dim) for d in categorical_dims)
        self.scalar_dim, self.lm_dim = scalar_dim, lm_dim
        if scalar_dim > 0:
            self.linear = nn.Linear(scalar_dim, emb_dim)
        if lm_dim > 0:
            self.lm_embedding_layer = nn.Linear(emb_dim + lm_dim, emb_dim)

    def forward(self, x_cat: torch.Tensor, x_tail: Optional[torch.Tensor] = None) -> torch.Tensor:
        emb = 0.0
        for i, table in enumerate(self.embeddings):
            emb = emb + table(x_cat[..., i])
        if self.scalar_dim > 0 or self.lm_dim > 0:
            if x_tail is None or x_tail.shape[-1] != self.scalar_dim + self.lm_dim:
                raise ValueError(f"OldAtomEncoder expects {self.scalar_dim + self.lm_dim} tail features")
        if self.scalar_dim > 0:
            emb = emb + self.linear(x_tail[..., : self.scalar_dim])
        if self.lm_dim > 0:
            emb = self.lm_embedding_layer(torch.cat([emb, x_tail[..., -self.lm_dim :]], dim=-1))
        return emb


class MLP2(nn.Module):
    """Dense-ReLU-Dropout-Dense, the reference's edge-embedding Sequential."""

    def __init__(self, in_dim: int, out_dim: int, dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList([nn.Linear(in_dim, out_dim), nn.Linear(out_dim, out_dim)])
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers[1](self.drop(torch.relu(self.layers[0](x))))


class FinalNormLayer(nn.Module):
    """Norm-conditioned rescaling head (reference ``cg_model.py:229-230``):
    Dense-Dropout-ReLU-Dense."""

    def __init__(self, in_dim: int, ns: int, dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList([nn.Linear(in_dim, ns), nn.Linear(ns, 1)])
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers[1](torch.relu(self.drop(self.layers[0](x))))
