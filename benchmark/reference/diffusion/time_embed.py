"""Diffusion-time embeddings (port of ``diffdock_tpu/diffusion/time_embed.py``)."""

from __future__ import annotations

import math
from typing import Callable

import torch


def sinusoidal_embedding(
    timesteps: torch.Tensor, embedding_dim: int, max_positions: int = 10000
) -> torch.Tensor:
    """(N,) -> (N, embedding_dim) transformer-style sinusoidal embedding."""
    assert timesteps.ndim == 1
    half_dim = embedding_dim // 2
    emb = math.log(max_positions) / (half_dim - 1)
    emb = torch.exp(
        torch.arange(half_dim, dtype=torch.float32, device=timesteps.device) * -emb
    )
    emb = timesteps.to(torch.float32)[:, None] * emb[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    if embedding_dim % 2 == 1:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


def get_timestep_embedding(
    embedding_type: str, embedding_dim: int, embedding_scale: float = 10000.0
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Return t -> embedding fn (``sinusoidal``, the embedding both
    configurations run; the port's ``fourier`` is not copied)."""
    if embedding_type == "sinusoidal":
        return lambda x: sinusoidal_embedding(embedding_scale * x, embedding_dim)
    raise ValueError(f"embedding_type {embedding_type!r}: the reference has the sinusoidal embedding only")
