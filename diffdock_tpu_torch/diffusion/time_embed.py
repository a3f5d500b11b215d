"""Diffusion-time embeddings (port of ``diffdock_tpu/diffusion/time_embed.py``)."""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from diffdock_tpu_torch.utils import threefry


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


def gaussian_fourier_embedding(timesteps: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Gaussian Fourier features; ``w`` is a fixed (embedding_size//2,) draw."""
    x_proj = timesteps[:, None] * w[None, :] * 2 * math.pi
    return torch.cat([torch.sin(x_proj), torch.cos(x_proj)], dim=-1)


def fourier_frequencies(embedding_dim: int, embedding_scale: float) -> np.ndarray:
    """The JAX package's frequencies, ``jax.random.normal(PRNGKey(0),
    (embedding_dim // 2,)) * embedding_scale``, float32, drawn in numpy."""
    return (threefry.normal(0, embedding_dim // 2) * np.float32(embedding_scale)).astype(np.float32)


def get_timestep_embedding(
    embedding_type: str, embedding_dim: int, embedding_scale: float = 10000.0
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Return t -> embedding fn (``sinusoidal``, the training default, or
    ``fourier``)."""
    if embedding_type == "sinusoidal":
        return lambda x: sinusoidal_embedding(embedding_scale * x, embedding_dim)
    if embedding_type == "fourier":
        w = torch.from_numpy(fourier_frequencies(embedding_dim, embedding_scale))
        return lambda x: gaussian_fourier_embedding(x, w.to(x.device))
    raise ValueError(f"unknown embedding_type {embedding_type!r}")
