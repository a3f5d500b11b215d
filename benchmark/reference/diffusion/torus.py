"""Wrapped Gaussian on the torus SO(2)^m: score tables on the device.

Port of ``diffdock_tpu/diffusion/torus.py``. The tables come from the same
numpy code, so they are bit-identical to the JAX package's; lookups
replicate the reference's nearest-index rounding in float32. The
training draw (:meth:`TorusTables.sample`) takes its normal as an argument.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Tuple

import numpy as np
import torch

from benchmark.reference.diffusion.tables import cached_tables


@dataclasses.dataclass(frozen=True)
class TorusConfig:
    """Grid parameters; defaults match reference ``utils/torus.py:24-26``."""

    x_min: float = 1e-5  # relative to pi
    x_n: int = 5000
    sigma_min: float = 3e-3  # relative to pi
    sigma_max: float = 2.0  # relative to pi
    sigma_n: int = 5000
    wrap_terms: int = 32
    mc_samples: int = 10000
    mc_seed: int = 0


def _wrapped_sums(x: np.ndarray, s2: np.ndarray, wrap_terms: int):
    """(p, dp/dx) of the wrapped Gaussian for the rows ``s2`` = sigma^2."""
    p = np.zeros((s2.shape[0], x.shape[0]))
    grad = np.zeros_like(p)
    for i in range(-wrap_terms, wrap_terms + 1):
        xi = x[None, :] + 2 * np.pi * i
        e = np.exp(-(xi**2) / 2 / s2)
        p += e
        grad += xi / s2 * e
    return p, grad


def _generate_tables(cfg: TorusConfig) -> Tuple[np.ndarray, ...]:
    x = 10 ** np.linspace(np.log10(cfg.x_min), 0, cfg.x_n + 1) * np.pi
    sigma = (
        10 ** np.linspace(np.log10(cfg.sigma_min), np.log10(cfg.sigma_max),
                          cfg.sigma_n + 1) * np.pi
    )

    # the wrapped sums, elementwise over the (sigma, x) grid: computed in
    # row blocks on the host's cores (numpy releases the GIL), each element
    # by the same operations in the same order as in one block
    s2 = sigma[:, None] ** 2
    n_workers = max(1, min(os.cpu_count() or 1, 16))
    bounds = np.linspace(0, sigma.shape[0], n_workers + 1).astype(int)
    with ThreadPoolExecutor(max_workers=n_workers) as pool:
        parts = list(pool.map(lambda ab: _wrapped_sums(x, s2[ab[0] : ab[1]], cfg.wrap_terms),
                              zip(bounds[:-1], bounds[1:])))
    p = np.concatenate([a for a, _ in parts])
    grad = np.concatenate([g for _, g in parts])
    eps = np.finfo(p.dtype).eps
    score = grad / (p + eps)

    # Monte-Carlo E[score^2] per sigma with a fixed seed
    rng = np.random.RandomState(cfg.mc_seed)
    samples = sigma[None, :] * rng.randn(cfg.mc_samples, sigma.shape[0])
    samples = (samples + np.pi) % (2 * np.pi) - np.pi
    sgn = np.sign(samples)
    xi_idx = np.log(np.abs(samples) / np.pi)
    xi_idx = (xi_idx - np.log(cfg.x_min)) / (0 - np.log(cfg.x_min)) * cfg.x_n
    xi_idx = np.round(np.clip(xi_idx, 0, cfg.x_n)).astype(int)
    si_idx = np.broadcast_to(np.arange(sigma.shape[0]), samples.shape)
    sc = -sgn * score[si_idx, xi_idx]
    score_norm = (sc**2).mean(0)

    return x, sigma, p, score, score_norm


@dataclasses.dataclass(frozen=True)
class TorusTables:
    cfg: TorusConfig
    p_table: torch.Tensor  # (SIGMA_N+1, X_N+1)
    score_table: torch.Tensor  # (SIGMA_N+1, X_N+1)
    score_norm_table: torch.Tensor  # (SIGMA_N+1,)

    def _sigma_idx(self, sigma: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        si = torch.log(sigma / math.pi)
        si = (si - float(np.log(c.sigma_min))) / float(
            np.log(c.sigma_max) - np.log(c.sigma_min)
        ) * c.sigma_n
        return torch.round(torch.clamp(si, 0, c.sigma_n)).long()

    def _x_idx(self, x: torch.Tensor):
        c = self.cfg
        x = torch.remainder(x + math.pi, 2 * math.pi) - math.pi
        sign = torch.sign(x)
        xi = torch.log(torch.abs(x) / math.pi)
        xi = (xi - float(np.log(c.x_min))) / float(0 - np.log(c.x_min)) * c.x_n
        return sign, torch.round(torch.clamp(xi, 0, c.x_n)).long()

    def score(self, x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
        """d/dx log p(x; sigma) (reference ``utils/torus.py:43-54``)."""
        sign, xi = self._x_idx(x)
        return -sign * self.score_table[self._sigma_idx(sigma), xi]

    def p(self, x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
        _, xi = self._x_idx(x)
        return self.p_table[self._sigma_idx(sigma), xi]

    def score_norm(self, sigma: torch.Tensor) -> torch.Tensor:
        """MC estimate of E[score^2] (reference ``utils/torus.py:79-83``)."""
        return self.score_norm_table[self._sigma_idx(sigma)]

    @staticmethod
    def sample(sigma: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
        """Wrapped Gaussian sample from the standard normal ``normal``
        (reference ``utils/torus.py:66-69``)."""
        return torch.remainder(sigma * normal + math.pi, 2 * math.pi) - math.pi


def _torus_arrays(cfg: TorusConfig):
    def generate():
        _, _, p, score, sn = _generate_tables(cfg)
        return dict(p=p, score=score, score_norm=sn)

    return cached_tables("torus", cfg, generate)


@functools.lru_cache(maxsize=4)
def get_torus_tables(cfg: TorusConfig = TorusConfig(), device="cuda") -> TorusTables:
    a = _torus_arrays(cfg)
    # normal tensors even when first asked for inside torch.inference_mode
    # (a dock), so that a training forward can save what it derives from them
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32).to(device)
    with torch.inference_mode(False):
        return TorusTables(cfg, f32(a["p"]), f32(a["score"]), f32(a["score_norm"]))
