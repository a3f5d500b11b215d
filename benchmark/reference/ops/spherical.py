"""Closed-form real spherical harmonics, lmax <= 2, component-normalized.

Port of ``diffdock_tpu/ops/spherical.py``: components ordered m = -l..l with
the real SH mapping l=1 -> (y, z, x) (the e3nn convention), consistent with
the real Wigner-3j tensors in :mod:`benchmark.reference.ops.wigner`.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.ops.irreps import Irreps

SH_IRREPS = {
    0: Irreps("0e"),
    1: Irreps("0e + 1o"),
    2: Irreps("0e + 1o + 2e"),
}

_SQRT3 = math.sqrt(3.0)
_SQRT15 = math.sqrt(15.0)
_SQRT5_2 = math.sqrt(5.0) / 2.0
_SQRT15_2 = math.sqrt(15.0) / 2.0


def spherical_harmonics(
    vec: torch.Tensor, lmax: int, normalize: bool = True, eps: float = 1e-12
) -> torch.Tensor:
    """(..., 3) vectors -> (..., (lmax+1)^2) concatenated Y_0..Y_lmax.

    Zero vectors (padded edges) map to a safe direction; callers mask the
    results anyway.
    """
    if normalize:
        n = torch.linalg.norm(vec, dim=-1, keepdim=True)
        vec = vec / torch.clamp(n, min=eps)
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]

    out = [torch.ones_like(x)]
    if lmax >= 1:
        out += [_SQRT3 * y, _SQRT3 * z, _SQRT3 * x]
    if lmax >= 2:
        out += [
            _SQRT15 * x * y,
            _SQRT15 * y * z,
            _SQRT5_2 * (3.0 * z * z - 1.0),
            _SQRT15 * x * z,
            _SQRT15_2 * (x * x - y * y),
        ]
    if lmax >= 3:
        raise NotImplementedError("lmax <= 2 covers the model family")
    return torch.stack(out, dim=-1)


def irrep1_to_vector(u: torch.Tensor) -> torch.Tensor:
    """l=1 irrep components (y, z, x) -> ambient vector (x, y, z)."""
    return u[..., [2, 0, 1]]
