"""Each dock's diffusion noise, drawn by the benchmark from a seed.

The draws of one pose batch in the order the port's sampler documents
(``InitNoise``: torsions uniform in [-pi, pi), a standard-normal
quaternion, a standard-normal translation, a uniform residue pick; then
``StepNoise``: per step standard-normal translations, rotations and
torsions), on the device from a ``torch.Generator``. The port gets them
through ``dock_complex(..., noise=...)`` and the reference replays the
same tensors.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Draws(NamedTuple):
    tor0: torch.Tensor  # (P, B)
    rot0: torch.Tensor  # (P, 4)
    tr0: torch.Tensor  # (P, 1, 3)
    res0: torch.Tensor  # (P,)
    tr: torch.Tensor  # (S, P, 3)
    rot: torch.Tensor  # (S, P, 3)
    tor: torch.Tensor  # (S, P, B)

    @staticmethod
    def make(num_poses: int, n_bonds: int, n_steps: int, seed: int, device) -> "Draws":
        kw = dict(generator=torch.Generator(device=device).manual_seed(seed), device=device)
        tor0 = torch.rand(num_poses, n_bonds, **kw) * (2 * math.pi) - math.pi
        rot0 = torch.randn(num_poses, 4, **kw)
        tr0 = torch.randn(num_poses, 1, 3, **kw)
        res0 = torch.rand(num_poses, **kw)
        tr = torch.randn(n_steps, num_poses, 3, **kw)
        rot = torch.randn(n_steps, num_poses, 3, **kw)
        tor = torch.randn(n_steps, num_poses, n_bonds, **kw)
        return Draws(tor0, rot0, tr0, res0, tr, rot, tor)
