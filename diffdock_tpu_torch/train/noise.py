"""Forward-diffusion noising for training (port of ``diffdock_tpu/train/noise.py``).

For a batch of B complexes: sample t, perturb each ligand pose on
T(3) x SO(3) x SO(2)^m, and attach the regression targets

    tr_score  = -tr_update / tr_sigma^2
    rot_score = IGSO3 score at the sampled rotation (so3.score_vec)
    tor_score = wrapped-Gaussian score at the sampled torsions

The JAX function draws from a ``jax.random`` key; here every random number
comes in as one :class:`NoiseDraws` argument (so a test can feed JAX's own
draws), or from a ``torch.Generator`` through :func:`draw_noise`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from diffdock_tpu_torch.data.complexes import ComplexData
from diffdock_tpu_torch.diffusion.schedules import SigmaConfig, t_to_sigma
from diffdock_tpu_torch.diffusion.so3 import SO3Tables
from diffdock_tpu_torch.diffusion.torus import TorusTables
from diffdock_tpu_torch.geometry.rigid import modify_conformer


class NoiseDraws(NamedTuple):
    """The random numbers of one noising of B complexes with nb bond slots."""

    t: torch.Tensor  # (B,) diffusion times in [0, 1]
    tr: torch.Tensor  # (B, 3) standard normal
    rot_u: torch.Tensor  # (B,) uniform in [0, 1): the IGSO3 angle's cdf
    rot_dir: torch.Tensor  # (B, 3) standard normal: the rotation axis
    tor: torch.Tensor  # (B, nb) standard normal


class NoisySample(NamedTuple):
    pos: torch.Tensor  # (B, NL, 3) perturbed ligand poses
    t: torch.Tensor  # (B,)
    tr_score: torch.Tensor  # (B, 3)
    rot_score: torch.Tensor  # (B, 3)
    tor_score: torch.Tensor  # (B, nb)


def draw_noise(generator: torch.Generator, n_complexes: int, n_bonds: int,
               device="cuda") -> NoiseDraws:
    """Every draw of one noising from ``generator`` (on ``device``); t is
    uniform, JAX's Beta(sampling_alpha, sampling_beta) at the 1, 1 that
    every caller of the JAX trainer uses."""
    kw = dict(generator=generator, device=device)
    return NoiseDraws(
        t=torch.rand(n_complexes, **kw),
        tr=torch.randn(n_complexes, 3, **kw),
        rot_u=torch.rand(n_complexes, **kw),
        rot_dir=torch.randn(n_complexes, 3, **kw),
        tor=torch.randn(n_complexes, n_bonds, **kw),
    )


def apply_noise(
    data: ComplexData,
    draws: NoiseDraws,
    sigma_cfg: SigmaConfig,
    so3_tables: SO3Tables,
    torus_tables: TorusTables,
    no_torsion: bool = False,
) -> NoisySample:
    """One noisy training sample per complex of the stacked batch ``data``
    (fields with a leading axis B)."""
    t = draws.t
    tr_sigma, rot_sigma, tor_sigma = t_to_sigma(t, t, t, sigma_cfg)
    tr_update = draws.tr * tr_sigma[:, None]
    rot_update = so3_tables.sample_vec(rot_sigma, draws.rot_u, draws.rot_dir)

    B, nb = data.rot_u.shape
    torsion = not no_torsion and nb > 0
    if torsion:
        tor_sigma_b = tor_sigma[:, None].expand(B, nb)
        tor_updates = torus_tables.sample(tor_sigma_b, draws.tor) * data.rot_mask
        tor_score = torus_tables.score(tor_updates, tor_sigma_b) * data.rot_mask
    else:
        tor_updates = tor_score = data.lig_pos.new_zeros(B, nb)

    # each complex has its own bond topology: one modify_conformer each
    pos = torch.cat([
        modify_conformer(
            data.lig_pos[b : b + 1], tr_update[b : b + 1], rot_update[b : b + 1],
            tor_updates[b : b + 1] if torsion else None,
            data.rot_u[b], data.rot_v[b], data.mask_rotate[b], data.rot_mask[b],
            atom_mask=data.lig_mask[b],
        )
        for b in range(B)
    ])
    return NoisySample(
        pos=pos, t=t, tr_score=-tr_update / tr_sigma[:, None] ** 2,
        rot_score=so3_tables.score_vec(rot_sigma, rot_update), tor_score=tor_score,
    )
