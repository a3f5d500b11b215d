"""Reverse-diffusion pose sampler (port of ``diffdock_tpu/inference/sampler.py``).

The JAX sampler is one ``lax.scan`` with poses as a ``vmap`` axis; here the
steps are a Python loop over a pose batch. Random draws come from an
explicit ``torch.Generator``, or are passed in (:class:`InitNoise`,
:class:`StepNoise`) so a test can hand the port the JAX package's own
``jax.random`` draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from diffdock_tpu_torch.data.complexes import ComplexData
from diffdock_tpu_torch.diffusion.schedules import get_t_schedule, t_to_sigma
from diffdock_tpu_torch.geometry.rigid import modify_conformer
from diffdock_tpu_torch.geometry.rotations import random_rotation_matrix
from diffdock_tpu_torch.geometry.torsion import apply_torsion_updates
from diffdock_tpu_torch.utils.profiling import count, span


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Inference recipe (reference ``default_inference_args.yaml``)."""

    inference_steps: int = 20
    actual_steps: Optional[int] = 19
    sigma_schedule: str = "expbeta"
    inf_sched_alpha: float = 1.0
    inf_sched_beta: float = 1.0
    t_max: float = 1.0
    no_random: bool = False
    no_random_pocket: bool = False
    no_final_step_noise: bool = True
    ode: bool = False
    initial_noise_std_proportion: float = 1.4601642460337794
    choose_residue: bool = False
    pocket_tr_max: Optional[float] = None
    # low-temperature sampling (DiffDock-L inference trick,
    # utils/sampling.py:173-186)
    temp_sampling: Tuple[float, float, float] = (
        1.170050527854316, 2.06391612594481, 7.044261621607846
    )
    temp_psi: Tuple[float, float, float] = (
        0.727287304570729, 0.9022615585677628, 0.5946212391366862
    )
    temp_sigma_data: Tuple[float, float, float] = (
        0.9299802531572672, 0.7464326999906034, 0.6943254174849822
    )

    def schedule(self) -> np.ndarray:
        return get_t_schedule(
            self.sigma_schedule, self.inference_steps,
            self.inf_sched_alpha, self.inf_sched_beta, self.t_max,
        )

    @property
    def num_steps(self) -> int:
        # actual_steps caps how many of the schedule's steps run (the
        # shipped recipe is 19 of 20)
        return min(self.actual_steps or self.inference_steps, self.inference_steps)


class InitNoise(NamedTuple):
    """Draws for :func:`randomize_position`: ``tor`` (P, B) uniform in
    [-pi, pi), ``rot`` (P, 4) standard normal (quaternion), ``tr``
    (P, 1, 3) standard normal, ``res`` (P,) uniform in [0, 1)."""

    tor: torch.Tensor
    rot: torch.Tensor
    tr: torch.Tensor
    res: torch.Tensor

    @staticmethod
    def draw(num_poses: int, n_bonds: int, generator: torch.Generator, device) -> "InitNoise":
        kw = dict(generator=generator, device=device)
        return InitNoise(
            tor=torch.rand(num_poses, n_bonds, **kw) * (2 * math.pi) - math.pi,
            rot=torch.randn(num_poses, 4, **kw),
            tr=torch.randn(num_poses, 1, 3, **kw),
            res=torch.rand(num_poses, **kw),
        )


class StepNoise(NamedTuple):
    """Standard-normal draws for every step: ``tr`` and ``rot`` (S, P, 3),
    ``tor`` (S, P, B)."""

    tr: torch.Tensor
    rot: torch.Tensor
    tor: torch.Tensor

    @staticmethod
    def draw(n_steps: int, num_poses: int, n_bonds: int, generator: torch.Generator,
             device) -> "StepNoise":
        kw = dict(generator=generator, device=device)
        return StepNoise(
            tr=torch.randn(n_steps, num_poses, 3, **kw),
            rot=torch.randn(n_steps, num_poses, 3, **kw),
            tor=torch.randn(n_steps, num_poses, n_bonds, **kw),
        )


def randomize_position(
    data: ComplexData,
    num_poses: int,
    tr_sigma_max: float,
    noise: InitNoise,
    initial_noise_std_proportion: float = -1.0,
    no_random: bool = False,
    no_torsion: bool = False,
    choose_residue: bool = False,
    pocket_center: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Initial pose replicas (reference ``utils/sampling.py:16-58``):
    torsions ~ U(-pi, pi), a Haar-random orientation about the ligand
    center, placement at the receptor center (or ``pocket_center``, (3,)
    in the complex's centered frame) plus Gaussian translation noise;
    (P, NL, 3)."""
    pos = data.lig_pos
    w = data.lig_mask[:, None].to(pos.dtype)
    if pocket_center is None:
        rw = data.rec_mask[:, None].to(pos.dtype)
        center = (data.rec_pos * rw).sum(0) / torch.clamp(rw.sum(), min=1.0)
    else:
        center = pocket_center

    poses = pos.expand((num_poses,) + pos.shape)
    if not no_torsion:
        poses = apply_torsion_updates(
            poses, data.rot_u, data.rot_v, data.mask_rotate, noise.tor, data.rot_mask
        )

    mol_center = (poses * w).sum(1) / torch.clamp(w.sum(), min=1.0)
    rots = random_rotation_matrix(noise.rot)
    poses = torch.einsum("pni,pji->pnj", poses - mol_center[:, None], rots) + center

    if not no_random:
        if choose_residue:
            # a uniformly random valid residue per pose (reference
            # sampling.py:50), offset from the receptor-center placement
            rmask = data.rec_mask
            n_valid = torch.clamp(rmask.sum(), min=1)
            order = torch.argsort((~rmask).to(torch.int8), stable=True)
            idx = torch.minimum((noise.res * n_valid.to(noise.res.dtype)).long(), n_valid - 1)
            tr = data.rec_pos[order][idx][:, None] + noise.tr * 0.01
        else:
            if initial_noise_std_proportion >= 0.0:
                rw = data.rec_mask.to(pos.dtype)
                std_rec = torch.sqrt(
                    (torch.sum(data.rec_pos ** 2, dim=1) * rw).sum() / torch.clamp(rw.sum(), min=1.0)
                )
                std = std_rec * initial_noise_std_proportion / 1.73
            else:
                std = -initial_noise_std_proportion * tr_sigma_max
            tr = noise.tr * std
        poses = poses + tr
    return poses


def _nan_guard(x: torch.Tensor) -> torch.Tensor:
    """Replace non-finite scores with a small disturbance so the trajectory
    survives (reference ``utils/sampling.py:118-131``)."""
    finite = torch.isfinite(x)
    mean_abs = torch.where(finite, torch.abs(x), torch.zeros_like(x)).sum() / torch.clamp(
        finite.sum(), min=1
    )
    eps = 0.01 * mean_abs
    return torch.where(finite, x, torch.sign(torch.nan_to_num(x, nan=1.0)) * eps)


def _low_temp(sampler_cfg, idx, sigma, sig_min, sig_max, g, dt, score, z):
    """lambda-interpolated low-temperature update for one component
    (reference ``utils/sampling.py:173-186``)."""
    temp = sampler_cfg.temp_sampling[idx]
    psi = sampler_cfg.temp_psi[idx]
    sd = sampler_cfg.temp_sigma_data[idx]
    if temp == 1.0:
        return g**2 * dt * score + g * torch.sqrt(dt) * z
    sigma_data = float(np.exp(sd * np.log(sig_max) + (1 - sd) * np.log(sig_min)))
    lam = (sigma_data + sigma) / (sigma_data + sigma / temp)
    return (
        g**2 * dt * (lam + temp * psi / 2.0) * score
        + g * torch.sqrt(dt * (1 + psi)) * z
    )


def reverse_diffusion(
    score_fn: Callable,
    data: ComplexData,
    init_poses: torch.Tensor,
    sampler_cfg: SamplerConfig,
    sigma_cfg,
    noise: StepNoise,
    no_torsion: bool = False,
    return_trajectory: bool = False,
    on_step: Optional[Callable] = None,
):
    """Run the reverse diffusion from ``init_poses`` (P, NL, 3).

    ``score_fn(poses, t)`` -> an object with ``tr`` (P, 3), ``rot`` (P, 3),
    ``tor`` (P, B); ``t`` is a 0-d float32 tensor. The last executed step
    integrates to t = 0 and is where ``no_final_step_noise`` applies, also
    when ``actual_steps < inference_steps``. Returns final poses, and with
    ``return_trajectory`` also the trajectory (steps+1, P, NL, 3): the
    start poses, then the poses after each step (reference
    ``utils/sampling.py:96-101,139-151``).

    ``on_step(step, poses, scores)`` is called on the host after step
    ``step`` (from 0) is issued, with the poses the step started from and
    ``score_fn``'s output for them (its ``tr``, ``rot`` and ``tor``), as
    device tensors the sampler does not change again; the device may not
    have computed them yet, and a caller clones what it keeps past the
    dock. The trajectory is built through it.

    The steps run in a ``diffusion`` span of the open dock record
    (``utils/profiling.py``), timed on the device's stream too (the steps
    tile it, so its stream time over the steps is their mean); each step
    is a ``step`` span with a ``score`` span (``score_fn``) and an
    ``update`` span (the NaN guard, the perturbations and
    ``modify_conformer``), ``on_step`` last inside it; ``score_forwards``
    counts the ``score_fn`` calls.
    """
    device = init_poses.device
    sched = sampler_cfg.schedule()
    n = sampler_cfg.num_steps
    t_curr = torch.as_tensor(sched[:n], dtype=torch.float32).to(device)
    t_next = torch.as_tensor(np.concatenate([sched[1:n], [0.0]]), dtype=torch.float32).to(device)
    g_scale = [
        float(np.sqrt(2 * np.log(hi / lo)))
        for lo, hi in (
            (sigma_cfg.tr_sigma_min, sigma_cfg.tr_sigma_max),
            (sigma_cfg.rot_sigma_min, sigma_cfg.rot_sigma_max),
            (sigma_cfg.tor_sigma_min, sigma_cfg.tor_sigma_max),
        )
    ]
    bounds = [
        (sigma_cfg.tr_sigma_min, sigma_cfg.tr_sigma_max),
        (sigma_cfg.rot_sigma_min, sigma_cfg.rot_sigma_max),
        (sigma_cfg.tor_sigma_min, sigma_cfg.tor_sigma_max),
    ]
    nb = data.rot_u.shape[0]
    frames = []

    def step_done(s, start, scores):
        if return_trajectory:
            frames.append(start)
        if on_step is not None:
            on_step(s, start, scores)

    poses = init_poses
    with span("diffusion", device=True):
        for s in range(n):
            with span("step"):
                t, t_nxt = t_curr[s], t_next[s]
                dt = t - t_nxt
                sigmas = t_to_sigma(t, t, t, sigma_cfg)
                with span("score"):
                    out = score_fn(poses, t)
                count("score_forwards")
                with span("update"):
                    scores = (_nan_guard(out.tr), _nan_guard(out.rot), _nan_guard(out.tor))
                    gs = [sig * scale for sig, scale in zip(sigmas, g_scale)]

                    zero_noise = sampler_cfg.no_random or (sampler_cfg.no_final_step_noise and s == n - 1)
                    scale = 0.0 if zero_noise else 1.0
                    zs = (noise.tr[s] * scale, noise.rot[s] * scale, noise.tor[s] * scale)

                    if sampler_cfg.ode:
                        perturbs = [0.5 * g**2 * dt * sc for g, sc in zip(gs, scores)]
                    else:
                        perturbs = [
                            _low_temp(sampler_cfg, i, sigmas[i], bounds[i][0], bounds[i][1],
                                      gs[i], dt, scores[i], zs[i])
                            for i in range(3)
                        ]
                    tr_perturb, rot_perturb, tor_perturb = perturbs
                    if no_torsion or nb == 0:
                        new = modify_conformer(poses, tr_perturb, rot_perturb, atom_mask=data.lig_mask)
                    else:
                        new = modify_conformer(
                            poses, tr_perturb, rot_perturb, tor_perturb * data.rot_mask,
                            data.rot_u, data.rot_v, data.mask_rotate, data.rot_mask,
                            atom_mask=data.lig_mask,
                        )
                step_done(s, poses, out)
            poses = new
    if return_trajectory:
        return poses, torch.stack(frames + [poses])
    return poses
