"""Noise schedules for the tr/rot/tor diffusion components.

Port of ``diffdock_tpu/diffusion/schedules.py``: geometric sigma
interpolation and the inference time grid (Beta-distribution ppf,
host-side, static per run).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SigmaConfig:
    """Sigma ranges for the three manifold components (reference training
    defaults)."""

    tr_sigma_min: float = 0.1
    tr_sigma_max: float = 30.0
    rot_sigma_min: float = 0.1
    rot_sigma_max: float = 1.65
    tor_sigma_min: float = 0.0314
    tor_sigma_max: float = 3.14
    schedule_type: str = "exponential"
    schedule_k: float = 10.0
    schedule_m: float = 0.4


def t_to_sigma(t_tr, t_rot, t_tor, cfg: SigmaConfig) -> Tuple:
    """Map diffusion times in [0, 1] (tensors or floats) to (tr, rot, tor)
    sigmas."""
    tr = cfg.tr_sigma_min ** (1.0 - t_tr) * cfg.tr_sigma_max ** t_tr
    rot = cfg.rot_sigma_min ** (1.0 - t_rot) * cfg.rot_sigma_max ** t_rot
    tor = cfg.tor_sigma_min ** (1.0 - t_tor) * cfg.tor_sigma_max ** t_tor
    return tr, rot, tor


def get_t_schedule(
    sigma_schedule: str,
    inference_steps: int,
    inf_sched_alpha: float = 1.0,
    inf_sched_beta: float = 1.0,
    t_max: float = 1.0,
) -> np.ndarray:
    """Inference time grid (host-side; the grid is static per run)."""
    if sigma_schedule == "expbeta":
        from scipy.stats import beta as beta_dist

        lin_max = beta_dist.cdf(t_max, a=inf_sched_alpha, b=inf_sched_beta)
        c = np.linspace(lin_max, 0, inference_steps + 1)[:-1]
        return beta_dist.ppf(c, a=inf_sched_alpha, b=inf_sched_beta)
    raise ValueError(f"unknown sigma_schedule {sigma_schedule!r}")
