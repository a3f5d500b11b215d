"""Isotropic Gaussian on SO(3): score-norm tables on the device.

Port of ``diffdock_tpu/diffusion/so3.py``. The tables are generated with
the same numpy code (two (N_EPS, L) @ (L, X_N) matmuls in float64), so they
are bit-identical to the JAX package's; lookups replicate its
nearest-log-grid rounding in float32. The training draws
(:meth:`SO3Tables.sample_vec`) take their random numbers as arguments.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from benchmark.reference.diffusion.tables import cached_tables


@dataclasses.dataclass(frozen=True)
class SO3Config:
    """Grid parameters; defaults match reference ``utils/so3.py:6-7``."""

    min_eps: float = 0.0005
    max_eps: float = 4.0
    n_eps: int = 2000
    x_n: int = 2000
    l_max: int = 2000  # series truncation L


def _generate_tables(cfg: SO3Config) -> Tuple[np.ndarray, ...]:
    """Compute (omegas, cdf_vals, score_norms, exp_score_norms) in float64."""
    omegas = np.linspace(0, np.pi, cfg.x_n + 1)[1:]
    eps_grid = 10 ** np.linspace(
        np.log10(cfg.min_eps), np.log10(cfg.max_eps), cfg.n_eps
    )

    l_vec = np.arange(cfg.l_max, dtype=np.float64)
    # coeff[e, l] = (2l+1) exp(-l(l+1) eps^2 / 2)
    coeff = (2 * l_vec + 1) * np.exp(
        -l_vec * (l_vec + 1) * (eps_grid[:, None] ** 2) / 2
    )
    hi = np.sin(np.outer(l_vec + 0.5, omegas))  # (L, X)
    lo = np.sin(omegas / 2)  # (X,)
    sinterm = hi / lo  # (L, X)

    exp_vals = coeff @ sinterm  # (N_EPS, X)
    pdf_vals = exp_vals * (1 - np.cos(omegas)) / np.pi
    cdf_vals = np.cumsum(pdf_vals, axis=1) / cfg.x_n * np.pi

    dhi = (l_vec[:, None] + 0.5) * np.cos(np.outer(l_vec + 0.5, omegas))
    dlo = 0.5 * np.cos(omegas / 2)
    dterm = (lo * dhi - hi * dlo) / lo**2  # (L, X)
    dsigma = coeff @ dterm
    score_norms = dsigma / exp_vals

    # E[score^2] over the pdf; where the series' density vanishes the score
    # is 0/0 or x/0 (two columns of 185 rows with eps in 0.07-0.35 at the
    # default grid), and those terms, of weight ~0, are left out: the JAX
    # package's table is NaN or inf in those rows (ROADMAP, facts of the
    # reference), so a training draw there gave a NaN loss. Rows without
    # such a term are bit-identical to the JAX package's.
    with np.errstate(invalid="ignore", over="ignore"):
        terms = score_norms**2 * pdf_vals
        exp_score_norms = np.sqrt(
            np.sum(np.where(np.isfinite(terms), terms, 0.0), axis=1)
            / np.sum(pdf_vals, axis=1)
            / np.pi
        )
        # Where the true density is below the series' rounding (1e-12 of the
        # row's peak: the tail of a narrow density), exp_vals and dsigma are
        # both rounding noise, and their ratio squared, times the noise's
        # weight, can dominate the sum. Such a row lies above the small-eps
        # limit sqrt(3 / pi) / eps, which the true value never exceeds: at
        # the default grid rows with eps in 0.030-0.072 come out up to 1e66
        # times it (the v1.0 score model's rot_sigma_min of 0.03 reads
        # them). Those rows leave the terms below the floor out; every other
        # row stays as it was.
        floor = 1e-12 * np.abs(exp_vals).max(axis=1, keepdims=True)
        kept = np.isfinite(terms) & (exp_vals > floor)
        clean = np.sqrt(np.sum(np.where(kept, terms, 0.0), axis=1) / np.sum(pdf_vals, axis=1) / np.pi)
        noisy = exp_score_norms > 1.1 * np.sqrt(3.0 / np.pi) / eps_grid
        exp_score_norms = np.where(noisy, clean, exp_score_norms)

    # the truncated series cannot resolve eps < ~10/L: use the exact
    # small-eps limit (IGSO3 -> 3D Gaussian) there, as the JAX package does
    bad = eps_grid < 10.0 / cfg.l_max
    if bad.any():
        eps_b = eps_grid[bad][:, None]
        pdf_b = omegas**2 / eps_b**3 * np.exp(-(omegas**2) / (2 * eps_b**2))
        cdf_b = np.cumsum(pdf_b, axis=1)
        cdf_b /= cdf_b[:, -1:]
        cdf_vals[bad] = cdf_b
        score_norms[bad] = -omegas / eps_b**2
        exp_score_norms[bad] = np.sqrt(3.0 / np.pi) / eps_b[:, 0]

    return omegas, cdf_vals, score_norms, exp_score_norms


@dataclasses.dataclass(frozen=True)
class SO3Tables:
    cfg: SO3Config
    omegas: torch.Tensor  # (X,)
    cdf_vals: torch.Tensor  # (N_EPS, X)
    score_norms: torch.Tensor  # (N_EPS, X)
    exp_score_norms: torch.Tensor  # (N_EPS,)

    def _eps_idx(self, eps: torch.Tensor) -> torch.Tensor:
        """Nearest log-grid index (reference ``utils/so3.py:76-78``)."""
        c = self.cfg
        idx = (
            (torch.log10(eps) - float(np.log10(c.min_eps)))
            / float(np.log10(c.max_eps) - np.log10(c.min_eps))
            * c.n_eps
        )
        return torch.clamp(torch.round(idx), 0, c.n_eps - 1).long()

    def sample_vec(self, eps: torch.Tensor, u: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
        """IGSO3 rotations as axis-angle vectors (reference
        ``utils/so3.py:67-78``): the angle by inverse cdf of the uniform
        ``u`` (eps's shape), the axis the normal ``direction`` (eps's shape
        + (3,)) normalized. Returns (..., 3)."""
        rows = self.cdf_vals[self._eps_idx(eps)]  # (..., X)
        omega = interp(u.reshape(-1), rows.reshape(-1, rows.shape[-1]), self.omegas)
        direction = direction / torch.linalg.norm(direction, dim=-1, keepdim=True)
        return direction * omega.reshape(eps.shape)[..., None]

    def score_vec(self, eps: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
        """Score of IGSO3 at the rotation ``vec`` (axis-angle), (..., 3) ->
        (..., 3) (reference ``utils/so3.py:81-86``)."""
        om = torch.linalg.norm(vec, dim=-1)
        rows = self.score_norms[self._eps_idx(eps)]
        score = interp(om.reshape(-1), self.omegas, rows.reshape(-1, rows.shape[-1]))
        return score.reshape(om.shape)[..., None] * vec / torch.clamp(om[..., None], min=1e-12)

    def score_norm(self, eps: torch.Tensor) -> torch.Tensor:
        """E[||score||^2]^{1/2} lookup (reference ``utils/so3.py:89-93``)."""
        return self.exp_score_norms[self._eps_idx(eps)]


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp`` row by row: x (M,), xp and fp (M, X) or (X,) with xp
    ascending. Between knots the linear interpolant of the segment that
    ``searchsorted(side='right')`` finds (so on a flat run of xp, the value
    at its last knot); below xp[0] fp[0], above xp[-1] fp[-1], as in JAX."""
    M, X = x.shape[0], max(xp.shape[-1], fp.shape[-1])
    xp, fp = xp.expand(M, X), fp.expand(M, X)
    i = torch.clamp(torch.searchsorted(xp.contiguous(), x[:, None].contiguous(), right=True),
                    1, X - 1)
    xp0, xp1 = torch.gather(xp, 1, i - 1)[:, 0], torch.gather(xp, 1, i)[:, 0]
    fp0, fp1 = torch.gather(fp, 1, i - 1)[:, 0], torch.gather(fp, 1, i)[:, 0]
    dx = xp1 - xp0
    dx0 = torch.abs(dx) <= _INTERP_EPS
    f = torch.where(dx0, fp0, fp0 + ((x - xp0) / torch.where(dx0, torch.ones_like(dx), dx)) * (fp1 - fp0))
    f = torch.where(x < xp[:, 0], fp[:, 0], f)
    return torch.where(x > xp[:, -1], fp[:, -1], f)


# jnp.interp's flat-segment threshold for float32 knots
_INTERP_EPS = float(np.spacing(np.finfo(np.float32).eps))


def _so3_arrays(cfg: SO3Config):
    def generate():
        omegas, cdf, sn, esn = _generate_tables(cfg)
        return dict(omegas=omegas, cdf_vals=cdf, score_norms=sn, exp_score_norms=esn)

    # "so3_v3": the E[score^2] rows without the JAX package's NaNs and
    # without its rounding-noise spikes
    return cached_tables("so3_v3", cfg, generate)


@functools.lru_cache(maxsize=4)
def get_so3_tables(cfg: SO3Config = SO3Config(), device="cuda") -> SO3Tables:
    """Build (or load cached) tables and put them on ``device`` as float32."""
    a = _so3_arrays(cfg)
    # normal tensors even when first asked for inside torch.inference_mode
    # (a dock), so that a training forward can save what it derives from them
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32).to(device)
    with torch.inference_mode(False):
        return SO3Tables(cfg, f32(a["omegas"]), f32(a["cdf_vals"]),
                         f32(a["score_norms"]), f32(a["exp_score_norms"]))
