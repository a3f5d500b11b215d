"""Branch-free rotation conversions (port of ``diffdock_tpu/geometry/rotations.py``).

Conventions: quaternions are (w, x, y, z) with real part first; axis-angle
vectors encode the angle as their norm; matrices act on column vectors.
"""

from __future__ import annotations

import torch

_EPS = 1e-6


def _sin_half_over_angle(angles: torch.Tensor) -> torch.Tensor:
    """sin(angle/2)/angle with a 2nd-order Taylor fallback near zero."""
    small = torch.abs(angles) < _EPS
    safe = torch.where(small, torch.ones_like(angles), angles)
    exact = torch.sin(0.5 * safe) / safe
    taylor = 0.5 - (angles * angles) / 48.0
    return torch.where(small, taylor, exact)


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 4) unit quaternion (w first)."""
    angles = torch.linalg.norm(axis_angle, dim=-1, keepdim=True)
    return torch.cat(
        [torch.cos(0.5 * angles), axis_angle * _sin_half_over_angle(angles)], dim=-1
    )


def quaternion_to_matrix(quaternions: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternion (w first, not necessarily unit) -> (..., 3, 3)."""
    r, i, j, k = torch.unbind(quaternions, dim=-1)
    two_s = 2.0 / torch.sum(quaternions * quaternions, dim=-1)
    o = torch.stack(
        [
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ],
        dim=-1,
    )
    return o.reshape(quaternions.shape[:-1] + (3, 3))


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3) rotation matrix."""
    return quaternion_to_matrix(axis_angle_to_quaternion(axis_angle))


def random_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """Haar-uniform rotations from (..., 4) standard-normal draws ``q``
    (normalized-Gaussian quaternion construction)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return quaternion_to_matrix(q)
