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


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 4) quaternion (w first).

    Branch-free best-conditioned-candidate method (reference
    ``utils/geometry.py:100-160``): all four candidate quaternions, the one
    of the largest |q| component selected by a one-hot, then w >= 0."""
    batch = matrix.shape[:-2]
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = torch.unbind(matrix.reshape(batch + (9,)), dim=-1)
    q_abs_sq = torch.stack(
        [
            1.0 + m00 + m11 + m22,
            1.0 + m00 - m11 - m22,
            1.0 - m00 + m11 - m22,
            1.0 - m00 - m11 + m22,
        ],
        dim=-1,
    )
    q_abs = torch.sqrt(torch.clamp(q_abs_sq, min=0.0))
    quat_by_rijk = torch.stack(
        [
            torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
            torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1),
            torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1),
            torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1),
        ],
        dim=-2,
    )
    quat_candidates = quat_by_rijk / (2.0 * torch.clamp(q_abs[..., None], min=0.1))
    best = torch.nn.functional.one_hot(torch.argmax(q_abs, dim=-1), 4).to(matrix.dtype)
    quat = torch.sum(quat_candidates * best[..., None], dim=-2)
    # canonicalize to w >= 0 so the derived axis-angle has angle <= pi
    return quat * torch.where(quat[..., :1] < 0, -1.0, 1.0)


def quaternion_to_axis_angle(quaternions: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternion (w first) -> (..., 3) axis-angle."""
    norms = torch.linalg.norm(quaternions[..., 1:], dim=-1, keepdim=True)
    angles = 2.0 * torch.atan2(norms, quaternions[..., :1])
    return quaternions[..., 1:] / _sin_half_over_angle(angles)


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 3) axis-angle."""
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))


def random_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """Haar-uniform rotations from (..., 4) standard-normal draws ``q``
    (normalized-Gaussian quaternion construction)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return quaternion_to_matrix(q)
