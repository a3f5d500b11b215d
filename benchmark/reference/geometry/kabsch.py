"""Closed-form 3x3 Kabsch alignment via Horn's quaternion method.

Port of ``diffdock_tpu/geometry/kabsch.py``: the optimal proper rotation is
the eigenvector of Horn's symmetric 4x4 matrix with the largest eigenvalue,
so there is no SVD and no reflection special case. Masked (padded) rows are
excluded from centroids and the correlation matrix.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from benchmark.reference.geometry.rotations import quaternion_to_matrix


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor], dim: int) -> torch.Tensor:
    if mask is None:
        return torch.mean(x, dim=dim, keepdim=True)
    w = mask[..., None].to(x.dtype)
    denom = torch.clamp(torch.sum(w, dim=dim, keepdim=True), min=1.0)
    return torch.sum(x * w, dim=dim, keepdim=True) / denom


def kabsch_rotation(
    a: torch.Tensor, b: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, t) with ``a @ R.T + t`` the least-squares fit of ``b`` among
    proper rigid motions. a, b: (..., N, 3); mask: (..., N)."""
    centroid_a = _masked_mean(a, mask, dim=-2)
    centroid_b = _masked_mean(b, mask, dim=-2)
    am = a - centroid_a
    bm = b - centroid_b
    if mask is not None:
        w = mask[..., None].to(a.dtype)
        am = am * w
        bm = bm * w

    h = torch.einsum("...ni,...nj->...ij", am, bm)
    sxx, sxy, sxz = h[..., 0, 0], h[..., 0, 1], h[..., 0, 2]
    syx, syy, syz = h[..., 1, 0], h[..., 1, 1], h[..., 1, 2]
    szx, szy, szz = h[..., 2, 0], h[..., 2, 1], h[..., 2, 2]

    k00 = sxx + syy + szz
    k01 = syz - szy
    k02 = szx - sxz
    k03 = sxy - syx
    k11 = sxx - syy - szz
    k12 = sxy + syx
    k13 = szx + sxz
    k22 = -sxx + syy - szz
    k23 = syz + szy
    k33 = -sxx - syy + szz
    k = torch.stack(
        [
            torch.stack([k00, k01, k02, k03], dim=-1),
            torch.stack([k01, k11, k12, k13], dim=-1),
            torch.stack([k02, k12, k22, k23], dim=-1),
            torch.stack([k03, k13, k23, k33], dim=-1),
        ],
        dim=-2,
    )
    _, eigvecs = torch.linalg.eigh(k)  # ascending eigenvalues
    rot = quaternion_to_matrix(eigvecs[..., :, -1])
    t = centroid_b[..., 0, :] - torch.einsum("...ij,...j->...i", rot, centroid_a[..., 0, :])
    return rot, t


def kabsch_align(
    a: torch.Tensor, b: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Return ``a`` rigidly aligned onto ``b``: ``a @ R.T + t``."""
    rot, t = kabsch_rotation(a, b, mask=mask)
    return torch.einsum("...ni,...ji->...nj", a, rot) + t[..., None, :]
