"""Conformer update on the product manifold T(3) x SO(3) x SO(2)^m.

Port of ``diffdock_tpu/geometry/rigid.py:modify_conformer``, batched over
poses: rigid rotation about the ligand center, translation, sequential
torsion rotations, then a Kabsch re-alignment of the torsioned conformer
onto the rigidly-moved one (reference ``utils/diffusion_utils.py:35-78``).
"""

from __future__ import annotations

from typing import Optional

import torch

from benchmark.reference.geometry.kabsch import kabsch_align
from benchmark.reference.geometry.rotations import axis_angle_to_matrix
from benchmark.reference.geometry.torsion import apply_torsion_updates


def _masked_center(pos: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return torch.mean(pos, dim=-2, keepdim=True)
    w = mask[..., None].to(pos.dtype)
    return torch.sum(pos * w, dim=-2, keepdim=True) / torch.clamp(
        torch.sum(w, dim=-2, keepdim=True), min=1.0
    )


def modify_conformer(
    pos: torch.Tensor,
    tr_update: torch.Tensor,
    rot_update: torch.Tensor,
    torsion_updates: Optional[torch.Tensor] = None,
    bond_u: Optional[torch.Tensor] = None,
    bond_v: Optional[torch.Tensor] = None,
    mask_rotate: Optional[torch.Tensor] = None,
    bond_mask: Optional[torch.Tensor] = None,
    atom_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Apply (tr, rot, torsions) to a batch of ligand poses.

    pos: (P, N, 3); tr_update, rot_update: (P, 3); torsion_updates:
    optional (P, B); bond_u / bond_v / mask_rotate / bond_mask as in
    :func:`apply_torsion_updates`; atom_mask: optional (N,). Padded atom
    slots follow the rigid motion and never affect real atoms.
    """
    center = _masked_center(pos, atom_mask)
    rot_mat = axis_angle_to_matrix(rot_update)
    rigid_new_pos = (
        torch.einsum("pni,pji->pnj", pos - center, rot_mat)
        + tr_update[:, None, :] + center
    )
    if torsion_updates is None:
        return rigid_new_pos
    flexible_new_pos = apply_torsion_updates(
        rigid_new_pos, bond_u, bond_v, mask_rotate, torsion_updates, bond_mask
    )
    return kabsch_align(flexible_new_pos, rigid_new_pos, mask=atom_mask)
