"""Masked dense reductions over the neighbour axis.

Port of ``diffdock_tpu/ops/segment.py``: with fixed-capacity neighbour
lists every scatter of the reference becomes a masked mean over the
neighbour axis.
"""

from __future__ import annotations

from typing import Sequence

import torch


def masked_mean_pool(
    x: torch.Tensor, mask: torch.Tensor, dim: int = -2, eps: float = 1e-16
) -> torch.Tensor:
    """Mean of ``x`` over ``dim`` counting only ``mask``-valid entries."""
    w = mask.to(x.dtype).unsqueeze(-1)
    num = torch.sum(x * w, dim=dim)
    den = torch.clamp(torch.sum(w, dim=dim), min=eps)
    return num / den


def multi_group_mean(
    parts: Sequence[torch.Tensor],
    masks: Sequence[torch.Tensor],
    eps: float = 1e-16,
) -> torch.Tensor:
    """Mean over several neighbour blocks targeting the same receivers:
    receivers divide by their total valid degree over all groups."""
    num = den = None
    for part, mask in zip(parts, masks):
        w = mask.to(part.dtype).unsqueeze(-1)
        s = torch.sum(part * w, dim=-2)
        c = torch.sum(w, dim=-2)
        num = s if num is None else num + s
        den = c if den is None else den + c
    return num / torch.clamp(den, min=eps)
