"""Equivariant linear layer over irreps (e3nn ``o3.Linear`` equivalent).

Port of ``diffdock_tpu/ops/linear.py``: channels of the same (l, p) mix
through a dense matrix applied identically to all m components; different
irrep types never mix; weights scaled by 1/sqrt(fan_in) at apply time;
output entries with no matching input type are zero. Parameters are named
``w_{k}`` like the flax module's.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from diffdock_tpu_torch.ops.irreps import Irreps


class IrrepsLinear(nn.Module):
    def __init__(self, irreps_in, irreps_out):
        super().__init__()
        self.irreps_in = Irreps(irreps_in)
        self.irreps_out = Irreps(irreps_out)
        self._by_type: Dict[Tuple[int, int], List[Tuple[slice, int, int]]] = {}
        for e, sl in zip(self.irreps_in, self.irreps_in.slices()):
            self._by_type.setdefault((e.ir.l, e.ir.p), []).append((sl, e.mul, e.ir.dim))
        for k, ek in enumerate(self.irreps_out):
            sources = self._by_type.get((ek.ir.l, ek.ir.p), [])
            if sources:
                mul_in = sum(mul for _, mul, _ in sources)
                self.register_parameter(f"w_{k}", nn.Parameter(torch.randn(mul_in, ek.mul)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = []
        for k, ek in enumerate(self.irreps_out):
            sources = self._by_type.get((ek.ir.l, ek.ir.p), [])
            if not sources:
                outs.append(x.new_zeros(x.shape[:-1] + (ek.dim,)))
                continue
            stacked = torch.cat(
                [x[..., sl].reshape(x.shape[:-1] + (mul, d)) for sl, mul, d in sources],
                dim=-2,
            )  # (..., mul_in_total, d)
            w = getattr(self, f"w_{k}")
            out = torch.einsum("...ud,uw->...wd", stacked, w) / np.sqrt(stacked.shape[-2])
            outs.append(out.reshape(out.shape[:-2] + (ek.dim,)))
        return torch.cat(outs, dim=-1)
