"""Per-irrep batch normalization, evaluation mode (e3nn ``nn.BatchNorm``).

Port of ``diffdock_tpu/ops/batch_norm.py`` for inference: scalars (0e) are
centred by the running mean and get a bias; every irrep is divided by the
square root of its running component-wise mean square; affine scale per
channel. The port serves only, so batch statistics are never computed;
the arithmetic order matches the JAX module's eval branch.
"""

from __future__ import annotations

import torch
from torch import nn

from diffdock_tpu_torch.ops.irreps import Irreps


class IrrepsBatchNorm(nn.Module):
    def __init__(self, irreps, eps: float = 1e-5):
        super().__init__()
        self.irreps = Irreps(irreps)
        self.eps = eps
        num_features = self.irreps.num_irreps
        num_scalar = sum(e.mul for e in self.irreps if e.ir.l == 0 and e.ir.p == 1)
        self.register_buffer("running_mean", torch.zeros(num_scalar))
        self.register_buffer("running_var", torch.ones(num_features))
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_scalar))

        # column maps: feature / scalar index of every component (-1: none)
        feat_col, mean_col = [], []
        i_feat = i_mean = 0
        for e in self.irreps:
            is_scalar = e.ir.l == 0 and e.ir.p == 1
            for u in range(e.mul):
                feat_col += [i_feat + u] * e.ir.dim
                mean_col += [i_mean + u if is_scalar else -1] * e.ir.dim
            i_feat += e.mul
            if is_scalar:
                i_mean += e.mul
        self.register_buffer("_feat_col", torch.tensor(feat_col, dtype=torch.long), persistent=False)
        self.register_buffer("_mean_col", torch.tensor(mean_col, dtype=torch.long), persistent=False)

    def _per_column(self, v: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
        """Scatter a per-scalar vector to components (0 where cols < 0)."""
        padded = torch.cat([v, v.new_zeros(1)])
        return padded[torch.where(cols < 0, v.shape[0], cols)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., irreps.dim)."""
        mean = self._per_column(self.running_mean, self._mean_col)
        scale = ((self.running_var + self.eps) ** (-0.5) * self.weight)[self._feat_col]
        return (x - mean) * scale + self._per_column(self.bias, self._mean_col)
