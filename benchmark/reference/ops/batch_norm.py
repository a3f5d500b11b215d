"""Per-irrep batch normalization (e3nn ``nn.BatchNorm``).

Port of ``diffdock_tpu/ops/batch_norm.py``: scalars (0e) are centred and
get a bias; every irrep is divided by the square root of its
component-wise mean square; affine scale per channel. In evaluation mode
the running statistics serve. In training mode (``module.training``) the
statistics come from the batch, over every valid row of every complex
(the JAX module's ``psum`` over the vmapped batch axis), and the running
statistics move by momentum 0.1. The module starts in evaluation mode
(the port serves unless a trainer calls ``.train()``).

With ``mesh`` set (``parallel/mesh.py:bind_batch_norms``, for a config
whose ``bn_axis_names`` holds the mesh's axis) the training branch also
sums the mean's numerator and denominator over the mesh's ranks, and then
the variance's: the JAX module's ``psum`` over ``"dp"``. The sum carries
the gradient, so the statistics, the running statistics and the gradient
do not depend on the number of ranks.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from benchmark.reference.ops.irreps import Irreps

MOMENTUM = 0.1  # running-statistics update of the training branch


class IrrepsBatchNorm(nn.Module):
    def __init__(self, irreps, eps: float = 1e-5):
        super().__init__()
        self.irreps = Irreps(irreps)
        self.eps = eps
        self.train(False)
        self.mesh = None  # a parallel.mesh.Mesh to sum the statistics over
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
        self.register_buffer("_scalar_cols", torch.tensor(
            [c for c, i in enumerate(mean_col) if i >= 0], dtype=torch.long), persistent=False)
        self.register_buffer("_comp_dim", torch.tensor(
            [float(e.ir.dim) for e in self.irreps for _ in range(e.mul)]), persistent=False)

    def _per_column(self, v: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
        """Scatter a per-scalar vector to components (0 where cols < 0)."""
        padded = torch.cat([v, v.new_zeros(1)])
        return padded[torch.where(cols < 0, v.shape[0], cols)]

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, ..., irreps.dim), B complexes; mask: (B, ...) validity of
        each row, used in training mode only (None: every row valid)."""
        if not self.training:
            mean = self._per_column(self.running_mean, self._mean_col)
            scale = ((self.running_var + self.eps) ** (-0.5) * self.weight)[self._feat_col]
            return (x - mean) * scale + self._per_column(self.bias, self._mean_col)

        B, D = x.shape[0], x.shape[-1]
        flat = x.reshape(B, -1, D)
        m = (torch.ones(flat.shape[:2], device=x.device) if mask is None
             else mask.expand(x.shape[:-1]).reshape(B, -1).to(x.dtype))
        # each complex counts at least one row, as in the JAX module
        den = torch.clamp(m.sum(1), min=1.0).sum()
        w = m[..., None]
        num = (flat[..., self._scalar_cols] * w).sum((0, 1))
        if self.mesh is not None:
            tot = self.mesh.all_reduce_sum(torch.cat([num, den.reshape(1).to(num.dtype)]))
            num, den = tot[:-1], tot[-1]
        batch_mean = num / den
        centred = flat - self._per_column(batch_mean, self._mean_col)
        sq = flat.new_zeros(flat.shape[:2] + (self.weight.shape[0],)).index_add_(
            2, self._feat_col, centred * centred) / self._comp_dim  # component mean per irrep
        num = (sq * w).sum((0, 1))
        if self.mesh is not None:
            num = self.mesh.all_reduce_sum(num)
        batch_var = num / den
        scale = ((batch_var + self.eps) ** (-0.5) * self.weight)[self._feat_col]
        out = centred * scale + self._per_column(self.bias, self._mean_col)
        with torch.no_grad():
            self.running_mean.mul_(1 - MOMENTUM).add_(MOMENTUM * batch_mean)
            self.running_var.mul_(1 - MOMENTUM).add_(MOMENTUM * batch_var)
        return out.reshape(x.shape)
