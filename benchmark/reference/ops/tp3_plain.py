"""The merged factored tensor-product contraction in plain PyTorch.

A frozen copy of the port's plain version (``ops/fused_tp3.py``:
``merged_coupled``, ``class_weights``, ``_scatter_classes``, ``_plain``),
without the kernel:

    tp3_plain(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias) -> (N, dim_out) f32

``x_nbr`` (N, K, dim_in1) gathered senders, ``edge_sh`` (N, K, dim_in2),
``h`` (N, K, H) hidden activations already scaled by ``mw``, ``mw`` (N, K)
mask*edge_weight, ``out_kernel`` (H, weight_numel) and ``out_bias``
(weight_numel,) the weight-generating FC's last layer: ``P = h_aug @
coupled``, then ``out = sum_h P[:, h] @ T3[h]`` with T3 block-diagonal
(H+1, F_tot, W_tot). The result is the neighbour sum of the messages.
"""

from __future__ import annotations

import math
from typing import List

import torch


def merged_coupled(tp, x_nbr: torch.Tensor, edge_sh: torch.Tensor):
    """(classes, coupled (N, K, F_tot)) over the live output classes;
    ``classes`` is ``tp.live_classes()``."""
    classes = tp.live_classes()
    parts = [tp.coupled_class_merged(k, x_nbr, edge_sh) for k, *_ in classes]
    return classes, torch.cat(parts, dim=-1)


def class_weights(tp, classes, out_kernel: torch.Tensor, out_bias: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> List[torch.Tensor]:
    """Per live class the (H+1, fan, mul) block: last-layer weights, then the
    bias as row H, with 1/sqrt(fan) folded in. In bfloat16 as the JAX model
    path rounds them: the weights to bfloat16, the product with the float32
    scale in float32, that to bfloat16 again."""
    H = out_kernel.shape[0]
    blocks = []
    for _k, offset, fan, _d3, mul in classes:
        t_k = out_kernel[:, offset : offset + fan * mul].reshape(H, fan, mul)
        b_k = out_bias[offset : offset + fan * mul].reshape(1, fan, mul)
        blk = torch.cat([t_k, b_k], dim=0).to(dtype).float() * (1.0 / math.sqrt(fan))
        blocks.append(blk.to(dtype))
    return blocks


def _scatter_classes(tp, classes, merged: torch.Tensor) -> torch.Tensor:
    """Re-insert zero blocks for empty classes (kernel/merged output is the
    live classes, contiguous, in e3nn order)."""
    if len(classes) == len(tp.irreps_out):
        return merged
    live = {k for k, *_ in classes}
    parts, w_off = [], 0
    for k, ek in enumerate(tp.irreps_out):
        if k in live:
            parts.append(merged[:, w_off : w_off + ek.dim])
            w_off += ek.dim
        else:
            parts.append(merged.new_zeros(merged.shape[0], ek.dim))
    return torch.cat(parts, dim=-1)


def tp3_plain(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias):
    N = x_nbr.shape[0]
    if not tp.live_classes():
        return x_nbr.new_zeros(N, tp.irreps_out.dim, dtype=torch.float32)
    classes, coupled = merged_coupled(tp, x_nbr, edge_sh)
    f_tot = coupled.shape[-1]
    w_tot = sum(mul * d3 for *_r, d3, mul in classes)
    h_aug = torch.cat([h, mw[..., None].to(h.dtype)], dim=-1)
    # float32 products of the operands' values (bfloat16 ones are exact),
    # float32 sums; in bfloat16 P is rounded to bfloat16, as in the JAX path
    p = torch.einsum("rkh,rkF->rhF", h_aug.float(), coupled.float())  # (N, H+1, F_tot)
    p = p.to(h.dtype).float()

    H1 = h_aug.shape[-1]
    t3 = coupled.new_zeros(H1, f_tot, w_tot, dtype=torch.float32)
    f_off = w_off = 0
    for (_k, _o, fan, d3, mul), blk in zip(
        classes, class_weights(tp, classes, out_kernel, out_bias, h.dtype)
    ):
        tt = tp.expand_weight_identity(blk.float(), d3).reshape(H1, fan * d3, mul * d3)
        t3[:, f_off : f_off + fan * d3, w_off : w_off + mul * d3] = tt
        f_off += fan * d3
        w_off += mul * d3
    merged = torch.einsum("rhF,hFW->rW", p, t3)
    return _scatter_classes(tp, classes, merged)
