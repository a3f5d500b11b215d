"""Tensor-product graph convolutions over dense neighbour blocks.

Port of ``diffdock_tpu/models/tpconv.py`` (factored path). Each receiver
set consumes dense neighbour blocks: gather senders -> per-edge hidden
activations -> factored tensor-product message summed over the neighbours
-> mean over all blocks -> batch norm -> residual.

Where the JAX package ``vmap``s over poses or complexes, every tensor here
carries a leading batch axis B (poses, complexes, or 1 for
pose-independent receptor work): a :class:`NeighborBlock` holds
(B, R, K, ...) edge tensors. In training mode (``module.training``) the
batch norm takes the receivers' validity mask and normalizes over every
valid row of the batch, and the edge MLPs apply dropout.

The merged contraction (``_tp_message_reduced``) is the plain one
(:func:`benchmark.reference.ops.tp3_plain.tp3_plain`), through
:func:`contract`.

This module is a frozen copy of the port's ``models/tpconv.py`` with the
kernel taken out (``reference_kernels`` is accepted and changes nothing),
and with only the factored, fully connected layer that both benchmark
configurations run (the port's per-edge and depthwise paths, its per-class
oracle and its multi-set layer are not copied).

A layer's ``dtype`` ("float32" or "bfloat16") is the JAX layer's compute
dtype: in bfloat16 the edge MLP, the gathered senders, the harmonics, the
coupling and both products run as the JAX layer runs them (see
``_tp_message_reduced``); the summed messages, the counts, the mean, the
batch norm and the residual stay float32.
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from benchmark.reference.models.encoders import FCBlock
from benchmark.reference.ops.batch_norm import IrrepsBatchNorm
from benchmark.reference.ops.tp3_plain import tp3_plain
from benchmark.reference.ops.irreps import Irreps
from benchmark.reference.ops.tensor_product import FullyConnectedTensorProduct


class NeighborBlock(NamedTuple):
    """One dense edge group targeting a common receiver set.

    sender_attr: (B, S, F_in) sender node features.
    nbr_idx: (B, R, K) int64 indices into the sender axis.
    nbr_mask: (B, R, K) bool edge validity.
    edge_attr: (B, R, K, E) scalar edge features.
    edge_sh: (B, R, K, sh_dim) spherical harmonics of the edge vectors.
    edge_weight: optional (B, R, K) smooth-edge weights.

    Tensors may be broadcast views (``expand``) along B.
    """

    sender_attr: torch.Tensor
    nbr_idx: torch.Tensor
    nbr_mask: torch.Tensor
    edge_attr: torch.Tensor
    edge_sh: torch.Tensor
    edge_weight: Optional[torch.Tensor] = None


def gather_nodes(attr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """attr (B, S, F), idx (B, R, K) -> (B, R, K, F) with
    out[b, r, k] = attr[b, idx[b, r, k]]."""
    B = max(attr.shape[0], idx.shape[0])
    attr = attr.expand((B,) + attr.shape[1:])
    idx = idx.expand((B,) + idx.shape[1:])
    batch = torch.arange(B, device=idx.device).view(B, 1, 1)
    return attr[batch, idx]


Contraction = Callable[..., torch.Tensor]

# Callables ``f(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias)`` that see
# every merged contraction before it runs; the benchmark's work census
# (``benchmark/work/census.py``) appends one while it counts a forward.
OBSERVERS: List[Callable[..., None]] = []
# The merged contraction every layer runs; the census swaps in a stand-in
# that records the call and skips the arithmetic.
CONTRACTION: List[Contraction] = [tp3_plain]


def contract(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias) -> torch.Tensor:
    """The merged contraction of a layer: :func:`tp3_plain` (or the census's
    stand-in), after every observer in :data:`OBSERVERS`."""
    for observe in OBSERVERS:
        observe(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias)
    return CONTRACTION[0](tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias)


def _tp_message_reduced(tp: FullyConnectedTensorProduct, fc: FCBlock, blk: NeighborBlock,
                        contraction: Contraction = tp3_plain, dtype: str = "float32"):
    """Factored message computation: reduce over neighbours BEFORE applying
    the weight-generating FC's last (linear) layer — an exact reassociation
    of fc + tp + sum (see the JAX package's docstring).

    ``dtype`` places the casts where the JAX function places them: the
    mask, edge weights, MLP input (and with it the MLP, see
    :meth:`FCBlock.hidden`), senders and harmonics in ``dtype``; the
    contraction takes them in that dtype and returns float32.

    Returns (summed_messages (B, R, out_dim) f32, valid_counts (B, R) f32).
    """
    cd = getattr(torch, dtype)
    mask = blk.nbr_mask.to(cd)
    mw = mask if blk.edge_weight is None else mask * blk.edge_weight.to(cd)
    h = fc.hidden(blk.edge_attr.to(cd)) * mw[..., None]
    x_nbr = gather_nodes(blk.sender_attr.to(cd), blk.nbr_idx)  # (B, R, K, F_in)
    # the block's tensors may broadcast along B (shared receptor features)
    lead = torch.broadcast_shapes(
        mw.shape[:-1], h.shape[:-2], x_nbr.shape[:-2], blk.edge_sh.shape[:-2]
    )  # (B, R)
    K = mw.shape[-1]
    counts = blk.nbr_mask.to(torch.float32).sum(dim=-1).expand(lead)

    rows = math.prod(lead)
    flat = lambda x: x.expand(lead + x.shape[-2:]).reshape(rows, K, x.shape[-1])
    h, x_nbr, edge_sh = flat(h), flat(x_nbr), flat(blk.edge_sh.to(cd))
    mw = mw.expand(lead + (K,)).reshape(rows, K)

    out = contraction(tp, x_nbr, edge_sh, h, mw, fc.out_kernel, fc.out_bias)
    return out.reshape(lead + (out.shape[-1],)), counts


def _combine_reduced(parts, eps: float = 1e-16) -> torch.Tensor:
    """Mean over several (sum, count) neighbour blocks per receiver."""
    total = sum(p[0] for p in parts)
    counts = sum(p[1] for p in parts)
    return total / torch.clamp(counts[..., None], min=eps)


def _residual_pad(out: torch.Tensor, attr: torch.Tensor) -> torch.Tensor:
    pad = out.shape[-1] - attr.shape[-1]
    return out + nn.functional.pad(attr, (0, pad))


class _ConvBase(nn.Module):
    def __init__(self, in_irreps, sh_irreps, out_irreps, n_edge_features: int,
                 hidden_features: Optional[int], tp_weights_layers: int,
                 batch_norm: bool, residual: bool, reference_kernels: bool,
                 dropout: float = 0.0, dtype: str = "float32"):
        super().__init__()
        self.dtype = dtype
        self.tp = FullyConnectedTensorProduct(in_irreps, sh_irreps, out_irreps)
        self.out_irreps = Irreps(out_irreps)
        self._fc_args = dict(
            in_dim=n_edge_features,
            hidden_dim=hidden_features or n_edge_features,
            out_dim=self.tp.weight_numel,
            layers=tp_weights_layers,
            dropout=dropout,
        )
        self.residual = residual
        self.bn = IrrepsBatchNorm(out_irreps) if batch_norm else None
        self.contraction = contract

    def _make_fc(self) -> FCBlock:
        return FCBlock(**self._fc_args)

    def _message(self, fc: FCBlock, blk: NeighborBlock):
        return _tp_message_reduced(self.tp, fc, blk, contraction=self.contraction,
                                   dtype=self.dtype)

    def _mean(self, fcs: Sequence[FCBlock], blocks: Sequence[NeighborBlock]) -> torch.Tensor:
        """The receivers' mean message over every valid edge of ``blocks``
        (block ``i`` through ``fcs[i]``)."""
        return _combine_reduced([self._message(fc, blk) for fc, blk in zip(fcs, blocks)])

    def _finish(self, out: torch.Tensor, receiver_attr: Optional[torch.Tensor],
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.bn is not None:
            out = self.bn(out, mask)
        if self.residual:
            if receiver_attr is None:
                raise ValueError("a residual conv needs the receiver features")
            out = _residual_pad(out, receiver_attr)
        return out


class TPConvLayer(_ConvBase):
    """One receiver set with one shared FC (flax name ``fc``)."""

    def __init__(self, in_irreps, sh_irreps, out_irreps, n_edge_features: int,
                 residual: bool = True, batch_norm: bool = True,
                 hidden_features: Optional[int] = None, tp_weights_layers: int = 2,
                 reference_kernels: bool = False, dropout: float = 0.0,
                 dtype: str = "float32"):
        super().__init__(in_irreps, sh_irreps, out_irreps, n_edge_features,
                         hidden_features, tp_weights_layers, batch_norm, residual,
                         reference_kernels, dropout, dtype)
        self.fc = self._make_fc()

    def forward(self, receiver_attr: Optional[torch.Tensor], blocks: Sequence[NeighborBlock],
                receiver_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``receiver_mask`` (B, R): the rows the training batch norm counts."""
        out = self._mean([self.fc] * len(blocks), blocks)
        return self._finish(out, receiver_attr, receiver_mask)


class JointTPConvLayer(_ConvBase):
    """Ligand+receptor joint conv with per-edge-type FC groups
    (0 = lig<-lig, 1 = lig<-rec, 2 = rec<-rec, 3 = rec<-lig; flax names
    ``fc_{g}``, or ``fc_shared`` without ``differentiate_convolutions``).
    With ``last_layer`` only ligand receivers get messages; batch norm still
    sees the zero receptor rows, as in the reference."""

    def __init__(self, in_irreps, sh_irreps, out_irreps, n_edge_features: int,
                 last_layer: bool = False, differentiate_convolutions: bool = True,
                 residual: bool = True, batch_norm: bool = True,
                 hidden_features: Optional[int] = None, tp_weights_layers: int = 2,
                 reference_kernels: bool = False, dropout: float = 0.0,
                 dtype: str = "float32"):
        super().__init__(in_irreps, sh_irreps, out_irreps, n_edge_features,
                         hidden_features, tp_weights_layers, batch_norm, residual,
                         reference_kernels, dropout, dtype)
        self.last_layer = last_layer
        self.differentiate_convolutions = differentiate_convolutions
        if differentiate_convolutions:
            for g in ((0, 1) if last_layer else (0, 1, 2, 3)):
                self.add_module(f"fc_{g}", self._make_fc())
        else:
            self.fc_shared = self._make_fc()

    def get_fc(self, g: int) -> FCBlock:
        return getattr(self, f"fc_{g}") if self.differentiate_convolutions else self.fc_shared

    def rec_messages(self, rec_blocks: Sequence[NeighborBlock], rec_groups: Sequence[int]):
        """Receptor factored message parts only (the per-step precompute of
        a merged layer)."""
        return [self._message(self.get_fc(g), blk) for g, blk in zip(rec_groups, rec_blocks)]

    def forward(self, lig_attr: torch.Tensor, rec_attr: torch.Tensor,
                lig_blocks: Sequence[NeighborBlock], lig_groups: Sequence[int],
                rec_blocks: Sequence[NeighborBlock], rec_groups: Sequence[int],
                rec_extra: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                lig_mask: Optional[torch.Tensor] = None, rec_mask: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """lig_attr (B, NL, F), rec_attr (B or 1, NR, F). ``rec_extra``: a
        precomputed (summed_messages, counts) receptor part folded into the
        receptor mean (the pose-independent layer-0 rec<-rec messages).
        ``lig_mask`` (B or 1, NL) and ``rec_mask`` (B or 1, NR): the rows the
        training batch norm counts, ligand and receptor together."""
        lig_out = self._mean([self.get_fc(g) for g in lig_groups], lig_blocks)
        B = lig_out.shape[0]
        if self.last_layer:
            if rec_blocks:
                raise ValueError("the last joint layer takes no receptor blocks")
            rec_out = lig_out.new_zeros((B,) + rec_attr.shape[1:-1] + (lig_out.shape[-1],))
        else:
            rec_parts = self.rec_messages(rec_blocks, rec_groups)
            if rec_extra is not None:
                rec_parts.append(rec_extra)
            rec_out = _combine_reduced(rec_parts).expand((B,) + rec_attr.shape[1:-1] + (lig_out.shape[-1],))

        nl = lig_attr.shape[1]
        out = torch.cat([lig_out, rec_out], dim=1)
        attr = torch.cat([lig_attr, rec_attr.expand((B,) + rec_attr.shape[1:])], dim=1)
        mask = None
        if lig_mask is not None:
            mask = torch.cat([lig_mask.expand(B, nl), rec_mask.expand(B, rec_out.shape[1])], dim=1)
        out = self._finish(out, attr, mask)
        return out[:, :nl], out[:, nl:]
