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

The merged contraction (``_tp_message_reduced``, ``merged=True``) goes
through the gen-3 Hopper kernel (:func:`diffdock_tpu_torch.ops.fused_tp3.fused_tp3`)
or, for layers built with ``reference_kernels=True``, through its plain
version. The per-class branch (``merged=False``) stays as the numeric
oracle, as in the JAX package.

A layer built with ``factored=False`` or ``depthwise=True`` takes the JAX
package's per-edge path instead (``_tp_message``): the edge MLP's full
output gives every edge its own weights, the tensor product runs per edge
and the messages are averaged over all blocks' valid edges
(:func:`~diffdock_tpu_torch.ops.segment.multi_group_mean`). The depthwise
layer's product is the 'uvu'
:class:`~diffdock_tpu_torch.ops.tensor_product.DepthwiseTensorProduct`,
followed by the equivariant linear ``linear_2`` before the batch norm. As
in the JAX package, no kernel runs on that path: its products are plain
PyTorch.

A layer's ``dtype`` ("float32" or "bfloat16") is the JAX layer's compute
dtype: in bfloat16 the edge MLP, the gathered senders, the harmonics, the
coupling and both products run as the JAX layer runs them (see
``_tp_message_reduced``); the summed messages, the counts, the mean, the
batch norm and the residual stay float32.

While a ``torch.profiler`` session runs, the merged contraction's call is a
``tp_contract`` range, so the rest of its block's range is the
contraction's torch side (gathers, the FC hidden layer, casts, expands and
reshapes); each neighbour block's message is a range named by its edge
type: the joint layer's (``lig<-lig``, ``lig<-rec``, ``rec<-rec``,
``rec<-lig``), or a layer's ``range_name``. Without a profiler each costs
one check (``utils/profiling.py:profiler_on``).
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from diffdock_tpu_torch.models.encoders import FCBlock
from diffdock_tpu_torch.ops.batch_norm import IrrepsBatchNorm
from diffdock_tpu_torch.ops.fused_tp3 import fused_tp3, fused_tp3_reference
from diffdock_tpu_torch.ops.irreps import Irreps
from diffdock_tpu_torch.ops.linear import IrrepsLinear
from diffdock_tpu_torch.ops.segment import multi_group_mean
from diffdock_tpu_torch.ops.tensor_product import DepthwiseTensorProduct, FullyConnectedTensorProduct
from diffdock_tpu_torch.utils import profiling
from diffdock_tpu_torch.utils.profiling import profiler_on


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
# the joint layer's FC groups by edge type (receiver<-sender)
EDGE_TYPES = ("lig<-lig", "lig<-rec", "rec<-rec", "rec<-lig")


def _tp_message(tp, fc: FCBlock, blk: NeighborBlock, dtype: str = "float32") -> torch.Tensor:
    """Per-edge messages (B, R, K, D): the edge MLP's weights for every
    edge, ``tp`` of the gathered senders and the harmonics. As in the JAX
    function, only the MLP's hidden layers run in ``dtype``; its last layer,
    the edge weights and the product are float32."""
    h = fc.hidden(blk.edge_attr.to(getattr(torch, dtype)))
    w = h.float() @ fc.out_kernel + fc.out_bias
    if blk.edge_weight is not None:
        w = w * blk.edge_weight[..., None]
    return tp(gather_nodes(blk.sender_attr, blk.nbr_idx), blk.edge_sh, w)


def _tp_message_reduced(tp: FullyConnectedTensorProduct, fc: FCBlock, blk: NeighborBlock,
                        merged: bool = True, contraction: Contraction = fused_tp3,
                        dtype: str = "float32"):
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

    if merged:
        if profiler_on():
            with profiling.record_function("tp_contract"):
                out = contraction(tp, x_nbr, edge_sh, h, mw, fc.out_kernel, fc.out_bias)
        else:
            out = contraction(tp, x_nbr, edge_sh, h, mw, fc.out_kernel, fc.out_bias)
        return out.reshape(lead + (out.shape[-1],)), counts

    # per-class reference path (the merged layout's numeric oracle): float32
    # products of the operands' values, P and the weights in ``dtype``
    H = h.shape[-1]
    rnd = lambda x: x.to(cd).float()
    outs = []
    for k, ((offset, fan, mul), ek) in enumerate(zip(tp.weight_slices(), tp.irreps_out)):
        if fan == 0:
            outs.append(h.new_zeros(rows, ek.dim, dtype=torch.float32))
            continue
        d3 = ek.ir.dim
        coupled = tp.coupled_class_merged(k, x_nbr, edge_sh).float()  # (rows, K, fan*d3)
        p_h = rnd(torch.einsum("rkh,rkF->rhF", h.float(), coupled))
        p_b = rnd(torch.einsum("rk,rkF->rF", mw.float(), coupled))
        t_k = fc.out_kernel[:, offset : offset + fan * mul].reshape(H, fan, mul)
        b_k = fc.out_bias[offset : offset + fan * mul].reshape(fan, mul)
        tt = tp.expand_weight_identity(rnd(t_k), d3)  # (H*fan*d3, mul*d3)
        bb = tp.expand_bias_identity(rnd(b_k), d3)  # (fan*d3, mul*d3)
        out_k = (p_h.reshape(rows, H * fan * d3) @ tt + p_b @ bb) / math.sqrt(fan)
        outs.append(out_k)
    out = torch.cat(outs, dim=-1)
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
                 dropout: float = 0.0, dtype: str = "float32", factored: bool = True,
                 depthwise: bool = False):
        super().__init__()
        self.dtype = dtype
        # the merged contraction (the kernel's) serves the factored,
        # fully connected layer only
        self.merged = factored and not depthwise
        if depthwise:
            self.tp = DepthwiseTensorProduct(in_irreps, sh_irreps, out_irreps)
            self.linear_2 = IrrepsLinear(str(self.tp.irreps_mid), out_irreps)
            self.mid_dim = self.tp.irreps_mid.dim
        else:
            self.tp = FullyConnectedTensorProduct(in_irreps, sh_irreps, out_irreps)
            self.linear_2 = None
            self.mid_dim = Irreps(out_irreps).dim
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
        self.contraction = fused_tp3_reference if reference_kernels else fused_tp3
        # the profiler range of each block's message (set by the model that
        # names this layer's edge type; the joint layer names its groups)
        self.range_name: Optional[str] = None

    def _make_fc(self) -> FCBlock:
        return FCBlock(**self._fc_args)

    def _message(self, fc: FCBlock, blk: NeighborBlock):
        return _tp_message_reduced(self.tp, fc, blk, contraction=self.contraction,
                                   dtype=self.dtype)

    def _block_message(self, fc: FCBlock, blk: NeighborBlock, name: Optional[str]):
        """One block's message: its (sum, count) on the merged path, its
        per-edge messages otherwise; in a profiler range ``name`` while a
        profiler runs."""
        if name is not None and profiler_on():
            with profiling.record_function(name):
                return self._block_message(fc, blk, None)
        if self.merged:
            return self._message(fc, blk)
        return _tp_message(self.tp, fc, blk, self.dtype)

    def _mean(self, fcs: Sequence[FCBlock], blocks: Sequence[NeighborBlock],
              names: Optional[Sequence[str]] = None) -> torch.Tensor:
        """The receivers' mean message over every valid edge of ``blocks``
        (block ``i`` through ``fcs[i]``, its range named ``names[i]``, or
        :attr:`range_name`): merged contractions, or per-edge messages on
        the per-edge path."""
        names = names or [self.range_name] * len(blocks)
        msgs = [self._block_message(fc, blk, name) for fc, blk, name in zip(fcs, blocks, names)]
        if self.merged:
            return _combine_reduced(msgs)
        return multi_group_mean(msgs, [blk.nbr_mask for blk in blocks])

    def _finish(self, out: torch.Tensor, receiver_attr: Optional[torch.Tensor],
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.linear_2 is not None:
            out = self.linear_2(out)
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
                 dtype: str = "float32", factored: bool = True, depthwise: bool = False):
        super().__init__(in_irreps, sh_irreps, out_irreps, n_edge_features,
                         hidden_features, tp_weights_layers, batch_norm, residual,
                         reference_kernels, dropout, dtype, factored, depthwise)
        self.fc = self._make_fc()

    def forward(self, receiver_attr: Optional[torch.Tensor], blocks: Sequence[NeighborBlock],
                receiver_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``receiver_mask`` (B, R): the rows the training batch norm counts."""
        out = self._mean([self.fc] * len(blocks), blocks)
        return self._finish(out, receiver_attr, receiver_mask)


class MultiTPConvLayer(_ConvBase):
    """N receiver sets with per-edge-type FC groups and one joint batch norm
    (the JAX package's ``MultiTPConvLayer``, the all-atom model's layer
    over ligand, residues and atoms with up to nine edge groups). ``groups``
    names the FC groups the layer has (flax ``fc_{g}``, or one
    ``fc_shared`` without ``differentiate_convolutions``). A receiver set
    with no blocks (the receptor sets of the last layer) gets zero messages
    but still passes through the joint batch norm, as the reference's
    concatenated node array does."""

    def __init__(self, in_irreps, sh_irreps, out_irreps, n_edge_features: int,
                 groups: Sequence[int], differentiate_convolutions: bool = True,
                 residual: bool = True, batch_norm: bool = True,
                 hidden_features: Optional[int] = None, tp_weights_layers: int = 2,
                 reference_kernels: bool = False, dropout: float = 0.0,
                 dtype: str = "float32", factored: bool = True, depthwise: bool = False):
        super().__init__(in_irreps, sh_irreps, out_irreps, n_edge_features,
                         hidden_features, tp_weights_layers, batch_norm, residual,
                         reference_kernels, dropout, dtype, factored, depthwise)
        self.differentiate_convolutions = differentiate_convolutions
        if differentiate_convolutions:
            for g in groups:
                self.add_module(f"fc_{g}", self._make_fc())
        else:
            self.fc_shared = self._make_fc()

    def get_fc(self, g: int) -> FCBlock:
        return getattr(self, f"fc_{g}") if self.differentiate_convolutions else self.fc_shared

    def forward(self, receiver_sets) -> List[torch.Tensor]:
        """``receiver_sets``: (attr (B or 1, R, F), blocks, groups, mask
        (B or 1, R)) per set; returns each set's new features (B, R, F_out),
        B the widest batch among the sets and their messages. The masks are
        the rows the training batch norm counts."""
        outs = [self._mean([self.get_fc(g) for g in groups], blocks)
                if blocks else None for _attr, blocks, groups, _mask in receiver_sets]
        B = max([o.shape[0] for o in outs if o is not None]
                + [attr.shape[0] for attr, *_ in receiver_sets])
        D = self.mid_dim
        sizes = [attr.shape[1] for attr, *_ in receiver_sets]
        out = torch.cat([
            o.expand(B, R, D) if o is not None else attr.new_zeros(B, R, D)
            for o, (attr, *_), R in zip(outs, receiver_sets, sizes)], dim=1)
        attr = torch.cat([a.expand((B,) + a.shape[1:]) for a, *_ in receiver_sets], dim=1)
        mask = torch.cat([m.expand(B, R) for (*_, m), R in zip(receiver_sets, sizes)], dim=1)
        out = self._finish(out, attr, mask)
        return list(torch.split(out, sizes, dim=1))


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
                 dtype: str = "float32", factored: bool = True, depthwise: bool = False):
        super().__init__(in_irreps, sh_irreps, out_irreps, n_edge_features,
                         hidden_features, tp_weights_layers, batch_norm, residual,
                         reference_kernels, dropout, dtype, factored, depthwise)
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
        if not self.merged:
            raise ValueError("precomputed receptor messages need the factored, fully connected layer")
        return [self._block_message(self.get_fc(g), blk, EDGE_TYPES[g])
                for g, blk in zip(rec_groups, rec_blocks)]

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
        lig_out = self._mean([self.get_fc(g) for g in lig_groups], lig_blocks,
                             [EDGE_TYPES[g] for g in lig_groups])
        B = lig_out.shape[0]
        if self.last_layer:
            if rec_blocks:
                raise ValueError("the last joint layer takes no receptor blocks")
            rec_out = lig_out.new_zeros((B,) + rec_attr.shape[1:-1] + (lig_out.shape[-1],))
        elif not self.merged:
            if rec_extra is not None:
                raise ValueError("rec_extra needs the factored, fully connected layer")
            rec_out = self._mean([self.get_fc(g) for g in rec_groups], rec_blocks,
                                 [EDGE_TYPES[g] for g in rec_groups])
            rec_out = rec_out.expand((B,) + rec_attr.shape[1:-1] + (lig_out.shape[-1],))
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
