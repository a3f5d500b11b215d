"""Clebsch-Gordan tensor products over fixed irrep layouts.

Port of ``diffdock_tpu/ops/tensor_product.py``: e3nn's
``o3.FullyConnectedTensorProduct``, the depthwise 'uvu' product of the
depthwise convolution and ``o3.FullTensorProduct`` as explicit
contractions against precomputed real Wigner-3j constants, with e3nn's
'component' irrep normalization and 'element' path normalization.

The path metadata is numpy, built once per layer; the constants move to a
tensor's device on first use and are cached there, so a step on the card
copies nothing from the host.

Weight layout: flat, grouped by output entry (in irreps_out order), within a
group ordered by (in1 entry, in2 entry); each block is (fan_in_k, mul_out_k)
row-major — identical to the JAX package, so converted weights line up.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from diffdock_tpu_torch.ops.irreps import Irrep, Irreps
from diffdock_tpu_torch.ops.wigner import real_wigner_3j


class _Path(NamedTuple):
    i: int  # index into irreps_in1
    j: int  # index into irreps_in2
    cg: np.ndarray  # (d1, d2, d3) including component normalization


def _reshape_entry(x: torch.Tensor, irreps: Irreps, idx: int, sl: slice) -> torch.Tensor:
    e = irreps[idx]
    return x[..., sl].reshape(x.shape[:-1] + (e.mul, e.ir.dim))


class _ConstCache:
    """Per-(name, device, dtype) tensor copies of numpy constants. They are
    made as normal tensors even inside ``torch.inference_mode`` (a dock), so
    that a later forward under autograd (training) can save them."""

    def __init__(self):
        self._cache: Dict[Tuple[str, torch.device, torch.dtype], torch.Tensor] = {}

    def get(self, name: str, array: np.ndarray, like: torch.Tensor) -> torch.Tensor:
        key = (name, like.device, like.dtype)
        t = self._cache.get(key)
        if t is None:
            with torch.inference_mode(False):
                t = torch.as_tensor(array, dtype=like.dtype).to(like.device)
            self._cache[key] = t
        return t


class FullyConnectedTensorProduct:
    """Weighted TP with externally supplied per-example weights.

    ``tp(x1, x2, weights)`` with weights (..., tp.weight_numel).
    """

    def __init__(self, irreps_in1, irreps_in2, irreps_out):
        self.irreps_in1 = Irreps(irreps_in1)
        self.irreps_in2 = Irreps(irreps_in2)
        self.irreps_out = Irreps(irreps_out)

        self._sl1 = self.irreps_in1.slices()
        self._sl2 = self.irreps_in2.slices()
        self._consts = _ConstCache()

        self.paths: List[List[_Path]] = []
        self.fan_in: List[int] = []
        for ek in self.irreps_out:
            paths_k: List[_Path] = []
            fan = 0
            for i, e1 in enumerate(self.irreps_in1):
                for j, e2 in enumerate(self.irreps_in2):
                    if ek.ir in e1.ir * e2.ir:
                        cg = real_wigner_3j(e1.ir.l, e2.ir.l, ek.ir.l)
                        cg = cg * math.sqrt(ek.ir.dim)  # component normalization
                        paths_k.append(_Path(i, j, cg.astype(np.float32)))
                        fan += e1.mul * e2.mul
            self.paths.append(paths_k)
            self.fan_in.append(fan)

        self.weight_numel = sum(
            fan * ek.mul for fan, ek in zip(self.fan_in, self.irreps_out)
        )

    def weight_slices(self):
        """Per-output-entry (offset, fan, mul) into the flat weight vector."""
        out, offset = [], 0
        for k, ek in enumerate(self.irreps_out):
            fan = self.fan_in[k]
            out.append((offset, fan, ek.mul))
            offset += fan * ek.mul
        return out

    def live_classes(self):
        """[(k, offset, fan, d3, mul)] for the output entries with paths."""
        return [
            (k, offset, fan, ek.ir.dim, mul)
            for k, ((offset, fan, mul), ek) in enumerate(
                zip(self.weight_slices(), self.irreps_out)
            )
            if fan > 0
        ]

    def _cg(self, k: int, n: int, p: _Path, like: torch.Tensor) -> torch.Tensor:
        return self._consts.get(f"cg{k}_{n}", p.cg, like)

    def coupled_class(self, k: int, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        """The weight-independent coupled tensor for output entry ``k``:
        (..., fan_k, d3)."""
        ek = self.irreps_out[k]
        segs = []
        for n, p in enumerate(self.paths[k]):
            a = _reshape_entry(x1, self.irreps_in1, p.i, self._sl1[p.i])
            b = _reshape_entry(x2, self.irreps_in2, p.j, self._sl2[p.j])
            seg = torch.einsum("...ui,...vj,ijk->...uvk", a, b, self._cg(k, n, p, x1))
            segs.append(seg.reshape(seg.shape[:-3] + (-1, ek.ir.dim)))
        return torch.cat(segs, dim=-2)

    def coupled_class_merged(
        self, k: int, x1: torch.Tensor, x2: torch.Tensor, float_last: bool = False
    ) -> torch.Tensor:
        """Like :meth:`coupled_class` but returns (..., fan_k * d3) with the
        (fan, d3) axes merged (u-major, d-minor). Each path is one matmul of
        the edge harmonics against a static (sh_dim, d1*d3) matrix followed
        by an unrolled elementwise accumulation over the d1 input
        components — the same arithmetic as the JAX package, in the
        inputs' dtype: in bfloat16 each op rounds to bfloat16, the CG matrix
        is cast to it, and the matmul sums its exact float32 products in
        float32 before rounding (a bfloat16 matmul on the card may reduce in
        bfloat16). ``float_last``: the last step of each chain (its last sum,
        or the product of a one-term chain) in float32, and a float32
        result (gen 1's bfloat16 Pallas body under XLA, for a class of one
        path and d3 = 1)."""
        ek = self.irreps_out[k]
        d3 = ek.ir.dim
        segs = []
        for n, p in enumerate(self.paths[k]):
            e1 = self.irreps_in1[p.i]
            a = _reshape_entry(x1, self.irreps_in1, p.i, self._sl1[p.i])
            sh = x2[..., self._sl2[p.j]]  # (..., J): edge sh entries have mul 1
            d1, d2 = e1.ir.dim, sh.shape[-1]
            cgm = self._consts.get(
                f"cgm{k}_{n}", p.cg.transpose(1, 0, 2).reshape(d2, d1 * d3), x1
            )
            W = (sh.float() @ cgm.float()).to(x1.dtype)  # (..., d1*d3)
            C = None
            for i_idx in range(d1):
                a_i, w_i = a[..., :, i_idx, None], W[..., None, i_idx * d3 : (i_idx + 1) * d3]
                if float_last and i_idx == d1 - 1:
                    # a one-term chain's product, else the last sum of the
                    # rounded product
                    C = a_i.float() * w_i.float() if C is None else C.float() + (a_i * w_i).float()
                    continue
                term = a_i * w_i
                C = term if C is None else C + term
            segs.append(C.reshape(C.shape[:-2] + (e1.mul * d3,)))
        return torch.cat(segs, dim=-1)

    @staticmethod
    def expand_weight_identity(t: torch.Tensor, d3: int) -> torch.Tensor:
        """(H, fan, mul) weights -> (H * fan * d3, mul * d3) with an identity
        over the d3 components."""
        H, fan, mul = t.shape
        eye = torch.eye(d3, dtype=t.dtype, device=t.device)
        tt = torch.einsum("huw,de->hudwe", t, eye)
        return tt.reshape(H * fan * d3, mul * d3)

    @staticmethod
    def expand_bias_identity(b: torch.Tensor, d3: int) -> torch.Tensor:
        """(fan, mul) -> (fan * d3, mul * d3), identity over d3."""
        fan, mul = b.shape
        eye = torch.eye(d3, dtype=b.dtype, device=b.device)
        bb = torch.einsum("uw,de->udwe", b, eye)
        return bb.reshape(fan * d3, mul * d3)

    def __call__(
        self, x1: torch.Tensor, x2: torch.Tensor, weights: torch.Tensor
    ) -> torch.Tensor:
        """x1 (..., dim_in1), x2 (..., dim_in2), weights (..., weight_numel)
        -> (..., dim_out). Leading dims must broadcast elementwise."""
        lead = torch.broadcast_shapes(x1.shape[:-1], x2.shape[:-1], weights.shape[:-1])
        outs = []
        for k, ((offset, fan, mul), ek) in enumerate(
            zip(self.weight_slices(), self.irreps_out)
        ):
            if fan == 0:
                outs.append(x1.new_zeros(lead + (ek.dim,)))
                continue
            coupled = self.coupled_class(k, x1, x2)  # (..., fan, d3)
            w = weights[..., offset : offset + fan * mul]
            w = w.reshape(w.shape[:-1] + (fan, mul)) / math.sqrt(fan)
            out_k = torch.einsum("...uk,...uw->...wk", coupled, w)
            outs.append(out_k.reshape(out_k.shape[:-2] + (ek.dim,)))
        return torch.cat(outs, dim=-1)


class DepthwiseTensorProduct:
    """'uvu' depthwise TP (the depthwise convolution's): each input channel
    couples with the edge harmonics on its own, one weight per channel per
    path; channels mix afterwards in an
    :class:`~diffdock_tpu_torch.ops.linear.IrrepsLinear`.

    ``irreps_out`` only selects which output irrep types are kept; the
    output layout is ``irreps_mid``: per path the multiplicity of its in1
    entry, the paths sorted stably by output irrep (l, then parity), as
    e3nn's ``irreps_mid.sort()`` orders them. The weights are laid out path
    by path in that order, one per channel.
    """

    def __init__(self, irreps_in1, irreps_in2, irreps_out):
        self.irreps_in1 = Irreps(irreps_in1)
        self.irreps_in2 = Irreps(irreps_in2)
        keep = {(e.ir.l, e.ir.p) for e in Irreps(irreps_out)}
        self._sl1 = self.irreps_in1.slices()
        self._sl2 = self.irreps_in2.slices()
        self._consts = _ConstCache()
        paths = []  # (i, j, ir3, cg)
        for i, e1 in enumerate(self.irreps_in1):
            for j, e2 in enumerate(self.irreps_in2):
                for ir3 in e1.ir * e2.ir:
                    if (ir3.l, ir3.p) in keep:
                        cg = real_wigner_3j(e1.ir.l, e2.ir.l, ir3.l) * math.sqrt(ir3.dim)
                        paths.append((i, j, ir3, cg.astype(np.float32)))
        order = sorted(range(len(paths)), key=lambda k: (paths[k][2].l, paths[k][2].p, k))
        self.paths = [paths[k] for k in order]
        self.irreps_mid = Irreps([(self.irreps_in1[i].mul, ir3) for i, _, ir3, _ in self.paths])
        self.weight_numel = sum(self.irreps_in1[i].mul for i, _, _, _ in self.paths)

    def __call__(self, x1: torch.Tensor, x2: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        """x1 (..., dim_in1), x2 (..., dim_in2), weights (..., weight_numel)
        -> (..., irreps_mid.dim)."""
        outs, off = [], 0
        for n, (i, j, ir3, cg) in enumerate(self.paths):
            mul = self.irreps_in1[i].mul
            a = _reshape_entry(x1, self.irreps_in1, i, self._sl1[i])
            b = _reshape_entry(x2, self.irreps_in2, j, self._sl2[j])
            # 'uvu': the harmonics' entries have multiplicity 1
            seg = torch.einsum("...ui,...vj,ijk->...uk", a, b, self._consts.get(f"cg{n}", cg, x1))
            seg = seg * weights[..., off : off + mul, None]
            off += mul
            outs.append(seg.reshape(seg.shape[:-2] + (mul * ir3.dim,)))
        return torch.cat(outs, dim=-1)


class FullTensorProduct:
    """Unweighted full TP: every coupling, multiplicities multiply.

    Output entries are ordered (in1-major, in2, then l_out), exposed via
    ``irreps_out`` — the JAX package's canonical order.
    """

    def __init__(self, irreps_in1, irreps_in2):
        self.irreps_in1 = Irreps(irreps_in1)
        self.irreps_in2 = Irreps(irreps_in2)
        self._sl1 = self.irreps_in1.slices()
        self._sl2 = self.irreps_in2.slices()
        self._consts = _ConstCache()

        out_entries = []
        self._prods: List[Tuple[int, int, Irrep, np.ndarray]] = []
        for i, e1 in enumerate(self.irreps_in1):
            for j, e2 in enumerate(self.irreps_in2):
                for ir3 in e1.ir * e2.ir:
                    cg = real_wigner_3j(e1.ir.l, e2.ir.l, ir3.l) * math.sqrt(ir3.dim)
                    self._prods.append((i, j, ir3, cg.astype(np.float32)))
                    out_entries.append((e1.mul * e2.mul, ir3))
        self.irreps_out = Irreps(out_entries)

    def __call__(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        lead = torch.broadcast_shapes(x1.shape[:-1], x2.shape[:-1])
        x1 = x1.expand(lead + x1.shape[-1:])
        x2 = x2.expand(lead + x2.shape[-1:])
        outs = []
        for n, (i, j, _ir3, cg) in enumerate(self._prods):
            a = _reshape_entry(x1, self.irreps_in1, i, self._sl1[i])
            b = _reshape_entry(x2, self.irreps_in2, j, self._sl2[j])
            seg = torch.einsum(
                "...ui,...vj,ijk->...uvk", a, b, self._consts.get(f"cg{n}", cg, x1)
            )
            outs.append(seg.reshape(seg.shape[:-3] + (-1,)))
        return torch.cat(outs, dim=-1)
