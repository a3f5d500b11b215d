"""Clebsch-Gordan tensor products over fixed irrep layouts.

Port of ``diffdock_tpu/ops/tensor_product.py``: e3nn's
``o3.FullyConnectedTensorProduct`` (its path layout and the coupled
tensors of the merged contraction) and ``o3.FullTensorProduct`` as
explicit contractions against precomputed real Wigner-3j constants, with
e3nn's 'component' irrep normalization and 'element' path normalization.

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

from benchmark.reference.ops.irreps import Irrep, Irreps
from benchmark.reference.ops.wigner import real_wigner_3j


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
    """Weighted TP with externally supplied per-example weights: its
    path layout and the coupled tensors the merged contraction
    (:func:`~benchmark.reference.ops.tp3_plain.tp3_plain`) weights, the
    weights (..., tp.weight_numel) from the edge MLP."""

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

    def coupled_class_merged(self, k: int, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        """The weight-independent coupled tensor for output entry ``k``,
        (..., fan_k * d3), the (fan, d3) axes merged (u-major, d-minor). Each path is one matmul of
        the edge harmonics against a static (sh_dim, d1*d3) matrix followed
        by an unrolled elementwise accumulation over the d1 input
        components — the same arithmetic as the JAX package, in the
        inputs' dtype: in bfloat16 each op rounds to bfloat16, the CG matrix
        is cast to it, and the matmul sums its exact float32 products in
        float32 before rounding (a bfloat16 matmul on the card may reduce in
        bfloat16)."""
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
