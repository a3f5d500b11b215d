"""Gen-2 factored TP contraction: the Hopper kernel, its plain version and its gradient.

Port of ``diffdock_tpu/ops/pallas_tpconv2.py``. The wrapper takes the JAX
signature

    f(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias) -> (N, dim_out) f32

(see :mod:`diffdock_tpu_torch.ops.fused_tp3` for the arguments) and
returns the neighbour SUM of the tensor-product messages in e3nn layout.
As gen 3's float32 kernel does, the kernel builds the Clebsch-Gordan
coupling itself, from the raw neighbour features and edge harmonics, here
from operands its host side packs first:

* the host side packs the inputs as the TPU kernel's ``_forward_pallas``
  does: neighbour features in ``[path][i][u]`` order
  (:func:`pack_neighbors`), the hidden activations plus the
  mask*edge_weight bias row H, padded to He = roundup(H+1, 16) rows, one
  (J, cols) CG matrix for every path (:func:`build_specs2`) and per class
  the (He, fan, mul) weights with the bias as row H; the hidden rows stay
  last, ``h_aug`` (N, K, He), where the TPU kernel transposes them to
  (N, He, K): the card's loads want each neighbour's rows contiguous;
* ``csrc/factored_tp2.cu`` (which replaces the TPU kernel
  ``pallas_tpconv2.py:_kernel``; its body, shared with gen 1, is
  ``csrc/factored_tp.cuh``) computes the CG weights ``sh @ CG``, the
  coupled columns, ``P = h_aug^T @ coupled`` and ``sum_h P[h] @ T[h] / sqrt(fan)``
  per receiver and class, the two products on the tensor cores in 3xTF32
  (float32 accuracy), and writes the e3nn layout directly. Its blocking is
  mirrored by :func:`tile_plan`, which the wrapper checks against the
  kernel's own plan before each launch.

:func:`factored_tp_reference` is the plain version of gen 2 AND gen 1: the
per-class einsum path of ``pallas_tpconv2.py:_forward_xla``. On a CPU tensor
the wrappers run it; on a CUDA tensor they launch their kernel or raise.
The gradient of :func:`factored_tp2` (a ``torch.autograd.Function``)
differentiates the plain version, as the TPU kernel's custom VJP
differentiates ``_forward_xla``.

**The bfloat16 mode.** Both TPU kernels compute in bfloat16 when ``x_nbr``
is bfloat16 (``pallas_tpconv2.py:219``, ``pallas_tpconv.py:140-198``); so
do the wrappers here, on a Hopper kernel of their own,
``csrc/factored_tp_bf16.cu`` (TMA-fed ``wgmma``, the coupling built in
shared memory; its operands from :func:`prepare_bf16`, its plan mirrored by
:func:`bf16_plan`, its weights packed by :func:`pack_bf16_weights`), with
:func:`factored_tp_bf16_reference` as its plain version. It rounds where
the Pallas bodies round, not where the float32 einsum path would: the CG
weights ``sh @ CG`` (float32 sums) rounded to bfloat16; the coupling's
chain ``sum_i a_i * w`` in bfloat16 arithmetic, each product and each
partial sum rounded, in the order i = 0, 1, ... (held against the TPU
kernels in interpret mode: a chain summed in float32 and rounded once
lands 4e-3 of scale away, the per-operation rounding 3e-7), except in gen
1 where a class has one path and d3 = 1: there the chain is P's operand
itself, with no concatenation between, and XLA leaves its last step (the
last sum, or the product of a one-term chain) in float32, so the plain
version does too (rounding it lands 1.5e-3 to 3e-3 of scale away from the
interpret run, leaving it 2e-7; gen 2's body rounds it); ``P =
h_aug^T coupled`` summed in float32 over the neighbours and rounded to
bfloat16; the weights (the bias as row H) cast to bfloat16 once; the weight
product summed in float32 and scaled by ``1/sqrt(fan)``. The output is
float32 in e3nn layout. Gen 2 casts ``edge_sh``, ``h`` and ``mw`` to
bfloat16 itself (``pallas_tpconv2.py:220-225``); gen 1 leaves them in the
caller's dtypes, so a float32 ``h`` or ``mw`` makes ``P``'s products
float32 ones (JAX's promotion) before its rounding (the kernel takes them
as three bfloat16 parts each, an exact sum). No gradient runs through the
bfloat16 mode: no JAX entry point trains in bfloat16.

An output class with no path (``fan == 0``) makes the JAX functions fail
(``_forward_xla`` finds nothing to concatenate, the kernels divide by
sqrt(0)); the port refuses such a TP with a ``ValueError`` naming the class.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from diffdock_tpu_torch.ops.fused_tp3 import (
    LaunchCounts,
    PlainVJP,
    _pad_rows,
    _rows_of_8,
    swizzled_weight_index,
)
from diffdock_tpu_torch.utils import build

_SOURCES = ("factored_tp2.cu", "factored_tp_bf16.cu")

counts = LaunchCounts("factored_tp2", "factored_tp2_bf16", "factored_tp_reference")


def check_no_empty_class(tp, name: str) -> None:
    """Raise ``ValueError`` if an output class of ``tp`` has no path."""
    for k, (fan, ek) in enumerate(zip(tp.fan_in, tp.irreps_out)):
        if fan == 0:
            raise ValueError(
                f"{name}: output class {k} ({ek}) of {tp.irreps_in1} x {tp.irreps_in2} -> "
                f"{tp.irreps_out} has no path (fan 0); the factored kernels take only "
                "TPs whose every output class has a path"
            )


def factored_tp_reference(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias):
    """Plain PyTorch version (``pallas_tpconv2.py:_forward_xla``): per class
    ``p_h = h^T coupled``, ``p_b = mw^T coupled``, then the d3-identity
    expanded weights and bias, divided by sqrt(fan)."""
    check_no_empty_class(tp, "factored_tp_reference")
    counts.add("factored_tp_reference")
    H = h.shape[-1]
    outs = []
    for k, ((offset, fan, mul), ek) in enumerate(zip(tp.weight_slices(), tp.irreps_out)):
        d3 = ek.ir.dim
        coupled = tp.coupled_class_merged(k, x_nbr, edge_sh)  # (N, K, fan*d3)
        p_h = torch.einsum("rkh,rkF->rhF", h, coupled)
        p_b = torch.einsum("rk,rkF->rF", mw.to(h.dtype), coupled)
        t_k = out_kernel[:, offset : offset + fan * mul].reshape(H, fan, mul)
        b_k = out_bias[offset : offset + fan * mul].reshape(fan, mul)
        tt = tp.expand_weight_identity(t_k, d3)
        bb = tp.expand_bias_identity(b_k, d3)
        out_k = (p_h.reshape(p_h.shape[0], H * fan * d3) @ tt + p_b @ bb) / math.sqrt(fan)
        outs.append(out_k)
    return torch.cat(outs, dim=-1)


def factored_tp_bf16_reference(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias, gen: int = 2):
    """Plain PyTorch version of the bfloat16 mode of gen ``gen`` (2 or 1),
    with the TPU kernels' rounding points (see the module docstring):
    ``x_nbr`` bfloat16; gen 2 casts ``edge_sh``, ``h`` and ``mw`` to
    bfloat16, gen 1 takes them as they come. (N, dim_out) float32."""
    check_no_empty_class(tp, "factored_tp_bf16_reference")
    if x_nbr.dtype != torch.bfloat16:
        raise TypeError(f"factored_tp_bf16_reference: x_nbr must be bfloat16, got {x_nbr.dtype}")
    counts.add("factored_tp_reference")
    dt = torch.bfloat16
    if gen == 2:
        edge_sh, h, mw = edge_sh.to(dt), h.to(dt), mw.to(dt)
    N, H = x_nbr.shape[0], h.shape[-1]
    outs = []
    for k, ((offset, fan, mul), ek) in enumerate(zip(tp.weight_slices(), tp.irreps_out)):
        d3 = ek.ir.dim
        # the CG weights rounded to bfloat16, then the chain in bfloat16
        # arithmetic, cg cast to x_nbr's dtype (both Pallas bodies' coupling;
        # gen 1's last step in float32 where the class is one path of d3 = 1)
        float_last = gen == 1 and len(tp.paths[k]) == 1 and d3 == 1
        coupled = tp.coupled_class_merged(k, x_nbr, edge_sh, float_last).float()  # (N, K, fan*d3)
        p_h = torch.einsum("rkh,rkF->rhF", h.float(), coupled).to(dt).float()
        p_b = torch.einsum("rk,rkF->rF", mw.float(), coupled).to(dt).float()
        t_k = out_kernel[:, offset : offset + fan * mul].reshape(H, fan, mul).to(dt).float()
        b_k = out_bias[offset : offset + fan * mul].reshape(fan, mul).to(dt).float()
        out = (torch.einsum("rhud,huw->rwd", p_h.reshape(N, H, fan, d3), t_k)
               + torch.einsum("rud,uw->rwd", p_b.reshape(N, fan, d3), b_k)) * (1.0 / math.sqrt(fan))
        outs.append(out.reshape(N, mul * d3))
    return torch.cat(outs, dim=-1)


# ----------------------------------------------------------------------
# host-side packing (``build_specs2``, ``pack_neighbors2``)
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PathSpec2:
    xp_start: int  # slice start into the packed [path][i][u] input
    mul: int  # u
    d1: int  # i
    cg_col: int  # column offset into the (J, cols) CG matrix


@dataclasses.dataclass(frozen=True)
class ClassSpec2:
    fan: int
    d3: int
    mul_out: int
    out_off: int  # offset of the class in the e3nn output
    paths: Tuple[PathSpec2, ...]


def build_specs2(tp):
    """(specs, cg_full (J, cols), packed input width, output width): one CG
    matrix whose row j is the absolute spherical-harmonic index, so one
    ``sh @ cg_full`` gives every path's coupling weights."""
    J = tp.irreps_in2.dim
    specs: List[ClassSpec2] = []
    blocks = []
    col = xp_off = out_off = 0
    for pk, fan, ek in zip(tp.paths, tp.fan_in, tp.irreps_out):
        d3 = ek.ir.dim
        paths = []
        for p in pk:
            e1 = tp.irreps_in1[p.i]
            cgm = p.cg.transpose(1, 0, 2).reshape(p.cg.shape[1], -1)  # (d2, d1*d3)
            paths.append(PathSpec2(xp_start=xp_off, mul=e1.mul, d1=e1.ir.dim, cg_col=col))
            blocks.append((tp._sl2[p.j].start, cgm))
            col += cgm.shape[1]
            xp_off += e1.ir.dim * e1.mul
        specs.append(ClassSpec2(fan=fan, d3=d3, mul_out=ek.mul, out_off=out_off,
                                paths=tuple(paths)))
        out_off += ek.mul * d3
    cg_full = np.zeros((J, max(col, 1)), np.float32)
    c = 0
    for row, b in blocks:
        cg_full[row : row + b.shape[0], c : c + b.shape[1]] = b
        c += b.shape[1]
    return tuple(specs), cg_full, xp_off, out_off


def pack_neighbors(tp, x_nbr: torch.Tensor) -> torch.Tensor:
    """(N, K, F_in) -> (N, K, sum_p d1*u): each path's features in [i][u]
    order (i outer), as ``pack_neighbors2`` (and gen 1's ``pack_neighbors``)."""
    parts = []
    for pk in tp.paths:
        for p in pk:
            e1 = tp.irreps_in1[p.i]
            a = x_nbr[..., tp._sl1[p.i]]
            a = a.reshape(a.shape[:-1] + (e1.mul, e1.ir.dim))
            parts.append(a.transpose(-1, -2).reshape(a.shape[:-2] + (e1.ir.dim * e1.mul,)))
    return torch.cat(parts, dim=-1)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def class_table(specs, He: int) -> Tuple[np.ndarray, np.ndarray]:
    """The kernel's tables: per class (fan, d3, mul, out_off, col0, ncols,
    path0, n_paths, w_off) and per path (u_off, mul, d1, xp_start, col),
    ``col`` relative to the class's first CG column, int32."""
    cls_rows, path_rows = [], []
    w_off = 0
    for s in specs:
        col0 = s.paths[0].cg_col
        ncols = sum(p.d1 * s.d3 for p in s.paths)
        cls_rows.append((s.fan, s.d3, s.mul_out, s.out_off, col0, ncols, len(path_rows),
                         len(s.paths), w_off))
        u_off = 0
        for p in s.paths:
            path_rows.append((u_off, p.mul, p.d1, p.xp_start, p.cg_col - col0))
            u_off += p.mul
        w_off += He * s.fan * s.mul_out
    return (np.asarray(cls_rows, np.int32).reshape(-1, 9),
            np.asarray(path_rows, np.int32).reshape(-1, 5))


def prepare(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias):
    """The torch side of the kernel call, packed as ``_forward_pallas``
    packs it but for the hidden rows' layout: (xp, edge_sh, h_aug (N, K,
    He), H+1, cg_full, packed (He, fan, mul) weights, class rows, path
    rows). Hidden rows of ``h_aug`` past H+1 are zero padding, which the
    kernel does not walk. A bfloat16 ``x_nbr`` selects the bfloat16 kernel:
    :func:`prepare_bf16` with ``gen=2``."""
    if x_nbr.dtype == torch.bfloat16:
        return prepare_bf16(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias, gen=2)
    check_no_empty_class(tp, "factored_tp2")
    specs, cg_full, _xp_dim, _out_dim = build_specs2(tp)
    H = h.shape[-1]
    He = _round_up(H + 1, 16)
    xp = pack_neighbors(tp, x_nbr).contiguous()
    h_aug = torch.cat([h, mw[..., None].to(h.dtype)], dim=-1)
    h_aug = torch.nn.functional.pad(h_aug, (0, He - H - 1)).contiguous()  # (N, K, He)
    blocks = []
    off = 0
    for s in specs:
        t_k = out_kernel[:, off : off + s.fan * s.mul_out].reshape(H, s.fan, s.mul_out)
        b_k = out_bias[off : off + s.fan * s.mul_out].reshape(1, s.fan, s.mul_out)
        pad = t_k.new_zeros(He - H - 1, s.fan, s.mul_out)
        blocks.append(torch.cat([t_k, b_k, pad], dim=0).reshape(-1))
        off += s.fan * s.mul_out
    weights = torch.cat(blocks).contiguous()
    cg = tp._consts.get(f"gen2_cg_full_{cg_full.shape[0]}", cg_full, x_nbr)
    cls_rows, path_rows = class_table(specs, He)
    return xp, edge_sh.contiguous(), h_aug, H + 1, cg, weights, cls_rows, path_rows


# ----------------------------------------------------------------------
# the kernels' blocking (csrc/factored_tp.cuh, gens 2 and 1)
# ----------------------------------------------------------------------

# 16 receivers per block; P column slices of whole u groups, at most 24
# columns, xp_cap packed input floats and 64 CG-weight columns per
# neighbour; hidden rows in the fewest groups of at most 80 (whole 16-row
# tiles)
TILE_ROWS = 16
SLICE_COLS = 24
MAX_GROUP_ROWS = 80
MAX_XP = 96
MAX_W = 64
MAX_SH = 16
MAX_CLASSES = 16
# shared memory: a block's floats, its tables at their largest, the ring
# of each warp (2 stages of 8 neighbours) and its B tile row stride
SMEM_FLOATS = 232448 // 4
TABLE_FLOATS = 4 * SLICE_COLS + 4 * MAX_W + MAX_XP + MAX_SH * MAX_W
STAGES, STAGE_K, B_STRIDE = 2, 8, SLICE_COLS + 16


def xp_cap(hidden_rows: int, J: int) -> int:
    """The most packed input floats per neighbour a slice may take: MAX_XP,
    or what each warp's share of shared memory holds beside its ring's
    hidden rows and harmonics, its B tile and MAX_W CG-weight columns (the
    launcher's ``xp_cap``)."""
    per_warp = (SMEM_FLOATS - TABLE_FLOATS) // TILE_ROWS
    room = (per_warp - STAGE_K * B_STRIDE - STAGE_K * MAX_W
            - STAGES * STAGE_K * (hidden_rows + 8 + J))
    return min(MAX_XP, room // (STAGES * STAGE_K))


class Slice(NamedTuple):
    """The paths ``pa..pb`` (indices into the class's path rows) that a
    column slice touches, its packed input floats per neighbour ``xs`` and
    its CG-weight columns ``nc`` from the class's column ``cw0``."""

    pa: int
    pb: int
    xs: int
    cw0: int
    nc: int


def path_span(path, u0: int, nu: int) -> Tuple[int, int]:
    """(first u, count) of path row ``path`` inside the slice [u0, u0+nu)."""
    ua = max(u0, int(path[0]))
    return ua, min(u0 + nu, int(path[0]) + int(path[1])) - ua


def slice_of(paths: np.ndarray, d3: int, u0: int, nu: int) -> Slice:
    """The kernel's ``slice_of``: ``paths`` are one class's path rows
    (u_off, mul, d1, xp_start, col, ...)."""
    live = [p for p, row in enumerate(paths)
            if row[0] < u0 + nu and row[0] + row[1] > u0]
    pa, pb = live[0], live[-1]
    xs = sum(int(paths[p][2]) * path_span(paths[p], u0, nu)[1] for p in live)
    cw0 = int(paths[pa][4])
    return Slice(pa, pb, xs, cw0, int(paths[pb][4]) + int(paths[pb][2]) * d3 - cw0)


class TilePlan(NamedTuple):
    """How the kernel cuts one call: ``hidden_rows`` per group, ``n_groups``
    groups, per class ``us`` u per column slice and ``n_slices`` slices,
    ``s_max`` the most slices of a class, ``xs_max`` / ``nc_max`` the most
    packed input floats / CG-weight columns of a slice; partial outputs go
    to ``n_groups * s_max`` scratch parts unless that is 1."""

    hidden_rows: int
    n_groups: int
    us: Tuple[int, ...]
    n_slices: Tuple[int, ...]
    s_max: int
    xs_max: int
    nc_max: int

    def scratch_floats(self, n_rows: int, out_dim: int) -> int:
        parts = self.n_groups * self.s_max
        return 0 if parts == 1 else parts * n_rows * out_dim

    def as_ints(self) -> List[int]:
        """The launcher's ``plan_out`` layout."""
        pad = [0] * (MAX_CLASSES - len(self.us))
        return ([self.n_groups, self.s_max, sum(self.n_slices), self.xs_max, self.nc_max,
                 self.hidden_rows] + list(self.us) + pad + list(self.n_slices) + pad)


def class_slices(paths: np.ndarray, fan: int, d3: int, cap: int) -> Tuple[int, int]:
    """(us, n_slices) of one class: the fewest balanced slices of at most
    SLICE_COLS columns whose every slice keeps within ``cap`` packed input
    floats and MAX_W CG-weight columns (the launcher's ``make_plan``)."""
    n = -(-fan // (SLICE_COLS // d3))
    while True:
        us = -(-fan // n)
        ns = -(-fan // us)
        if all(sl.xs <= cap and sl.nc <= MAX_W
               for sl in (slice_of(paths, d3, s * us, min(us, fan - s * us)) for s in range(ns))):
            return us, ns
        if us == 1:
            raise ValueError(f"a single u of a class (d3 = {d3}) needs more than {cap} packed "
                             f"input floats or {MAX_W} CG-weight columns")
        n += 1


def tile_plan(cls_rows: np.ndarray, path_rows: np.ndarray, Ha: int, J: int) -> TilePlan:
    """The kernel's :class:`TilePlan` for a gen-2 or gen-1 class table (their
    first 8 class columns and first 5 path columns agree), with ``J``
    harmonics per neighbour."""
    n_groups = -(-Ha // MAX_GROUP_ROWS)
    hr = 16 * -(-Ha // (16 * n_groups))
    cap = xp_cap(hr, J)
    us, n_slices, xs_max, nc_max = [], [], 0, 0
    for row in cls_rows.tolist():
        fan, d3 = row[0], row[1]
        paths = path_rows[row[6]:row[6] + row[7]]
        u, n = class_slices(paths, fan, d3, cap)
        us.append(u)
        n_slices.append(n)
        for s in range(n):
            sl = slice_of(paths, d3, s * u, min(u, fan - s * u))
            xs_max, nc_max = max(xs_max, sl.xs), max(nc_max, sl.nc)
    return TilePlan(hr, n_groups, tuple(us), tuple(n_slices), max(n_slices), xs_max, nc_max)


# checked plans by (kernel, tables, shapes): the check costs more host time
# than a small launch takes on the card
_checked: Dict[tuple, int] = {}


def checked_plan(name: str, plan_fn, cls_rows: np.ndarray, path_rows: np.ndarray, Ha: int,
                 J: int, n_rows: int, out_dim: int, dims: Sequence[int]) -> int:
    """Ask the kernel library for its plan and its scratch size, and check
    both against :func:`tile_plan` (once per tables and shapes); returns the
    scratch floats."""
    key = (name, cls_rows.tobytes(), path_rows.tobytes(), Ha, J, n_rows, out_dim, tuple(dims))
    if key not in _checked:
        _checked[key] = _check_plan(name, plan_fn, cls_rows, path_rows, Ha, J, n_rows, out_dim,
                                    dims)
    return _checked[key]


def _check_plan(name, plan_fn, cls_rows, path_rows, Ha, J, n_rows, out_dim, dims) -> int:
    got = np.zeros(6 + 2 * MAX_CLASSES, np.int32)
    n_scratch = plan_fn(cls_rows.ctypes.data, cls_rows.shape[0], path_rows.ctypes.data,
                        path_rows.shape[0], n_rows, *dims, got.ctypes.data)
    if n_scratch < 0:
        raise ValueError(f"{name}: the kernel refuses the class table {cls_rows.tolist()} "
                         f"with paths {path_rows.tolist()}")
    plan = tile_plan(cls_rows, path_rows, Ha, J)
    if got.tolist() != plan.as_ints() or n_scratch != plan.scratch_floats(n_rows, out_dim):
        raise RuntimeError(f"{name}: the kernel plans {got.tolist()} with {n_scratch} scratch "
                           f"floats, tile_plan {plan.as_ints()} with "
                           f"{plan.scratch_floats(n_rows, out_dim)}")
    return n_scratch


# ----------------------------------------------------------------------
# the bfloat16 kernel (csrc/factored_tp_bf16.cu), gens 2 and 1
# ----------------------------------------------------------------------

# hidden-product widths (wgmma N); coupled columns of a slice (wgmma M) and
# its CG-weight columns; harmonics per neighbour (one k16 step); slices of a
# call; elements of a neighbour's [sh | x] row (one TMA box); 227 KB of
# shared memory a block
BF16_WIDTHS = (32, 72, 144)
BF16_COLS = 64
BF16_MAX_WCOLS = 64
BF16_MAX_J = 16
BF16_MAX_SLICES = 48
BF16_MAX_CLASSES = 16
BF16_MAX_ROW = 256
BF16_MAX_OUTPUTS = 256
BF16_SMEM_BUDGET = 232448
BF16_TILES = 4  # weight-product tiles per warp per pass
BF16_R_MIN = 6  # the fewest receivers a block takes before its stages narrow
BF16_MIN_SLOT = 16384  # the least bytes of a ring slot: the weight product's loads
GEO_ROWS = BF16_COLS + BF16_MAX_WCOLS  # int4 rows of a slice's geometry
GEO_BYTES = GEO_ROWS * 16 + BF16_MAX_WCOLS * 24 * 2  # its shared memory, with the dense CG^T
SM_COUNT = 132  # an H100 SXM's SMs


class Bf16Slice(NamedTuple):
    """One column slice of the bfloat16 kernel: ``nu`` whole u groups of
    class ``cls`` (``fan``, ``d3``, ``mul``, output columns from
    ``out_off``) from ``u0``, ``nw`` CG-weight columns, ``chain_f32`` (gen
    1's one-path d3 = 1 classes end their chain in float32)."""

    cls: int
    fan: int
    d3: int
    mul: int
    out_off: int
    u0: int
    nu: int
    nw: int
    chain_f32: bool


class Bf16Plan(NamedTuple):
    """How the bfloat16 kernel cuts one call (mirrors its ``make_plan``):
    P's rows per u (``HP``: the hidden rows rounded up to even, ``He``, then
    the bias row and a zero row), each slice's weight-product ``depth``
    (``nu*HP`` rounded up to 64) and packed weight offset; the hidden
    product's width ``NW``; ``R`` receivers per block; ``whole`` (every
    slice in each block) or every slice of one class per block; ``k_parts``
    (2: the two consumer warpgroups split each receiver's neighbours in
    halves of ``h0`` stages of ``KC``); ``S`` ring slots; the [sh | x] row
    width ``W`` and x's first column; shared memory, blocks, packed weights."""

    H: int
    He: int
    HP: int
    depth: Tuple[int, ...]
    w_off: Tuple[int, ...]
    NW: int
    R: int
    whole: bool
    k_parts: int
    KC: int
    n_kc: int
    h0: int
    S: int
    W: int
    x_col: int
    smem_bytes: int
    n_groups: int
    n_blocks: int
    w_len: int

    def as_ints(self) -> List[int]:
        """The numbers ``factored_tp_bf16_plan`` reports."""
        return [self.R, int(self.whole), self.k_parts, self.KC, self.S, self.NW, self.smem_bytes,
                self.n_blocks, self.w_len]


def bf16_row(F: int, sh_f32: bool) -> Tuple[int, int]:
    """(x's first column, the row width W) of the [sh | x] rows: the J <= 16
    harmonics in columns 0-15 (a float32 sh as three bfloat16 parts, hi,
    mid and lo, in columns 0-15, 16-31 and 32-47: their sum is exact), then
    x_nbr's F elements, zeros to a multiple of 8."""
    x_col = 3 * BF16_MAX_J if sh_f32 else BF16_MAX_J
    return x_col, _round_up(x_col + F, 8)


def _touched(paths, u0: int, nu: int):
    """The (path, first u, count) of class ``paths`` (gen 1's PathSpecs, u
    in order) inside the slice [u0, u0 + nu)."""
    out, u_off = [], 0
    for p in paths:
        ua, ub = max(u0, u_off), min(u0 + nu, u_off + p.mul)
        if ua < ub:
            out.append((p, ua - u_off, ub - ua))
        u_off += p.mul
    return out


def _class_cuts(paths, fan: int, d3: int) -> List[Tuple[int, int]]:
    """(u0, nu) of a class's slices: the fewest balanced slices of at most
    BF16_COLS coupled columns whose every slice needs at most
    BF16_MAX_WCOLS CG-weight columns (d1*d3 for each path it touches)."""
    if any(p.d1 * d3 > BF16_MAX_WCOLS for p in paths):
        raise ValueError(f"a path of d1*d3 = {max(p.d1 for p in paths) * d3} CG-weight columns; "
                         f"the bfloat16 kernel takes at most {BF16_MAX_WCOLS}")
    n = -(-fan // (BF16_COLS // d3))
    while True:
        us = -(-fan // n)
        cuts = [(u0, min(us, fan - u0)) for u0 in range(0, fan, us)]
        if all(sum(p.d1 * d3 for p, _a, _n in _touched(paths, u0, nu)) <= BF16_MAX_WCOLS
               for u0, nu in cuts):
            return cuts
        n += 1


_geometry: Dict[tuple, tuple] = {}


def bf16_geometry(tp, gen: int):
    """(slices, geometry (n_slices, GEO_ROWS, 4) int32, CG matrix (max_d2,
    cols) float32) of the bfloat16 kernel for ``tp``, kept per TP and gen.
    Row j < 64 of a slice's geometry: coupled column j's first x_nbr
    element (from x's first column of the [sh | x] row), its d1 and its
    first CG-weight column (term i reads
    column first + i*d3); row 64 + cc: CG-weight column cc's first harmonic,
    its d2 and its column of the CG matrix (rows from 0, as gen 1's
    ``build_specs`` packs each path's (d2, d1*d3) block)."""
    key = (str(tp.irreps_in1), str(tp.irreps_in2), str(tp.irreps_out), gen)
    got = _geometry.get(key)
    if got is not None:
        return got
    from diffdock_tpu_torch.ops.factored_tp1 import build_specs

    specs, cg_all, _xp, _out = build_specs(tp)
    if tp.irreps_in2.dim > BF16_MAX_J:
        raise ValueError(f"{tp.irreps_in2.dim} harmonics; the bfloat16 kernel takes at most "
                         f"{BF16_MAX_J}")
    slices, geo = [], []
    for c, s in enumerate(specs):
        chain_f32 = gen == 1 and len(s.paths) == 1 and s.d3 == 1
        for u0, nu in _class_cuts(s.paths, s.fan, s.d3):
            touched = _touched(s.paths, u0, nu)
            rows = np.zeros((GEO_ROWS, 4), np.int32)
            w_first, cc = {}, 0
            for p, _a, _n in touched:
                w_first[id(p)] = cc
                for q in range(p.d1 * s.d3):
                    rows[BF16_COLS + cc + q, :3] = (p.sh_start, p.d2, p.cg_col + q)
                cc += p.d1 * s.d3
            j = 0
            for p, ua, n in touched:
                for uu in range(ua, ua + n):
                    for d in range(s.d3):
                        rows[j, :3] = (p.x_start + uu * p.d1, p.d1, w_first[id(p)] + d)
                        j += 1
            slices.append(Bf16Slice(c, s.fan, s.d3, s.mul_out, s.out_off, u0, nu, cc, chain_f32))
            geo.append(rows)
    if len(slices) > BF16_MAX_SLICES or len(specs) > BF16_MAX_CLASSES:
        raise ValueError(f"{len(slices)} column slices of {len(specs)} classes; the bfloat16 "
                         f"kernel takes at most {BF16_MAX_SLICES} of {BF16_MAX_CLASSES}")
    got = _geometry[key] = (tuple(slices), np.stack(geo), cg_all)
    return got


def bf16_tile_offset(kk, j):
    """The byte offset of coupled column ``j`` (< 64) of neighbour ``kk`` in a
    stage's coupled tile: rows of 128 bytes (64 bfloat16 columns), the
    16-byte group of column j at group (j // 8) ^ (kk % 8) of its row: the
    128-byte swizzle that TMA writes and that the wgmma A descriptor reads
    (MN-major). Integers or numpy arrays."""
    return kk * 128 + (((j >> 3) ^ (kk & 7)) << 4) + ((j & 7) << 1)


def slice_table(slices) -> np.ndarray:
    """The kernel's slice table: (cls, fan, d3, mul, out_off, u0, nu, nw,
    chain_f32, 0) per slice, int64."""
    return np.asarray([tuple(sl) + (0,) for sl in slices], np.int64).reshape(-1, 10)


_plans: Dict[tuple, Bf16Plan] = {}


def bf16_plan(slices, n_rows: int, K: int, H: int, F: int, J: int, sh_f32: bool, parts: int,
              n_sm: int = SM_COUNT) -> Bf16Plan:
    """The bfloat16 kernel's :class:`Bf16Plan` for ``slices`` and the
    shapes (kept per slices and shapes), ``parts`` the parts of h and mw
    (1, or 3 for gen 1's float32 ones); ValueError where the kernel refuses
    them."""
    key = (tuple(slices), n_rows, K, H, F, J, sh_f32, parts, n_sm)
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = _bf16_plan(slices, n_rows, K, H, F, J, sh_f32, parts, n_sm)
    return plan


def _bf16_plan(slices, n_rows, K, H, F, J, sh_f32, parts, n_sm):
    if not 1 <= H <= BF16_WIDTHS[-1] or K < 1 or not 1 <= J <= BF16_MAX_J:
        raise ValueError(f"the bfloat16 kernel takes 1..{BF16_WIDTHS[-1]} hidden channels, "
                         f"K >= 1 and 1..{BF16_MAX_J} harmonics, got H = {H}, K = {K}, J = {J}")
    x_col, W = bf16_row(F, sh_f32)
    if W > BF16_MAX_ROW:
        raise ValueError(f"[sh | x] rows of {W} elements; the bfloat16 kernel takes at most "
                         f"{BF16_MAX_ROW}")
    if max(sl.mul * sl.d3 for sl in slices) > BF16_MAX_OUTPUTS:
        raise ValueError(f"a class of more than {BF16_MAX_OUTPUTS} outputs")
    He = H + (H & 1)
    HP = He + 2
    NW = next(w for w in BF16_WIDTHS if w >= H)
    depth = tuple(_round_up(sl.nu * HP, 64) for sl in slices)
    w_off = tuple(int(v) for v in np.cumsum([0] + [d * sl.mul for d, sl in zip(depth, slices)]))
    n_classes = slices[-1].cls + 1
    D = slices[-1].out_off + slices[-1].mul * slices[-1].d3
    k_parts = 2 if K >= 256 else 1
    h_boxes = -(-NW // 64)
    max_mul = max(sl.mul for sl in slices)
    max_nw = max(sl.nw for sl in slices)
    n_tiles = 2 if any(sl.chain_f32 for sl in slices) else 1

    def smem(KC, R, S):
        x_off = KC * 128 * h_boxes * parts
        slot = _round_up(max(x_off + _round_up(KC * W * 2, 128), max_mul * 128 + 2048,
                             BF16_MIN_SLOT), 1024)
        m_bytes = _round_up(2 * KC + 128, 128)  # mw, and the rows the bias product reads past it
        wt = _round_up(max_nw * (KC + 2) * 2, 16)
        t_max = max(1, max(min(-(-sl.mul // 16) * -(-(R * sl.d3) // 8), 2 * BF16_TILES)
                           for sl in slices))
        p = _round_up(max(R * sl.d3 * (d + 8) * 2 for sl, d in zip(slices, depth)), 1024)
        x = (NW // 2 + 4) * 128 * 4 if k_parts == 2 else 0
        return (S * slot + 2 * n_tiles * KC * 128 + S * parts * m_bytes + 2 * wt + GEO_BYTES + p
                + x + 4 * t_max * 128 * 4 + _round_up(R * D * 4, 16) + 2 * S * 8 + 1024)

    def most(KC, S):
        return next((r for r in range(16, 0, -2) if smem(KC, r, S) <= BF16_SMEM_BUDGET), 0)

    # the widest stage (up to 64 neighbours, no wider than K needs) that
    # leaves 4, else 3, slots and room for at least 8 receivers (2 when the
    # warpgroups split long neighbour lists, and then 4 slots); else 16 or 32
    # neighbours and 2 slots
    r_min = 2 if k_parts == 2 else BF16_R_MIN
    top = 16 if K <= 16 else 32 if K <= 32 else 64
    slots = (4,) if k_parts == 2 else (4, 3)
    choice = next(((KC, S) for KC in (64, 32, 16) if KC <= top for S in slots
                   if most(KC, S) >= r_min), None)
    if choice is None:
        choice = (16 if K <= 16 else 32, 2)
    KC, S = choice
    R = most(KC, S)
    if R == 0:
        raise ValueError("the slices do not fit the bfloat16 kernel's shared memory")
    n_kc = -(-K // KC)
    # few receiver groups: every slice of one class per block, with fewer
    # receivers per block, so that the blocks cover the SMs twice
    whole = -(-n_rows // R) >= n_sm
    r_low = 1 if k_parts == 2 else 2
    if not whole:
        while R > r_low and -(-n_rows // R) * n_classes < 2 * n_sm:
            R = R // 2 if k_parts == 2 else max(2, (R // 2 + 1) // 2 * 2)
    n_groups = -(-n_rows // R)
    return Bf16Plan(H, He, HP, depth, w_off[:-1], NW, R, whole, k_parts, KC, n_kc, -(-n_kc // 2),
                    S, W, x_col, smem(KC, R, S), n_groups,
                    n_groups if whole else n_groups * n_classes, w_off[-1])


_pack_index: Dict[tuple, torch.Tensor] = {}


def bf16_weight_index(slices, plan: Bf16Plan) -> np.ndarray:
    """For each element of the packed weights, its index in the class blocks
    (H+1, fan, mul) flattened one after the other, or one past their end (a
    zero): gen 3's layout (``fused_tp3.swizzled_weight_index``) over these
    slices."""
    sizes = {sl.cls: (plan.H + 1) * sl.fan * sl.mul for sl in slices}
    return swizzled_weight_index(
        [(sl.cls, sl.u0, sl.nu, sl.fan, sl.mul, d) for sl, d in zip(slices, plan.depth)],
        [sizes[c] for c in sorted(sizes)], plan.H, plan.HP, plan.He)


def pack_bf16_weights(tp, slices, plan: Bf16Plan, out_kernel: torch.Tensor,
                      out_bias: torch.Tensor) -> torch.Tensor:
    """The unscaled last-layer weights per class, (H+1, fan, mul) with the
    bias as row H, in bfloat16, in the kernel's layout (one gather)."""
    H = plan.H
    blocks = []
    for offset, fan, mul in tp.weight_slices():
        t_k = out_kernel[:, offset: offset + fan * mul].reshape(H, fan * mul)
        blocks += [t_k.reshape(-1), out_bias[offset: offset + fan * mul]]
    flat = torch.cat(blocks + [out_bias.new_zeros(1)]).to(torch.bfloat16)
    key = (tuple(slices), plan.HP, H, str(flat.device))
    idx = _pack_index.get(key)
    if idx is None:
        idx = _pack_index[key] = torch.from_numpy(bf16_weight_index(slices, plan)).to(flat.device)
    return flat[idx]


class Bf16Call(NamedTuple):
    """What the bfloat16 kernel takes beside its tensors: the slices, x_nbr's
    width ``F``, the harmonics ``J``, whether sh is float32, the hidden
    channels ``H`` and the parts of h and mw (1 or 3)."""

    slices: Tuple[Bf16Slice, ...]
    F: int
    J: int
    sh_f32: bool
    H: int
    parts: int


def _tma_rows(t: torch.Tensor) -> torch.Tensor:
    return t if _rows_of_8(t) else _pad_rows(t)


def prepare_bf16(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias, gen: int):
    """The torch side of a bfloat16 call of gen ``gen`` (2 or 1): (xs, h,
    mw, cg, packed weights, geometry, :class:`Bf16Call`). ``xs`` (N, K, W)
    holds each neighbour's harmonics in columns 0-15 (gen 1's float32 sh as
    three bfloat16 parts in columns 0-47), then its x_nbr row, zeros to W
    (:func:`bf16_row`); ``h`` (N, K, H) and ``mw`` (N, 1, K) bfloat16 with
    rows a multiple of 8 elements apart, or, where gen 1 takes a float32 h
    or mw, both as three bfloat16 parts whose sum is exact: h (N, K, 3*hp),
    part q from column q*hp (hp = H + 1 rounded up to 8), mw (N, 3, K).
    Gen 2 casts edge_sh, h and mw to bfloat16 first, as its TPU wrapper
    does; gen 1 keeps their dtypes, as its TPU wrapper does. The CG matrix
    and the unscaled weights (bias as row H) in bfloat16."""
    name = f"factored_tp{gen}"
    check_no_empty_class(tp, name)
    bf16 = torch.bfloat16
    if x_nbr.dtype != bf16:
        raise TypeError(f"{name}: the bfloat16 kernel takes a bfloat16 x_nbr, got {x_nbr.dtype}")
    if gen == 2:
        edge_sh, h, mw = edge_sh.to(bf16), h.to(bf16), mw.to(bf16)
    for label, t in (("edge_sh", edge_sh), ("h", h), ("mw", mw)):
        if t.dtype not in (torch.float32, bf16):
            raise TypeError(f"{name}: {label} must be float32 or bfloat16, got {t.dtype}")
    N, K, F = x_nbr.shape
    H, J = h.shape[-1], edge_sh.shape[-1]
    sh_f32 = edge_sh.dtype == torch.float32
    slices, geo, cg_all = bf16_geometry(tp, gen)
    x_col, W = bf16_row(F, sh_f32)
    xs = x_nbr.new_zeros(N, K, W)
    xs[..., x_col: x_col + F] = x_nbr
    split_parts(edge_sh, [xs[..., q * BF16_MAX_J: q * BF16_MAX_J + J]
                          for q in range(3 if sh_f32 else 1)])
    parts = 3 if torch.float32 in (h.dtype, mw.dtype) else 1
    if parts == 1:
        h, mw = _tma_rows(h), _tma_rows(mw)[:, None]
    else:
        hp = _round_up(H + 1, 8)
        hs = x_nbr.new_zeros(N, K, parts * hp)
        ms = x_nbr.new_zeros(N, parts, _round_up(K, 8))
        split_parts(h.float(), [hs[..., q * hp: q * hp + H] for q in range(parts)])
        split_parts(mw.float(), [ms[:, q, :K] for q in range(parts)])
        h, mw = hs, ms[..., :K]
    plan = bf16_plan(slices, N, K, H, F, J, sh_f32, parts)
    weights = pack_bf16_weights(tp, slices, plan, out_kernel, out_bias)
    geo_t = tp._consts.get(f"bf16_geo{gen}", geo, torch.empty(0, dtype=torch.int32,
                                                              device=x_nbr.device))
    cg = tp._consts.get("gen1_cg_all", cg_all, x_nbr)
    return xs, h, mw, cg, weights, geo_t, Bf16Call(slices, F, J, sh_f32, H, parts)


def split_parts(t: torch.Tensor, parts) -> None:
    """Write ``t`` into the bfloat16 views ``parts`` (each of its shape): the
    value rounded, then each part what the ones before it left. Three parts
    of a float32 sum to it exactly (8 significant bits each)."""
    rest = t
    for part in parts:
        part.copy_(rest)
        rest = rest - part.float()


class Bf16Library:
    """The bfloat16 kernel's entry points in a loaded library."""

    def __init__(self, lib):
        fn = lib.factored_tp_bf16_forward
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 3
                       + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        plan = lib.factored_tp_bf16_plan
        plan.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        plan.restype = ctypes.c_int
        self.forward, self.plan = fn, plan
        self.checked: Dict[tuple, bool] = {}

    def check_plan(self, name: str, table: np.ndarray, plan: Bf16Plan, dims: tuple) -> None:
        """The library's plan against :func:`bf16_plan` (once per slices and
        shapes)."""
        key = (table.tobytes(), dims)
        if key in self.checked:
            return
        got = np.zeros(9, np.int64)
        if self.plan(table.ctypes.data, table.shape[0], *dims, got.ctypes.data) != 0:
            raise ValueError(f"{name}: the bfloat16 kernel refuses the slices {table.tolist()} at "
                             f"(n_rows, K, H, F, J, sh_f32, parts, D, n_sm) = {dims}")
        if got.tolist() != plan.as_ints():
            raise RuntimeError(f"{name}: the bfloat16 kernel plans {got.tolist()}, bf16_plan "
                               f"{plan.as_ints()}")
        self.checked[key] = True


def launch_bf16(lib: Bf16Library, counter, mode: str, xs, h, mw, cg, weights, geo,
                call: Bf16Call, out_dim: int) -> torch.Tensor:
    """Launch the bfloat16 kernel on operands from :func:`prepare_bf16`
    (counted as ``mode`` in ``counter``). Returns (N, out_dim) f32 in e3nn
    layout."""
    name = mode[:-5]
    for label, t in (("xs", xs), ("h", h), ("mw", mw), ("cg", cg), ("weights", weights),
                     ("geometry", geo)):
        if not t.is_cuda:
            raise ValueError(f"{name}: {label} must be a CUDA tensor")
        if t.device != xs.device:
            raise ValueError(f"{name}: {label} is on {t.device}, xs on {xs.device}")
        if t.dtype != (torch.int32 if label == "geometry" else torch.bfloat16):
            raise TypeError(f"{name}: {label} must be bfloat16, got {t.dtype}")
    N, K, W = xs.shape
    H, parts, slices = call.H, call.parts, call.slices
    if bf16_row(call.F, call.sh_f32)[1] != W:
        raise ValueError(f"{name}: xs rows of {W} elements, not the [sh | x] rows of F = {call.F}")
    h_width = H if parts == 1 else parts * _round_up(H + 1, 8)
    if tuple(h.shape) != (N, K, h_width) or tuple(mw.shape) != (N, parts, K):
        raise ValueError(f"{name}: h {tuple(h.shape)} and mw {tuple(mw.shape)} vs xs "
                         f"{tuple(xs.shape)}, H = {H} in {parts} part(s)")
    mw_rows = mw.stride(0) // parts  # elements between the rows of mw's parts
    if not (_rows_of_8(h) and mw.stride(-1) == 1 and mw_rows % 8 == 0 and mw_rows >= K
            and mw.stride(0) == parts * mw_rows and (parts == 1 or mw.stride(1) == mw_rows)
            and mw.data_ptr() % 16 == 0):
        raise ValueError(f"{name}: h and mw need rows a multiple of 8 elements apart on a "
                         "16-byte aligned base (prepare_bf16 pads them)")
    if not (xs.is_contiguous() and xs.data_ptr() % 16 == 0 and weights.is_contiguous()
            and weights.data_ptr() % 16 == 0 and geo.is_contiguous()
            and tuple(geo.shape) == (len(slices), GEO_ROWS, 4)):
        raise ValueError(f"{name}: xs, weights and the geometry must be contiguous, 16-byte aligned")
    n_sm = torch.cuda.get_device_properties(xs.device).multi_processor_count
    plan = bf16_plan(slices, N, K, H, call.F, call.J, call.sh_f32, parts, n_sm)
    if weights.numel() != plan.w_len:
        raise ValueError(f"{name}: {weights.numel()} packed weights, the plan has {plan.w_len}")
    table = slice_table(slices)
    lib.check_plan(name, table, plan, (N, K, H, call.F, call.J, int(call.sh_f32), parts, out_dim,
                                       n_sm))
    out = torch.empty(N, out_dim, device=xs.device, dtype=torch.float32)
    err = lib.forward(
        xs.data_ptr(), h.data_ptr(), mw.data_ptr(), geo.data_ptr(), cg.data_ptr(), cg.shape[1],
        weights.data_ptr(), out.data_ptr(), table.ctypes.data, table.shape[0], N, K, call.F,
        call.J, int(call.sh_f32), H, h.stride(1), mw_rows, parts, out_dim,
        torch.cuda.current_stream(xs.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{mode} kernel launch failed: cudaError {err}")
    counter.add(mode)
    return out


# ----------------------------------------------------------------------
# the kernel
# ----------------------------------------------------------------------


class _Kernel:
    """The loaded library with its ``argtypes`` set."""

    def __init__(self):
        lib = build.load("factored_tp2", _SOURCES)
        fn = lib.factored_tp2_forward
        fn.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
        ] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        plan = lib.factored_tp2_plan
        plan.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        plan.restype = ctypes.c_longlong
        for name in ("factored_tp2_max_classes", "factored_tp2_max_paths",
                     "factored_tp2_max_columns", "factored_tp2_max_outputs"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        self.forward = fn
        self.plan = plan
        self.bf16 = Bf16Library(lib)
        self.max_classes = lib.factored_tp2_max_classes()
        self.max_paths = lib.factored_tp2_max_paths()
        self.max_columns = lib.factored_tp2_max_columns()
        self.max_outputs = lib.factored_tp2_max_outputs()


_kernel = None


def _get_kernel() -> _Kernel:
    global _kernel
    if _kernel is None:
        _kernel = _Kernel()
    return _kernel


def check_operands(name: str, tensors, dtypes=(torch.float32,)) -> None:
    """CUDA, contiguous, all on one device, each of one of ``dtypes``
    (``(label, tensor)`` pairs; a triple ``(label, tensor, dtypes)`` names
    its own)."""
    dev = tensors[0][1].device
    for label, t, *own in tensors:
        allowed = own[0] if own else dtypes
        if not t.is_cuda:
            raise ValueError(f"{name}: {label} must be a CUDA tensor")
        if t.dtype not in allowed:
            names = " or ".join(str(d).replace("torch.", "") for d in allowed)
            raise TypeError(f"{name}: {label} must be {names}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
        if t.device != dev:
            raise ValueError(f"{name}: {label} is on {t.device}, {tensors[0][0]} on {dev}")


def check_tables(name: str, kern, cls_rows: np.ndarray, path_rows: np.ndarray) -> None:
    """The limits the kernel's tables and blocks impose, as clear errors."""
    n_classes, n_paths = cls_rows.shape[0], path_rows.shape[0]
    if not 1 <= n_classes <= kern.max_classes:
        raise ValueError(f"{name}: {n_classes} output classes, the kernel takes 1..{kern.max_classes}")
    if n_paths > kern.max_paths:
        raise ValueError(f"{name}: {n_paths} paths, the kernel takes at most {kern.max_paths}")
    fd = cls_rows[:, 0] * cls_rows[:, 1]
    wd = cls_rows[:, 2] * cls_rows[:, 1]
    if fd.max() > kern.max_columns:
        raise ValueError(f"{name}: a class has fan*d3 = {fd.max()} coupled columns, "
                         f"the kernel takes at most {kern.max_columns}")
    if wd.max() > kern.max_outputs:
        raise ValueError(f"{name}: a class has mul*d3 = {wd.max()} outputs, "
                         f"the kernel takes at most {kern.max_outputs}")


def launch(*ops) -> torch.Tensor:
    """Launch a kernel on prepared operands and the output width,
    ``launch(*prepare(...), out_dim)``: the float32 kernel on float32
    operands (:func:`prepare`), the bfloat16 kernel on bfloat16 ones
    (:func:`prepare_bf16`, :func:`launch_bf16`). Returns (N, out_dim) f32
    in e3nn layout."""
    if ops[0].dtype == torch.bfloat16:
        return launch_bf16(_get_kernel().bf16, counts, "factored_tp2_bf16", *ops)
    if ops[0].dtype != torch.float32:
        raise TypeError(f"factored_tp2: xp must be float32 or bfloat16, got {ops[0].dtype}")
    return _launch_f32(*ops)


def _launch_f32(xp, sh, h_aug, Ha: int, cg, weights, cls_rows, path_rows, out_dim: int
                ) -> torch.Tensor:
    check_operands("factored_tp2", (("xp", xp), ("edge_sh", sh), ("h_aug", h_aug), ("cg", cg),
                                    ("weights", weights)))
    N, K, XP = xp.shape
    J = sh.shape[-1]
    He = h_aug.shape[2]
    if sh.shape[:2] != (N, K) or h_aug.shape != (N, K, He) or cg.shape[0] != J or not 1 <= Ha <= He:
        raise ValueError(f"factored_tp2: operand shapes xp {tuple(xp.shape)}, edge_sh "
                         f"{tuple(sh.shape)}, h_aug {tuple(h_aug.shape)}, cg {tuple(cg.shape)} "
                         "disagree")
    kern = _get_kernel()
    check_tables("factored_tp2", kern, cls_rows, path_rows)
    if weights.numel() != int((He * cls_rows[:, 0] * cls_rows[:, 2]).sum()):
        raise ValueError("factored_tp2: weights do not match the class table")
    cls_rows = np.ascontiguousarray(cls_rows, np.int32)
    path_rows = np.ascontiguousarray(path_rows, np.int32)
    n_scratch = checked_plan("factored_tp2", kern.plan, cls_rows, path_rows, Ha, J, N, out_dim,
                             (XP, J, Ha, cg.shape[1], out_dim))
    out = torch.empty(N, out_dim, device=xp.device, dtype=torch.float32)
    scratch = torch.empty(max(n_scratch, 1), device=xp.device, dtype=torch.float32)
    err = kern.forward(
        xp.data_ptr(), sh.data_ptr(), h_aug.data_ptr(), cg.data_ptr(), weights.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), cls_rows.ctypes.data, cls_rows.shape[0],
        path_rows.ctypes.data, path_rows.shape[0], N, K, XP, J, He, Ha, cg.shape[1], out_dim,
        torch.cuda.current_stream(xp.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"factored_tp2 kernel launch failed: cudaError {err}")
    counts.add("factored_tp2")
    return out


def _forward_kernel(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias):
    return launch(*prepare(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias), tp.irreps_out.dim)


def factored_tp2(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias):
    """Summed TP messages (N, dim_out) f32 through the gen-2 Hopper kernel
    in the mode of ``x_nbr``'s dtype, differentiable in float32; on CPU
    tensors through :func:`factored_tp_reference` (bfloat16:
    :func:`factored_tp_bf16_reference`)."""
    check_no_empty_class(tp, "factored_tp2")
    if x_nbr.dtype == torch.bfloat16:
        inputs = (x_nbr, edge_sh, h, mw, out_kernel, out_bias)
        if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
            raise TypeError("factored_tp2: no gradient through bfloat16 inputs, as in the "
                            "JAX package")
        if x_nbr.is_cuda:
            return launch(*prepare_bf16(tp, *inputs, gen=2), tp.irreps_out.dim)
        return factored_tp_bf16_reference(tp, *inputs, gen=2)
    fwd = _forward_kernel if x_nbr.is_cuda else factored_tp_reference
    # the backward differentiates the plain version (counted as such)
    return PlainVJP.apply(tp, fwd, factored_tp_reference, "factored_tp2_vjp",
                          x_nbr, edge_sh, h, mw, out_kernel, out_bias)
