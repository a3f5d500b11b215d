"""Gen-2 factored TP contraction: the Hopper kernel, its plain version and its gradient.

Port of ``diffdock_tpu/ops/pallas_tpconv2.py``. The wrapper takes the JAX
signature

    f(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias) -> (N, dim_out) f32

(see :mod:`diffdock_tpu_torch.ops.fused_tp3` for the arguments) and
returns the neighbour SUM of the tensor-product messages in e3nn layout.
Unlike gen 3, the kernel builds the Clebsch-Gordan coupling itself, from
the raw neighbour features and edge harmonics:

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
do the wrappers here, on ``csrc/factored_tp{2,1}.cu``'s bfloat16 mode, with
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
float32 ones (JAX's promotion) before its rounding. No gradient runs
through the bfloat16 mode: no JAX entry point trains in bfloat16.

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

from diffdock_tpu_torch.ops.fused_tp3 import LaunchCounts, PlainVJP
from diffdock_tpu_torch.utils import build

_SOURCES = ("factored_tp2.cu",)

counts = LaunchCounts("factored_tp2", "factored_tp2_bf16", "factored_tp_reference")

# the operand dtypes the kernels take, with the launch count of each mode
MODES = {torch.float32: "factored_tp2", torch.bfloat16: "factored_tp2_bf16"}
# the C interface's dtypes bits (csrc/factored_tp.cuh, kDt*): the bfloat16
# mode, then bfloat16 sh and hidden rows (gen 1: h and mw)
DT_BF16, DT_SH, DT_HID = 1, 2, 4


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
    kernel does not walk. A bfloat16 ``x_nbr`` casts every operand to
    bfloat16 once, as the TPU wrapper does."""
    check_no_empty_class(tp, "factored_tp2")
    specs, cg_full, _xp_dim, _out_dim = build_specs2(tp)
    N, K, _ = x_nbr.shape
    H = h.shape[-1]
    He = _round_up(H + 1, 16)
    if x_nbr.dtype == torch.bfloat16:
        dt = torch.bfloat16
        edge_sh, h, mw = edge_sh.to(dt), h.to(dt), mw.to(dt)
        out_kernel, out_bias = out_kernel.to(dt), out_bias.to(dt)
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
    if x_nbr.dtype == torch.bfloat16:
        # the kernel copies bfloat16 in aligned pairs: even widths (the
        # extra harmonic and its CG row are zero)
        xp = pad_even(xp)
        if edge_sh.shape[-1] % 2:
            edge_sh = pad_even(edge_sh)
            cg_full = np.pad(cg_full, ((0, 1), (0, 0)))
    cg = tp._consts.get(f"gen2_cg_full_{cg_full.shape[0]}", cg_full, x_nbr)
    cls_rows, path_rows = class_table(specs, He)
    return xp, edge_sh.contiguous(), h_aug, H + 1, cg, weights, cls_rows, path_rows


def pad_even(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its last axis padded by a zero to an even width."""
    return torch.nn.functional.pad(t, (0, t.shape[-1] % 2)).contiguous()


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
# the kernel
# ----------------------------------------------------------------------


class _Kernel:
    """The loaded library with its ``argtypes`` set."""

    def __init__(self):
        lib = build.load("factored_tp2", _SOURCES)
        fn = lib.factored_tp2_forward
        fn.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
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


def launch(xp, sh, h_aug, Ha: int, cg, weights, cls_rows, path_rows, out_dim: int
           ) -> torch.Tensor:
    """Launch the kernel on prepared operands (see :func:`prepare`), in the
    mode of ``xp``'s dtype (every operand of that dtype). Returns (N,
    out_dim) f32 in e3nn layout."""
    mode = MODES.get(xp.dtype)
    if mode is None:
        raise TypeError(f"factored_tp2: xp must be float32 or bfloat16, got {xp.dtype}")
    check_operands("factored_tp2", (("xp", xp), ("edge_sh", sh), ("h_aug", h_aug), ("cg", cg),
                                    ("weights", weights)), (xp.dtype,))
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
        DT_BF16 | DT_SH | DT_HID if xp.dtype == torch.bfloat16 else 0,
        torch.cuda.current_stream(xp.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{mode} kernel launch failed: cudaError {err}")
    counts.add(mode)
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
            return _forward_kernel(tp, *inputs)
        return factored_tp_bf16_reference(tp, *inputs, gen=2)
    fwd = _forward_kernel if x_nbr.is_cuda else factored_tp_reference
    # the backward differentiates the plain version (counted as such)
    return PlainVJP.apply(tp, fwd, factored_tp_reference, "factored_tp2_vjp",
                          x_nbr, edge_sh, h, mw, out_kernel, out_bias)
