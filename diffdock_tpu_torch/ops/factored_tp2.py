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

counts = LaunchCounts("factored_tp2", "factored_tp_reference")


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
    kernel does not walk."""
    check_no_empty_class(tp, "factored_tp2")
    specs, cg_full, _xp_dim, _out_dim = build_specs2(tp)
    N, K, _ = x_nbr.shape
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
    cg = tp._consts.get("gen2_cg_full", cg_full, x_nbr)
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
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
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


def check_operands(name: str, tensors) -> None:
    """CUDA, float32, contiguous, all on one device."""
    dev = tensors[0][1].device
    for label, t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: {label} must be a CUDA tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {label} must be float32, got {t.dtype}")
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
    """Launch the kernel on prepared operands (see :func:`prepare`).
    Returns (N, out_dim) f32 in e3nn layout."""
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
    """Summed TP messages (N, dim_out) f32 through the gen-2 Hopper kernel,
    differentiable; on CPU tensors through :func:`factored_tp_reference`."""
    check_no_empty_class(tp, "factored_tp2")
    fwd = _forward_kernel if x_nbr.is_cuda else factored_tp_reference
    # the backward differentiates the plain version (counted as such)
    return PlainVJP.apply(tp, fwd, factored_tp_reference, "factored_tp2_vjp",
                          x_nbr, edge_sh, h, mw, out_kernel, out_bias)
