"""Gen-1 factored TP contraction: the Hopper kernel (forward only).

Port of ``diffdock_tpu/ops/pallas_tpconv.py:factored_tp_messages_pallas``.
The wrapper takes the JAX signature

    f(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias) -> (N, dim_out) f32

and returns the neighbour SUM of the tensor-product messages in e3nn
layout. The host side packs the inputs as the TPU kernel's wrapper does:
neighbour features in ``[path][i][u]`` order, one (max_d2, cols) CG matrix
whose columns hold each path's (d2, d1*d3) block (:func:`build_specs`),
and per class the last-layer weights (H, fan, mul) and bias (fan, mul)
apart. ``csrc/factored_tp1.cu`` (which replaces the TPU kernel
``pallas_tpconv.py:_kernel``; its body, shared with gen 2, is
``csrc/factored_tp.cuh``) computes per receiver and class each path's CG
dot against its own harmonic slice, the coupled columns, ``p_h = h^T C``
and ``p_b = mw^T C`` (mw as the hidden operand's row H), and
``(sum_h p_h[h] @ T[h] + p_b @ b) / sqrt(fan)`` (b as the weights' row H),
the two products on the tensor cores in 3xTF32 (float32 accuracy). Its
blocking is gen 2's (:func:`~diffdock_tpu_torch.ops.factored_tp2.tile_plan`),
checked against the kernel's own plan before each launch.

Forward only, as in the JAX package. The plain version is the same as
gen 2's, :func:`diffdock_tpu_torch.ops.factored_tp2.factored_tp_reference`;
a CPU tensor runs it, a CUDA tensor launches the kernel or raises. A TP
with an output class that has no path is refused with a ``ValueError``
(the JAX function divides by sqrt(0) there).

A bfloat16 ``x_nbr`` selects the bfloat16 mode, as ``dt = x_nbr.dtype``
does in the TPU wrapper: ``x_nbr``, the CG matrix and the weights and bias
in bfloat16, ``edge_sh``, ``h`` and ``mw`` in the caller's dtypes (each
float32 or bfloat16; a float32 ``h`` or ``mw`` goes to the kernel as
three bfloat16 parts of each, an exact sum), the rounding points of
:func:`~diffdock_tpu_torch.ops.factored_tp2.factored_tp_bf16_reference`
with ``gen=1``, its plain version (the coupling chain's last step in
float32 where a class has one path and d3 = 1, as XLA runs the Pallas body).
It runs on gen 2's bfloat16 kernel, ``csrc/factored_tp_bf16.cu``
(:func:`~diffdock_tpu_torch.ops.factored_tp2.prepare_bf16` and
:func:`~diffdock_tpu_torch.ops.factored_tp2.launch_bf16` with ``gen=1``),
built once, into gen 2's library.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from diffdock_tpu_torch.ops import factored_tp2
from diffdock_tpu_torch.ops.factored_tp2 import (
    check_no_empty_class,
    check_operands,
    check_tables,
    checked_plan,
    factored_tp_bf16_reference,
    factored_tp_reference,
    launch_bf16,
    pack_neighbors,
    prepare_bf16,
)
from diffdock_tpu_torch.ops.fused_tp3 import LaunchCounts
from diffdock_tpu_torch.utils import build

_SOURCES = ("factored_tp1.cu",)

counts = LaunchCounts("factored_tp1", "factored_tp1_bf16")


@dataclasses.dataclass(frozen=True)
class PathSpec:
    x_start: int  # slice start into the original F_in
    xp_start: int  # slice start into the packed [path][i][u] input
    mul: int  # u
    d1: int  # i
    sh_start: int
    d2: int  # j
    cg_col: int  # column offset into the packed CG matrix


@dataclasses.dataclass(frozen=True)
class ClassSpec:
    fan: int
    d3: int
    mul_out: int
    out_off: int  # offset of the class in the e3nn output
    paths: Tuple[PathSpec, ...]


def build_specs(tp):
    """(specs, cg_all (max_d2, cols), packed input width, output width), as
    ``pallas_tpconv.py:build_specs``: each path's (d2, d1*d3) CG block sits
    in its own columns, rows from 0."""
    specs: List[ClassSpec] = []
    blocks = []
    col = xp_off = out_off = 0
    max_d2 = 1
    for pk, fan, ek in zip(tp.paths, tp.fan_in, tp.irreps_out):
        d3 = ek.ir.dim
        paths = []
        for p in pk:
            e1 = tp.irreps_in1[p.i]
            cgm = p.cg.transpose(1, 0, 2).reshape(p.cg.shape[1], -1)  # (d2, d1*d3)
            max_d2 = max(max_d2, cgm.shape[0])
            paths.append(PathSpec(x_start=tp._sl1[p.i].start, xp_start=xp_off, mul=e1.mul,
                                  d1=e1.ir.dim, sh_start=tp._sl2[p.j].start, d2=cgm.shape[0],
                                  cg_col=col))
            blocks.append(cgm)
            col += cgm.shape[1]
            xp_off += e1.ir.dim * e1.mul
        specs.append(ClassSpec(fan=fan, d3=d3, mul_out=ek.mul, out_off=out_off,
                               paths=tuple(paths)))
        out_off += ek.mul * d3
    cg_all = np.zeros((max_d2, max(col, 1)), np.float32)
    c = 0
    for b in blocks:
        cg_all[: b.shape[0], c : c + b.shape[1]] = b
        c += b.shape[1]
    return tuple(specs), cg_all, xp_off, out_off


def class_table(specs, H: int) -> Tuple[np.ndarray, np.ndarray]:
    """The kernel's tables: per class (fan, d3, mul, out_off, col0, ncols,
    path0, n_paths, t_off, b_off) and per path (u_off, mul, d1, xp_start,
    col, sh_start, d2), ``col`` relative to the class's first CG column,
    int32."""
    cls_rows, path_rows = [], []
    t_off = b_off = 0
    for s in specs:
        col0 = s.paths[0].cg_col
        ncols = sum(p.d1 * s.d3 for p in s.paths)
        cls_rows.append((s.fan, s.d3, s.mul_out, s.out_off, col0, ncols, len(path_rows),
                         len(s.paths), t_off, b_off))
        u_off = 0
        for p in s.paths:
            path_rows.append((u_off, p.mul, p.d1, p.xp_start, p.cg_col - col0, p.sh_start, p.d2))
            u_off += p.mul
        t_off += H * s.fan * s.mul_out
        b_off += s.fan * s.mul_out
    return (np.asarray(cls_rows, np.int32).reshape(-1, 10),
            np.asarray(path_rows, np.int32).reshape(-1, 7))


def prepare(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias):
    """The torch side of the kernel call: (xp, edge_sh, h, mw, cg_all,
    packed T, packed b, class rows, path rows). A bfloat16 ``x_nbr`` selects
    the bfloat16 kernel: :func:`~diffdock_tpu_torch.ops.factored_tp2.prepare_bf16`
    with ``gen=1``."""
    if x_nbr.dtype == torch.bfloat16:
        return prepare_bf16(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias, gen=1)
    check_no_empty_class(tp, "factored_tp1")
    specs, cg_all, _xp_dim, _out_dim = build_specs(tp)
    H = h.shape[-1]
    xp = pack_neighbors(tp, x_nbr).contiguous()
    mw = mw.to(h.dtype)
    t_list, b_list = [], []
    off = 0
    for s in specs:
        n = s.fan * s.mul_out
        t_list.append(out_kernel[:, off : off + n].reshape(-1))
        b_list.append(out_bias[off : off + n])
        off += n
    cls_rows, path_rows = class_table(specs, H)
    return (xp, edge_sh.contiguous(), h.contiguous(), mw.contiguous(),
            tp._consts.get("gen1_cg_all", cg_all, x_nbr), torch.cat(t_list).contiguous(),
            torch.cat(b_list).contiguous(), cls_rows, path_rows)


class _Kernel:
    """The loaded library with its ``argtypes`` set."""

    def __init__(self):
        lib = build.load("factored_tp1", _SOURCES)
        fn = lib.factored_tp1_forward
        fn.argtypes = [ctypes.c_void_p] * 10 + [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
        ] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        plan = lib.factored_tp1_plan
        plan.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_longlong] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        plan.restype = ctypes.c_longlong
        self.plan = plan
        for name in ("factored_tp1_max_classes", "factored_tp1_max_paths",
                     "factored_tp1_max_columns", "factored_tp1_max_outputs"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        self.forward = fn
        self.max_classes = lib.factored_tp1_max_classes()
        self.max_paths = lib.factored_tp1_max_paths()
        self.max_columns = lib.factored_tp1_max_columns()
        self.max_outputs = lib.factored_tp1_max_outputs()


_kernel = None


def _get_kernel() -> _Kernel:
    global _kernel
    if _kernel is None:
        _kernel = _Kernel()
    return _kernel


def launch(*ops) -> torch.Tensor:
    """Launch a kernel on prepared operands and the output width,
    ``launch(*prepare(...), out_dim)``: the float32 kernel on float32
    operands, gen 2's bfloat16 kernel
    (:func:`~diffdock_tpu_torch.ops.factored_tp2.launch_bf16`) on bfloat16
    ones. Returns (N, out_dim) f32 in e3nn layout."""
    if ops[0].dtype == torch.bfloat16:
        return launch_bf16(factored_tp2._get_kernel().bf16, counts, "factored_tp1_bf16", *ops)
    if ops[0].dtype != torch.float32:
        raise TypeError(f"factored_tp1: xp must be float32 or bfloat16, got {ops[0].dtype}")
    return _launch_f32(*ops)


def _launch_f32(xp, sh, h, mw, cg, t_all, b_all, cls_rows, path_rows, out_dim: int) -> torch.Tensor:
    check_operands("factored_tp1", (("xp", xp), ("edge_sh", sh), ("h", h), ("mw", mw),
                                    ("cg", cg), ("out_kernel", t_all), ("out_bias", b_all)))
    N, K, XP = xp.shape
    J = sh.shape[-1]
    H = h.shape[-1]
    if sh.shape[:2] != (N, K) or h.shape[:2] != (N, K) or mw.shape != (N, K):
        raise ValueError(f"factored_tp1: operand shapes xp {tuple(xp.shape)}, edge_sh "
                         f"{tuple(sh.shape)}, h {tuple(h.shape)}, mw {tuple(mw.shape)} disagree")
    kern = _get_kernel()
    check_tables("factored_tp1", kern, cls_rows, path_rows)
    n_w = int((cls_rows[:, 0] * cls_rows[:, 2]).sum())
    if t_all.numel() != H * n_w or b_all.numel() != n_w:
        raise ValueError("factored_tp1: weights do not match the class table")
    if int((path_rows[:, 5] + path_rows[:, 6]).max()) > J or int(path_rows[:, 6].max()) > cg.shape[0]:
        raise ValueError("factored_tp1: a path's harmonic slice lies outside edge_sh or the CG matrix")
    cls_rows = np.ascontiguousarray(cls_rows, np.int32)
    path_rows = np.ascontiguousarray(path_rows, np.int32)
    n_scratch = checked_plan("factored_tp1", kern.plan, cls_rows, path_rows, H + 1, J, N, out_dim,
                             (XP, J, H, cg.shape[0], cg.shape[1], out_dim))
    out = torch.empty(N, out_dim, device=xp.device, dtype=torch.float32)
    scratch = torch.empty(max(n_scratch, 1), device=xp.device, dtype=torch.float32)
    err = kern.forward(
        xp.data_ptr(), sh.data_ptr(), h.data_ptr(), mw.data_ptr(), cg.data_ptr(),
        t_all.data_ptr(), b_all.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        cls_rows.ctypes.data, cls_rows.shape[0], path_rows.ctypes.data, path_rows.shape[0],
        N, K, XP, J, H, cg.shape[0], cg.shape[1], out_dim,
        torch.cuda.current_stream(xp.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"factored_tp1 kernel launch failed: cudaError {err}")
    counts.add("factored_tp1")
    return out


def factored_tp1(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias):
    """Summed TP messages (N, dim_out) f32 through the gen-1 Hopper kernel
    in the mode of ``x_nbr``'s dtype (forward only); on CPU tensors through
    :func:`~diffdock_tpu_torch.ops.factored_tp2.factored_tp_reference`
    (bfloat16: ``factored_tp_bf16_reference(..., gen=1)``)."""
    check_no_empty_class(tp, "factored_tp1")
    if not x_nbr.is_cuda:
        if x_nbr.dtype == torch.bfloat16:
            return factored_tp_bf16_reference(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias, gen=1)
        return factored_tp_reference(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias)
    return launch(*prepare(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias), tp.irreps_out.dim)
